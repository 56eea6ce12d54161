"""k3_roofline.stream: K3 (scatter_round, one launch per steady round) as
a share of its roofline: the least time of every round in the window
(roofline.k3, from the segments the harness recorded) over the kernel's
device seconds."""

from portbench import roofline
from portbench.metrics._roofline import share


def read(run):
    rounds = run.shapes["scatter_round"]
    if not rounds:
        return None
    return share(run, "k3", [roofline.least_s(*roofline.k3(segs))
                             for segs in rounds])
