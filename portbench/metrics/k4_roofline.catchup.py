"""k4_roofline.catchup: K4 (segment_sum, the counter sums) as a share of
its roofline: the least time of every launch in the traced window
(roofline.k4 and roofline.least_s, from the shapes the harness recorded:
the bytes that cannot sit in the L2, over HBM's rate) over the kernel's
device seconds."""

from portbench import roofline
from portbench.metrics._roofline import share


def read(run):
    launches = run.shapes["segment_sum"]
    if not launches:
        return None
    return share(run, "k4", [roofline.least_s(*roofline.k4(n, n_seg, base))
                             for n, n_seg, base in launches])
