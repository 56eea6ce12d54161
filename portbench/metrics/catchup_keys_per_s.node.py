"""catchup_keys_per_s.node: the node's catch-up rate, keys of every
catch-up begun in the window over the seconds from the first one's start
to the last one's synchronize.  A per-layer reading: the catch-up is one
host thread's pace, and its runs drift with the host by more than any
end-to-end bound may hold."""


def read(run):
    w = run.window
    return w["keys"] / w["wall_s"] if w.get("catchups") else None
