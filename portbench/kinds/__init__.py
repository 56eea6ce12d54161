"""Traffic kinds: the code that a traffic file's `kind` names.

A kind is a class `Kind(ctx)` with `setup()`, `window(seconds) -> dict`
(what the window did, for the metric readers), `node_state()` (the node
to read back after the window), `release()` (drop the program's state)
and `reference()` (the reference's state form of the expected keyspace).
"""
