"""The plain reference: the CRDT join of the generated inputs, in numpy.

It imports nothing of the program (a test holds that).  `join.py` joins
R replica snapshots; `replay.py` replays peers' replication frames;
`compare.py` holds a keyspace read back from the program against the
reference's and counts mismatches per family.

The state both sides are compared in ("state form", a dict of arrays):

* keys: `key` (bytes, numpy "S"), `enc`, `ct`, `mt`, `dt`, `expire`,
  `reg_has` (a register value is held), `reg_val`, `reg_t`, `reg_node`,
  `cnt_sum`;
* counter slots: `c_key` (index into the keys), `c_node`, `c_val`,
  `c_uuid`, `c_base`, `c_base_t`;
* element rows: `e_key`, `e_member`, `e_add_t`, `e_add_node`, `e_del_t`,
  `e_has`, `e_val`.  The reference's side may carry `e_del_hi` where a
  row's delete time is a range [e_del_t, e_del_hi] (see replay.py).
"""
