"""The check's control: the reference with one stated guarantee broken,
put in the program's place, held to the same comparison.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--frames-per-peer N]

prints, per seed, the number the check compares (every mismatching key,
slot and row) with its limit, and the count per family.  The
benchmark's own runs never run this; it shows that the check fails a
result that breaks the configuration's guarantee, at the cell's own size.

* Catch-up cells: "every key is the CRDT join of all R replicas" is
  broken the way a whole-object last-writer-wins merge breaks it: each
  key takes the whole state of the replica with its latest modify time
  (envelope, register, that replica's counter slots, its members).
* Stream cells: "every operation merges by its timestamps" is broken the
  way an apply-in-arrival-order fast path breaks it: a register, a
  counter slot and a member's add side take the last frame to arrive
  (the feed's round-robin order), not the largest (uuid, origin).  The
  frames compared are the first `--frames-per-peer` of each peer, as
  many as a run feeds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).parent]
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import gen  # noqa: E402
from portbench.reference import compare, join, replay  # noqa: E402

I64 = np.int64


def key_lww_state(snap: dict) -> dict:
    """Each key's whole state from the replica with its latest mt."""
    R, n = snap["mt"].shape
    w = np.zeros(n, I64)
    for r in range(1, R):
        w = np.where(snap["mt"][r] >= join._pick(snap["mt"], w), r, w)
    one = {c: join._pick(snap[c], w) for c in
           ("ct", "mt", "dt", "reg_t", "reg_node", "reg_val")}
    reg_has, reg_val = join._values(snap["reg_pool"], one["reg_val"])
    st = {"key": np.array(snap["keys"], dtype=np.bytes_),
          "enc": snap["enc"].astype(I64), "ct": one["ct"], "mt": one["mt"],
          "dt": one["dt"], "expire": np.zeros(n, I64), "reg_has": reg_has,
          "reg_val": reg_val, "reg_t": one["reg_t"],
          "reg_node": one["reg_node"]}
    # counter rows and members of the winning replica only
    keep = snap["cnt_node"] == (w[snap["cnt_ki"]] + 1)
    cols = [snap[c][keep] for c in ("cnt_ki", "cnt_node", "cnt_val",
                                    "cnt_uuid", "cnt_base", "cnt_base_t")]
    slots, st["cnt_sum"] = join.counter_slots(*cols, n)
    st.update(slots)
    ew = w[snap["el_ki"]]
    e_has, e_val = join._values(snap["el_pool"], join._pick(snap["el_val"],
                                                            ew))
    st.update(e_key=snap["el_ki"],
              e_member=np.array(snap["member_pool"],
                                dtype=np.bytes_)[snap["el_member"]],
              e_add_t=join._pick(snap["el_add_t"], ew),
              e_add_node=join._pick(snap["el_add_node"], ew),
              e_del_t=join._pick(snap["el_del_t"], ew), e_has=e_has,
              e_val=e_val)
    return st


def arrival_order(peers: list, slice_bytes: int) -> list:
    """The control's last-writer-wins order: the order the feed delivers
    the frames in (slice s of every peer in turn, a frame arriving with
    the slice that completes it).  peers = [(origin, ops, frame end
    offsets)] -> [(origin, ops with `order`)]."""
    out = []
    n_peers = len(peers)
    for p, (origin, ops, end) in enumerate(peers):
        s = (end[:len(ops["cls"])] - 1) // slice_bytes
        order = (s * n_peers + p) * (1 << 32) + np.arange(len(s))
        out.append((origin, dict(ops, order=order)))
    return out


def readings(root: Path, workload: str, seed: int,
             frames_per_peer: int = 0) -> dict:
    from portbench.harness import load_spec
    spec = load_spec(root, workload)
    snap = gen.snapshots(spec.config, seed)
    kind = spec.traffic["kind"]
    if kind == "catchup":
        return compare.compare(key_lww_state(snap), join.snapshot_join(snap))
    if kind != "stream":
        raise SystemExit(f"no control for traffic kind {kind!r}")
    mix = spec.traffic
    peers = []
    for p in range(int(mix["peers"])):
        origin = int(mix["first_origin"]) + p
        ops = gen.peer_ops(mix, frames_per_peer, [seed, p])
        _data, end = gen.encode_frames(ops, mix, origin)
        peers.append((origin, ops, end))
    base = join.snapshot_join(snap)
    want = compare.concat(base, replay.stream_replay(
        [(o, ops) for o, ops, _end in peers], mix))
    got = compare.concat(base, replay.stream_replay(
        arrival_order(peers, int(mix["slice_bytes"])), mix))
    return compare.compare(got, want)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames-per-peer", type=int, default=0)
    args = ap.parse_args()
    root = Path(__file__).resolve().parent.parent
    for seed in args.seeds:
        r = readings(root, args.workload, seed, args.frames_per_peer)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": {"mismatches": {
                              "value": sum(r.values()), "limit": 0}},
                          "by_family": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
