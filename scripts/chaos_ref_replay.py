#!/usr/bin/env python3
"""Replay a chaos cell's journal, written by the port on the card, through
the reference's oracle on the CPU.

    python3 scripts/chaos_ref_replay.py JOURNAL.jsonl

JOURNAL.jsonl is what `python3 chip_smoke.py --chaos-journal PATH` (phase
15) writes for its first torch-resident cell: a header line naming the
cell, the hash of the canonical export the port's oracle certified on
the card (chip_smoke.canon_hash) and its key count, then one line per
journaled op (origin, uuid, name, args as one RESP array, hex).  The
script rebuilds the reference's OpJournal (constdb_tpu/chaos/oracle.py)
from those ops, replays it to reference_canonical(collected=True) on the
reference's CPU engine, and compares its hash with the card's; it also
replays the same ops through the port's OpJournal and compares the two
canonicals key by key.  Prints one JSON line; exits 1 on a mismatch.
Runs on the CPU only (JAX_PLATFORMS=cpu), never on the card."""

import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("JAX_ENABLE_X64", "true")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load(path: str) -> tuple:
    with open(path) as f:
        lines = [json.loads(x) for x in f if x.strip()]
    return lines[0], lines[1:]


def journal(oracle, codec, rows: list):
    j = oracle.OpJournal()
    for r in rows:
        parser = codec.RespParser()
        parser.feed(bytes.fromhex(r["args"]))
        args = parser.next_msg()
        j.ops[(r["origin"], r["uuid"])] = (bytes.fromhex(r["name"]),
                                           list(args.items))
    return j


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    head, rows = load(sys.argv[1])
    from chip_smoke import canon_hash
    from constdb_tpu.chaos import oracle as ref_oracle
    from constdb_tpu.resp import codec as ref_codec
    from constdb_tpu_torch.chaos import oracle as port_oracle
    from constdb_tpu_torch.resp import codec as port_codec

    ref = journal(ref_oracle, ref_codec, rows).reference_canonical(True)
    port = journal(port_oracle, port_codec, rows).reference_canonical(True)
    diff = sorted(k for k in set(ref) | set(port) if ref.get(k) != port.get(k))
    out = {"cell": head["cell"], "ops": len(rows),
           "card_canon_hash": head["canon_hash"],
           "reference_canon_hash": canon_hash(ref),
           "port_cpu_canon_hash": canon_hash(port),
           "canonical_keys": len(ref), "keys_differing": len(diff)}
    out["ok"] = (len(rows) == head["ops"] and not diff and
                 out["reference_canon_hash"] == head["canon_hash"] and
                 len(ref) == head["canonical_keys"])
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
