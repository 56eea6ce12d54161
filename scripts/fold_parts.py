"""Time the parts of one tree's device-fold catch-up on the card.

    python3 scripts/fold_parts.py TREE LABEL [--keys N] [--replicas R]

TREE is a checkout of this repository (a `git archive` of a commit will
do).  The script imports TREE's `chip_smoke.py` and `constdb_tpu_torch`,
runs `chip_smoke.catchup` once with dense_fold="cuda" (the device-fold
catch-up of chip_smoke.py's phase 5, verified there against the CPU
oracle), and prints one line `PARTS LABEL {json}` with:

  * keys_per_s, wall_s, the engine's family_secs (dispatch, including the
    wait for the family's stage) and stage_secs (the staging threads),
    and the collector's seconds (gc_s);
  * parts: {engine method: [seconds, calls]} for the transfer helpers,
    the family dispatches and the flush (a method the tree lacks is
    left out);
  * pinned: [seconds, calls] of the pinned host allocations made through
    torch.empty(pin_memory=True) and of Tensor.pin_memory (allocation
    and copy), and torch.cuda.host_memory_stats() at the end;
  * the byte sizes of the engine's pinned staging slots at the end.

Trees are compared by running each in turn in one call, e.g. P C C P.
"""
import argparse
import json
import os
import sys
import time

PARTS = ("_dispatch_envelopes", "_dispatch_registers",
         "_dispatch_counter_rows", "_dispatch_elem_rows", "_resident_state",
         "_fold_apply", "_fold_pair", "_h2d", "_h2d_packed", "_get",
         "_get_pinned", "_start_get", "flush", "_apply_whole",
         "_recompute_sums", "_join_staging")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("label")
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    if not torch.cuda.is_available():
        print("fold_parts: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as CS
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine as E
    from constdb_tpu_torch.ops import kernels as KN

    acc: dict = {}

    def timed(key, real):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real(*a, **kw)
            finally:
                s = acc.setdefault(key, [0.0, 0])
                s[0] += time.perf_counter() - t0
                s[1] += 1
        return wrapper

    for name in PARTS:
        real = getattr(E, name, None)
        if real is not None:
            setattr(E, name, timed(name, real))
    real_empty = torch.empty
    pinned_empty = timed("torch.empty(pin_memory=True)", real_empty)
    torch.empty = lambda *a, **kw: (pinned_empty if kw.get("pin_memory")
                                    else real_empty)(*a, **kw)
    torch.Tensor.pin_memory = timed("Tensor.pin_memory",
                                    torch.Tensor.pin_memory)

    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    KN.build()
    out, eng, _store, _b = CS.catchup(dev, args.keys, args.replicas,
                                      args.seed, args.replicas, "cuda", True,
                                      "fold " + args.label)
    slots = [s["buf"].numel() if s["buf"] is not None else 0
             for s in getattr(eng, "_ring", [])]
    fold_slot = getattr(eng, "_fold_slot", None)
    stage = {k: round(v, 4) for k, v in getattr(eng, "stage_secs",
                                                 {}).items()}
    eng.close()
    pin_keys = ("torch.empty(pin_memory=True)", "Tensor.pin_memory")
    print("PARTS", args.label, json.dumps({
        "keys_per_s": out["keys_per_s"], "wall_s": out["wall_s"],
        "family_secs": out["family_secs"], "stage_secs": stage,
        "gc_s": out["gc_s"],
        "parts": {k: [round(v[0], 4), v[1]] for k, v in acc.items()
                  if k not in pin_keys},
        "pinned": {k: [round(acc[k][0], 4), acc[k][1]]
                   for k in pin_keys if k in acc},
        "host_memory_stats": torch.cuda.host_memory_stats()
        if hasattr(torch.cuda, "host_memory_stats") else None,
        "ring_slot_bytes": slots,
        "fold_slot_bytes": fold_slot["buf"].numel()
        if fold_slot and fold_slot["buf"] is not None else None},
        default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
