"""CLI: run chaos certification scenarios.

  python -m constdb_tpu_torch.chaos                  # smoke cells, seed 7
  python -m constdb_tpu_torch.chaos --all            # full capability matrix
  python -m constdb_tpu_torch.chaos --seed 42 \
      --cells wire1-delta1-comp1-shards1-cpu
  python -m constdb_tpu_torch.chaos --soak --seed 99 # randomized soak
  python -m constdb_tpu_torch.chaos --device cpu     # card cells on the CPU

Every line prints the replay seed; a failing cell's AssertionError
carries `[chaos seed=N cell=…]` — rerun with that seed to replay the
exact schedule.  The card cells ("torch", "torch-resident") run on
`--device` (default cuda: without a card they raise, they never move to
the CPU).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m constdb_tpu_torch.chaos",
        description="convergence-under-chaos certification harness")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cells", default="",
                    help="comma-separated cell names (see --list)")
    ap.add_argument("--all", action="store_true",
                    help="run the full capability matrix")
    ap.add_argument("--soak", action="store_true",
                    help="randomized soak on the default cell")
    ap.add_argument("--resource", action="store_true",
                    help="resource-fault cells: memory-capped firehose, "
                         "stalled client, stalled peer (chaos/resource.py)")
    ap.add_argument("--ops", type=int, default=30,
                    help="ops per scripted burst")
    ap.add_argument("--list", action="store_true",
                    help="list matrix cell names and exit")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the card engines' nodes")
    ns = ap.parse_args(argv)

    from .scenario import (certify_scenario, matrix_cells, run_scenario,
                           smoke_cells, soak_scenario)

    if ns.list:
        for c in matrix_cells(ns.device):
            print(c.name)
        return 0

    if ns.resource:
        from .resource import run_resource_scenario
        print(f"chaos resource cells: seed={ns.seed}")
        t0 = time.monotonic()
        stats = run_resource_scenario(ns.seed)
        print(f"chaos resource cells PASSED in "
              f"{time.monotonic() - t0:.1f}s: {stats}")
        return 0

    if ns.soak:
        sc = soak_scenario(ns.seed)
        print(f"chaos soak: seed={ns.seed} steps={len(sc.steps)}")
        t0 = time.monotonic()
        stats = run_scenario(sc)
        print(f"chaos soak PASSED in {time.monotonic() - t0:.1f}s: "
              f"{stats}")
        return 0

    if ns.all:
        cells = matrix_cells(ns.device)
    elif ns.cells:
        by_name = {c.name: c for c in matrix_cells(ns.device)}
        try:
            cells = [by_name[n] for n in ns.cells.split(",")]
        except KeyError as e:
            print(f"unknown cell {e.args[0]!r}; --list shows the matrix",
                  file=sys.stderr)
            return 2
    else:
        cells = smoke_cells(ns.device)

    failed = 0
    for cell in cells:
        sc = certify_scenario(ns.seed, cell, ops=ns.ops)
        t0 = time.monotonic()
        try:
            stats = run_scenario(sc)
        except AssertionError as e:
            failed += 1
            print(f"FAIL {cell.name} seed={ns.seed}: {e}")
            continue
        print(f"PASS {cell.name} seed={ns.seed} "
              f"({time.monotonic() - t0:.1f}s): "
              f"ops={stats.get('journal_ops')} "
              f"reconnects={stats.get('reconnects')} "
              f"plane={stats.get('plane')}")
    if failed:
        print(f"{failed}/{len(cells)} cells FAILED (replay: --seed "
              f"{ns.seed} --cells <name>)", file=sys.stderr)
        return 1
    print(f"chaos certification: {len(cells)}/{len(cells)} cells green")
    return 0


if __name__ == "__main__":
    sys.exit(main())
