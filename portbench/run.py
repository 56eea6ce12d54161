"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for.  Prints the check's numbers beside their limits on standard
error, and as the last line of standard output one JSON object: correct,
attempted, failed, metrics, device (and, traced, breakdown), check.
Exits 2 without a result when no usable CUDA card is there, and 1 when
the run fails or loads JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program or its libraries stays in the checkout,
    # at fixed paths: a second run finds what the first one built
    cache = ROOT / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch
    from portbench import harness

    spec = harness.load_spec(ROOT, args.workload)
    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[portbench] needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), torch.device("cuda", 0))
    found = harness.forbidden_modules()
    if found:
        print(f"[portbench] the run loaded {', '.join(found)}: the port "
              "must not load JAX or the JAX package", file=sys.stderr)
        return 1
    for name, c in out["check"].items():
        print(f"[portbench] check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # the script's own directory must not shadow top-level modules
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != Path(__file__).parent]
    sys.exit(main())
