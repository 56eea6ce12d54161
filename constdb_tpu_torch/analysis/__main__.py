"""CLI: `python -m constdb_tpu_torch.analysis [options] [paths...]`

Modes:
  (default)          print every finding; exit 1 if any.
  --baseline         compare against analysis/baseline.json; exit 1 only
                     on GROWTH (new keys, or counts above the recorded
                     ones).  This is the gate the tests run.
  --write-baseline   regenerate baseline.json from the current findings,
                     preserving existing per-key notes.
  --list-rules       print each rule's name + one-line purpose.
  --json             machine-readable output on stdout instead of the
                     human rendering (composes with --baseline).  The
                     payload's `counts` map uses the same
                     rule:path:qualname:token keys as baseline.json, so
                     CI can artifact a run and diff it against another
                     or against the committed baseline directly.

Default scan: the constdb_tpu_torch package (plus the project-level README ↔
ENV_REGISTRY check).  Explicit paths skip the project-level check and
anchor relpaths at --root (default: cwd).
"""

from __future__ import annotations

import argparse
import os
import sys

from . import (analyze_paths, check_readme_registry, compare_to_baseline,
               default_baseline_path, load_baseline, run_default_analysis)
from .core import baseline_payload
from .rules import ALL_RULES


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m constdb_tpu_torch.analysis",
        description="invariant lint of the PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to scan (default: the package)")
    ap.add_argument("--root", default=None,
                    help="relpath anchor for explicit paths (default: cwd)")
    ap.add_argument("--baseline", action="store_true",
                    help="fail only on growth over analysis/baseline.json")
    ap.add_argument("--baseline-path", default=None)
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate baseline.json (keeps existing notes)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout (stable "
                         "keys matching baseline.json)")
    ns = ap.parse_args(argv)

    if ns.list_rules:
        for rule in ALL_RULES:
            first = (rule.doc or rule.__doc__ or "").strip().splitlines()[0]
            print(f"{rule.name:<20} {first}")
        return 0

    if ns.paths:
        findings = analyze_paths(ns.paths, root=ns.root or os.getcwd())
    else:
        findings = run_default_analysis() + check_readme_registry()

    bpath = ns.baseline_path or default_baseline_path()
    if ns.write_baseline:
        import json
        notes = load_baseline(bpath).get("notes", {})
        payload = baseline_payload(findings, notes)
        with open(bpath, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {bpath}: {len(payload['findings'])} keys "
              f"({len(findings)} findings)")
        return 0

    if ns.as_json:
        import json
        payload = {
            "version": 1,
            "counts": baseline_payload(findings, {})["findings"],
            "findings": [{
                "key": f.key, "rule": f.rule, "severity": f.severity,
                "path": f.path, "line": f.line, "qualname": f.qualname,
                "token": f.token, "message": f.message, "hint": f.hint,
            } for f in findings],
        }
        if ns.baseline:
            growth, stale = compare_to_baseline(findings,
                                                load_baseline(bpath))
            payload["baseline"] = {"growth": sorted(f.key for f in growth),
                                   "stale": stale}
            print(json.dumps(payload, indent=1, sort_keys=True))
            return 1 if growth else 0
        print(json.dumps(payload, indent=1, sort_keys=True))
        return 1 if findings else 0

    if ns.baseline:
        growth, stale = compare_to_baseline(findings, load_baseline(bpath))
        for f in growth:
            print(f.render())
        for key in stale:
            print(f"note: baselined finding no longer present "
                  f"(prune with --write-baseline): {key}")
        if growth:
            print(f"\n{len(growth)} NEW finding(s) over the baseline "
                  f"({len(findings)} total, "
                  f"{len(findings) - len(growth)} baselined)")
            return 1
        print(f"clean: {len(findings)} finding(s), all baselined "
              f"({len(stale)} stale baseline key(s))")
        return 0

    for f in findings:
        print(f.render())
    if findings:
        print(f"\n{len(findings)} finding(s)")
        return 1
    print("clean: no findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
