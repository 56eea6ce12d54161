"""The port's invariant lint (core.py: the framework, rules.py: the
rules, cfg.py and flow.py: the control-flow and dataflow facts some
rules read), run over the port's own sources.  CLI: `python -m
constdb_tpu_torch.analysis [--baseline] [paths...]`."""

from .core import (Finding, Rule, analyze_paths, compare_to_baseline,
                   default_baseline_path, load_baseline)
from .rules import ALL_RULES

__all__ = ["Finding", "Rule", "ALL_RULES", "analyze_paths",
           "compare_to_baseline", "default_baseline_path", "load_baseline",
           "run_default_analysis", "check_readme_registry"]


def _package_root() -> tuple[list[str], str]:
    """(default scan paths, scan root): the constdb_tpu_torch package
    dir, relpaths anchored at its parent (so findings read
    `constdb_tpu_torch/replica/link.py`)."""
    import os
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [pkg], os.path.dirname(pkg)


def run_default_analysis() -> list[Finding]:
    """Every rule over the live package tree."""
    paths, root = _package_root()
    return analyze_paths(paths, root=root)


def check_readme_registry(readme_path: str | None = None) -> list[Finding]:
    """Project-level half of ENV-REGISTRY: every conf.ENV_REGISTRY name
    must appear in the README Tuning table (the registry is the source
    of truth; the table is the operator's view of it).  The registry is
    the port's own, constdb_tpu_torch/conf.py."""
    import os

    from .. import conf
    if readme_path is None:
        _, root = _package_root()
        readme_path = os.path.join(root, "README.md")
    if not os.path.exists(readme_path):
        return []
    with open(readme_path, "r", encoding="utf-8") as f:
        text = f.read()
    out = []
    for name in sorted(conf.ENV_REGISTRY):
        if name not in text:
            out.append(Finding(
                "ENV-REGISTRY", "error", os.path.basename(readme_path), 1,
                "", f"{name}:undocumented",
                f"{name} is declared in conf.ENV_REGISTRY but missing "
                "from the README Tuning table",
                "add a row to the README Tuning table"))
    return out
