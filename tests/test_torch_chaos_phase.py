"""chip_smoke.py's phase 15 (the port's chaos card cells) rehearsed on the
CPU, and scripts/chaos_ref_replay.py on the journal it writes.

On the CPU the phase runs the same 8 cells of the port's matrix with
device="cpu" and every check but the launch checks (no kernel launches
off the card): the engines each cell built, the certified canonical, one
line a cell.  The replay script then rebuilds the reference's OpJournal
from the journal file and must reach the certified canonical's hash; a
file whose recorded hash is wrong must fail it."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    path = tmp_path_factory.mktemp("chaos") / "journal.jsonl"
    res = chip_smoke.chaos_phase(torch.device("cpu"), str(path))
    return res, path


def replay(path: Path) -> tuple:
    out = subprocess.run([sys.executable, "scripts/chaos_ref_replay.py",
                          str(path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    return out.returncode, json.loads(out.stdout.strip().splitlines()[-1])


def test_phase_certifies_the_eight_card_cells_on_the_cpu(phase):
    res, path = phase
    cells = res["cells"]
    assert [c["cell"] for c in cells] == [
        f"wire{w}-delta{d}-comp1-shards1-{e}"
        for e in ("torch", "torch-resident") for w in (1, 0)
        for d in (1, 0)]
    for c in cells:
        assert c["journal_ops"] > 100 and c["canonical_keys"] > 10
        assert c["plane"]["partitions"] == 3
        assert c["plane"]["truncations"] == 1
        assert (c["wire_demotions"] >= 1) == c["cell"].startswith("wire1")
        assert (c["dev_rounds"] > 0) == c["cell"].endswith("resident")
    assert sum("journal" in c for c in cells) == 1
    assert cells[4].get("journal") == str(path)


def test_reference_replays_the_phase_journal(phase, tmp_path):
    _, path = phase
    rc, out = replay(path)
    assert rc == 0 and out["ok"], out
    head = json.loads(path.read_text().splitlines()[0])
    assert out["reference_canon_hash"] == head["canon_hash"] == \
        out["port_cpu_canon_hash"]
    assert out["ops"] == head["ops"] > 100
    lines = path.read_text().splitlines()
    head["canon_hash"] = "0" * 64
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join([json.dumps(head)] + lines[1:]) + "\n")
    rc, out = replay(bad)
    assert rc == 1 and not out["ok"]
