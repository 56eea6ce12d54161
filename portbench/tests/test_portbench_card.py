"""On the card: the real command, one short run of each cell, its last
line correct.  Run on a machine with the card:
`python -m pytest portbench/tests -q -m card`."""

import json
import subprocess
import sys

import pytest

from portbench.tests.helpers import REPO, cells


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("workload", cells())
def test_command_on_the_card(card, workload):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        workload, "--seed", str(2 ** 31 + 3), "--seconds",
                        "3", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
