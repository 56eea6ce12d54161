"""The harness on the CPU at small sizes: every cell's run is correct and
its line has the contract's keys; configurations, traffic mixes and
metrics are found by name; the check fails a run whose timed path is
broken; and without a card the command exits without a result."""

import json
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.helpers import REPO, cells, run_cpu, small_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("portbench"))


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "traced"])
def test_cell_runs_correct_with_the_contracts_keys(root, workload, trace):
    out = run_cpu(root, workload, seed=2 ** 31 + 17, trace=trace)
    assert list(out) == KEYS, list(out)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in out["check"].values())
    # a CPU rehearsal names the CPU and reports no device metric
    assert out["device"]["platform"] == "cpu"
    spec = harness.load_spec(root, workload)
    listed = spec.per_layer if trace else spec.end_to_end
    device_metrics = {m["name"] for m in listed
                      if m["source"] == "device_trace"}
    assert not device_metrics & set(out["metrics"])
    host = {m["name"] for m in listed if m["source"] != "device_trace"}
    assert set(out["metrics"]) == host
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    json.dumps(out)


def test_new_files_are_found_by_name_with_no_edit(root, tmp_path):
    r = tmp_path / "b"
    shutil.copytree(root, r)
    bench = json.loads((r / "BENCHMARK.json").read_text())
    cfg = json.loads((r / "portbench/configs/mixed-r8.json").read_text())
    cfg.update(name="mixed-tiny", n_keys=900, chunk_keys=300)
    (r / "portbench/configs/mixed-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((r / "portbench/traffic/catchup.json").read_text())
    traffic["group"] = 4
    (r / "portbench/traffic/catchup-g4.json").write_text(json.dumps(traffic))
    (r / "portbench/metrics/catchups_in_window.py").write_text(
        "def read(run):\n    return run.window['catchups']\n")
    bench["configs"].append({"name": "mixed-tiny", "source": "test",
                             "file": "portbench/configs/mixed-tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "mixed-tiny.g4", "config": "mixed-tiny",
                               "traffic": "catchup-g4", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "catchups_in_window", "unit": "n",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["mixed-tiny.g4"]})
    (r / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cpu(r, "mixed-tiny.g4")
    assert out["correct"]
    assert out["metrics"]["catchups_in_window"]["value"] == \
        out["attempted"] > 0


def _broken_catchup_state(monkeypatch):
    from constdb_tpu_torch.server.node import Node
    monkeypatch.setattr(Node, "merge_batches", lambda self, b, **kw: None)


def _broken_catchup_half(monkeypatch):
    from constdb_tpu_torch.server.node import Node
    real = Node.merge_batches
    monkeypatch.setattr(Node, "merge_batches",
                        lambda self, b, **kw: real(self, b[:len(b) // 2],
                                                   **kw))


def _broken_stream_state(monkeypatch):
    from constdb_tpu_torch.server.node import Node
    monkeypatch.setattr(Node, "merge_stream_batch",
                        lambda self, bb, frames: None)


def _broken_stream_half(monkeypatch):
    from constdb_tpu_torch.replica.coalesce import CoalescingApplier
    real = CoalescingApplier.flush

    def half(self):
        self._buf = {k: v[:len(v) // 2] for k, v in self._buf.items()}
        return real(self)
    monkeypatch.setattr(CoalescingApplier, "flush", half)


def _altered_answer(monkeypatch):
    """One counter sum altered where the flush produces it."""
    from constdb_tpu_torch.engine.cuda import TorchMergeEngine
    real = TorchMergeEngine.flush

    def flush(self, store):
        real(self, store)
        if store.keys.n:
            store.keys.cnt_sum[0] += 1
    monkeypatch.setattr(TorchMergeEngine, "flush", flush)


# the faults a one-card cell can have (it has no exchange between chips)
FAULTS = {"mixed-r8.catchup": [_broken_catchup_state, _broken_catchup_half,
                               _altered_answer],
          "hash-r8.catchup": [_broken_catchup_state, _broken_catchup_half,
                              _altered_answer],
          "mixed-r8.stream": [_broken_stream_state, _broken_stream_half,
                              _altered_answer]}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in cells() for f in FAULTS[w]],
    ids=lambda x: getattr(x, "__name__", x))
def test_check_fails_a_broken_timed_path(root, workload, fault, monkeypatch):
    fault(monkeypatch)
    out = run_cpu(root, workload, seed=23, seconds=0.05)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] > 0
    assert sum(c["value"] for c in out["check"].values()) > 0


def test_command_exits_without_a_result_when_there_is_no_card():
    """The real command: no card here, so exit 2 and nothing on stdout
    (skipped where a card is present: the card test runs it there)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "mixed-r8.catchup", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "constdb_tpu_torchx", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax"]
