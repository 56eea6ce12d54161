"""The port's invariant lint (constdb_tpu_torch/analysis), twin of
tests/test_analysis.py: the port's corpus fires every rule, the escape
hatch and baseline machinery work, the LIVE port tree is clean against
its committed (empty) baseline, and, on the reference's own corpus, the
ten rules whose logic the port kept give the reference's finding keys."""

import json
import os

import pytest

from constdb_tpu.analysis import analyze_paths as ref_analyze_paths
from constdb_tpu_torch import conf
from constdb_tpu_torch.analysis import (ALL_RULES, analyze_paths,
                                        check_readme_registry,
                                        compare_to_baseline, load_baseline,
                                        run_default_analysis)
from constdb_tpu_torch.analysis.__main__ import main as lint_main
from constdb_tpu_torch.analysis.core import baseline_payload
from constdb_tpu_torch.analysis.rules import EnvRegistryRule, StagePureRule

HERE = os.path.dirname(os.path.abspath(__file__))
CORPUS = os.path.join(HERE, "torch_analysis_corpus")
REF_CORPUS = os.path.join(HERE, "analysis_corpus")

# the three rules the port redesigned (their corpus findings differ from
# the reference's by construction); every other rule keeps its logic
REDESIGNED = {"STAGE-PURE", "ENV-REGISTRY", "NATIVE-CONTRACT"}
KEPT = sorted(r.name for r in ALL_RULES if r.name not in REDESIGNED)


@pytest.fixture(scope="module")
def corpus_findings():
    return analyze_paths([CORPUS], root=CORPUS)


def _by_rule(findings):
    out = {}
    for f in findings:
        out.setdefault(f.rule, []).append(f)
    return out


# ------------------------------------------------------------- the corpus

def test_every_rule_has_corpus(corpus_findings):
    """A rule without a seeded violation is a rule nobody knows works."""
    fired = {f.rule for f in corpus_findings}
    assert len(ALL_RULES) == 13
    for rule in ALL_RULES:
        assert rule.name in fired, \
            f"{rule.name} has no firing snippet under " \
            "tests/torch_analysis_corpus"


def test_corpus_expectations(corpus_findings):
    by = _by_rule(corpus_findings)
    ab = by["ASYNC-BLOCK"]
    assert len(ab) == 5
    assert {f.token for f in ab} == \
        {"time.sleep", "socket.socket", "open", ".result()"}
    assert any("nested" in f.qualname for f in ab)
    # STAGE-PURE in the port's terms: an upload and a resident-state
    # touch, torch and the kernel module in stages, two heavy calls in
    # dispatch; _stacked in _stage_counter_rows and _h2d in a dispatch
    # stay silent
    sp = by["STAGE-PURE"]
    assert {f.token for f in sp} == \
        {"self._h2d", "self._resident_state", "torch", "KN", "np.stack",
         "self._combine_groups"}
    assert not any(f.qualname.endswith(("_stage_counter_rows",
                                        "_dispatch_clean")) for f in sp)
    cm = by["CHECK-THEN-MUTATE"]
    assert sorted(f.token for f in cm) == ["assert", "raise"]
    assert all("fixed" not in f.qualname for f in cm)
    # ENV-REGISTRY against the port's registry: the reference's own knob
    # is unregistered here, the port's twin is clean
    er = by["ENV-REGISTRY"]
    assert {f.token for f in er} == \
        {"CONSTDB_TORCH_SECRET_KNOB", "CONSTDB_TORCH_OTHER_KNOB",
         "CONSTDB_TORCH_NOT_IN_REGISTRY:unregistered",
         "CONSTDB_POOL_FLUSH_MB:unregistered"}
    sh = by["SHM-LIFECYCLE"]
    assert [f.qualname.rsplit(".", 1)[-1] for f in sh] == ["leaky"]
    be = by["BARE-EXCEPT-SWALLOW"]
    assert [f.qualname for f in be] == ["apply_frames"]
    fc = by["FORK-CAPTURE"]
    assert all(f.qualname.endswith("spawn_bad") for f in fc)
    assert {f.token for f in fc} == \
        {"lambda", "closure_worker", "self.run_shard", "self.engine",
         "engine"}
    kc = by["KEY-CONFINED"]
    assert {f.token for f in kc} == {"badswap", "nokey"}
    assert not any("good" in f.qualname for f in kc)
    # NATIVE-CONTRACT against the port's own marker tables: tensor.set is
    # python-only there, so it stays silent
    nc = by["NATIVE-CONTRACT"]
    assert {f.token for f in nc} == \
        {"zadd", "smembers:unroutable", "aof:frame:drift",
         "aof:chunk:missing-from-table", "aof:wmark:unknown-record-type"}
    assert [f.qualname for f in nc if f.token == "zadd"] == ["_plan_zadd"]
    assert [f.qualname for f in nc if f.token.endswith(":unroutable")] \
        == ["smembers_command"]
    aa = by["AWAIT-ATOMICITY"]
    assert {f.token for f in aa} == {"links", "pend"}
    assert {f.qualname.rsplit(".", 1)[-1] for f in aa} == \
        {"close_bad", "quiesce_bad"}
    se = by["SLOT-EPOCH"]
    assert {f.token for f in se} == {"epoch"}
    assert [f.qualname for f in se] == ["flip_bad"]
    assert not any(f.path.startswith("cluster") for f in aa)
    co = by["CUT-ORDERING"]
    assert {f.token for f in co} == {"_local_digest", "key_count"}
    assert {f.qualname.rsplit(".", 1)[-1] for f in co} == \
        {"send_delta_bad", "export_branchy_bad"}
    ld = by["LOCK-DISCIPLINE"]
    assert {f.token for f in ld} == \
        {"self._crc_lock", "self._stream_lock:open",
         "self._stream_lock:.result()"}
    assert not any("fixed" in f.qualname for f in ld)


def test_findings_have_location_and_hint(corpus_findings):
    for f in corpus_findings:
        assert f.path and f.line > 0 and f.message
        assert f.hint, f"{f.rule} ships without a fix hint"
        assert f.key.startswith(f"{f.rule}:{f.path}:")
        assert f"{f.path}:{f.line}" in f.render()


def test_ignore_escape_hatch(tmp_path):
    bad = tmp_path / "parallel" / "x.py"
    bad.parent.mkdir()
    src = ("from multiprocessing import shared_memory\n"
           "def f(n):\n"
           "    a = shared_memory.SharedMemory(create=True, size=n)\n"
           "    b = shared_memory.SharedMemory(  # lint: ignore[SHM-LIFECYCLE]\n"
           "        create=True, size=n)\n"
           "    return a, b\n")
    bad.write_text(src)
    got = analyze_paths([str(tmp_path)], root=str(tmp_path))
    assert [f.token for f in got] == ["a"], got


# --------------------------------------------- the differential (kept rules)

@pytest.fixture(scope="module")
def ref_corpus_pair():
    """Both packages' lints over the reference's own corpus (read only)."""
    return (analyze_paths([REF_CORPUS], root=REF_CORPUS),
            ref_analyze_paths([REF_CORPUS], root=REF_CORPUS))


@pytest.mark.parametrize("rule", KEPT)
def test_kept_rule_matches_reference_on_its_corpus(ref_corpus_pair, rule):
    """A rule whose logic the port did not change gives the reference's
    finding keys, count for count, on the reference's corpus."""
    port, ref = ref_corpus_pair
    got = sorted(f.key for f in port if f.rule == rule)
    want = sorted(f.key for f in ref if f.rule == rule)
    assert want, f"{rule} fires nothing on the reference corpus"
    assert got == want
    assert sorted(f.line for f in port if f.rule == rule) == \
        sorted(f.line for f in ref if f.rule == rule)


def test_redesigned_rules_differ_only_where_designed(ref_corpus_pair):
    """On the reference's corpus the redesigned rules differ exactly as
    designed: STAGE-PURE no longer knows the JAX engine's surface (its
    dispatch-side heavy calls still fire), ENV-REGISTRY reads the port's
    registry (the reference's registered knob is unregistered here) and
    NATIVE-CONTRACT reads the port's tables, which equal the
    reference's."""
    port, ref = ref_corpus_pair

    def keys(fs, rule):
        return sorted(f.key for f in fs if f.rule == rule)

    assert keys(port, "STAGE-PURE") == sorted(
        k for k in keys(ref, "STAGE-PURE") if "_dispatch" in k)
    assert set(keys(ref, "ENV-REGISTRY")) < set(keys(port, "ENV-REGISTRY"))
    assert keys(port, "NATIVE-CONTRACT") == keys(ref, "NATIVE-CONTRACT")


# --------------------------------------------------------------- baseline

def test_baseline_growth_detection(corpus_findings):
    base = baseline_payload(corpus_findings, notes={})
    growth, stale = compare_to_baseline(corpus_findings, base)
    assert growth == [] and stale == []
    extra = corpus_findings[0]
    growth, _ = compare_to_baseline(corpus_findings + [extra], base)
    assert len(growth) == 1 and growth[0].key == extra.key
    growth, stale = compare_to_baseline(corpus_findings[1:], base)
    assert growth == [] and stale == [corpus_findings[0].key]


def test_live_tree_clean_against_baseline():
    """THE gate: the port's package + README carry no findings beyond
    the committed baseline (constdb_tpu_torch/analysis/baseline.json)."""
    findings = run_default_analysis() + check_readme_registry()
    growth, _stale = compare_to_baseline(findings, load_baseline())
    assert growth == [], "new lint findings:\n" + \
        "\n".join(f.render() for f in growth)


def test_live_tree_has_zero_findings_and_empty_baseline():
    """Nothing is baselined: the port's tree is clean outright."""
    assert run_default_analysis() + check_readme_registry() == []
    base = load_baseline()
    assert base["findings"] == {} and base["notes"] == {}


def test_baselined_keys_carry_notes():
    base = load_baseline()
    notes = base.get("notes", {})
    for key in base.get("findings", {}):
        assert any(key.startswith(p) for p in notes), \
            f"baselined key has no tracking note prefix: {key}"


def test_host_pool_repairs_hold():
    """The export segment carries its justified SHM-LIFECYCLE escape, and
    the forkserver workers get the device as plain data: neither rule
    fires on parallel/host_pool.py, and without the annotation the
    segment would be a finding."""
    import constdb_tpu_torch.parallel.host_pool as HP
    path = HP.__file__
    root = os.path.dirname(os.path.dirname(os.path.dirname(path)))
    got = analyze_paths([path], root=root)
    assert [f for f in got if f.rule in ("SHM-LIFECYCLE",
                                         "FORK-CAPTURE")] == []
    with open(path, encoding="utf-8") as f:
        src = f.read()
    assert "# lint: ignore[SHM-LIFECYCLE]" in src
    assert "self.device)" not in src.split("ctx.Process(")[1][:300]


def test_cli_baseline_mode_green(capsys):
    assert lint_main(["--baseline"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_plain_mode_reports(capsys):
    rc = lint_main([CORPUS, "--root", CORPUS])
    out = capsys.readouterr().out
    assert rc == 1 and "finding(s)" in out


def test_cli_list_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()] == \
        [r.name for r in ALL_RULES]


def test_cli_json_mode(capsys, corpus_findings):
    """--json: stable keys matching baseline.json, both modes."""
    rc = lint_main([CORPUS, "--root", CORPUS, "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1 and payload["version"] == 1
    assert len(payload["findings"]) == len(corpus_findings)
    assert payload["counts"] == \
        baseline_payload(corpus_findings, {})["findings"]
    for f in payload["findings"]:
        assert f["key"] == \
            f"{f['rule']}:{f['path']}:{f['qualname']}:{f['token']}"
    rc = lint_main(["--baseline", "--json"])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 0 and payload["baseline"]["growth"] == []


# ----------------------------------------------------------- env registry

def test_registry_documented_in_readme():
    """Every CONSTDB_TORCH_* name of the port's registry is in the
    README's port Tuning table."""
    assert len(conf.ENV_REGISTRY) >= 51
    assert check_readme_registry() == []


def test_readme_check_reads_the_ports_registry(tmp_path):
    readme = tmp_path / "README.md"
    readme.write_text("| `CONSTDB_TORCH_PIPELINE` | 1 | staging |\n")
    got = check_readme_registry(str(readme))
    assert {f.token for f in got} == \
        {f"{n}:undocumented" for n in conf.ENV_REGISTRY} - \
        {"CONSTDB_TORCH_PIPELINE:undocumented"}


def test_env_helpers_and_registry_discipline(monkeypatch):
    monkeypatch.setenv("CONSTDB_TORCH_POOL_FLUSH_MB", "64")
    assert conf.env_int("CONSTDB_TORCH_POOL_FLUSH_MB", 1536) == 64
    monkeypatch.delenv("CONSTDB_TORCH_POOL_FLUSH_MB")
    assert conf.env_int("CONSTDB_TORCH_POOL_FLUSH_MB", 1536) == 1536
    monkeypatch.setenv("CONSTDB_TORCH_PIPELINE", "0")
    assert conf.env_flag("CONSTDB_TORCH_PIPELINE", True) is False
    monkeypatch.setenv("CONSTDB_TORCH_PIPELINE", "1")
    assert conf.env_flag("CONSTDB_TORCH_PIPELINE", True) is True
    with pytest.raises(KeyError):
        conf.env_str("CONSTDB_TORCH_NOT_A_REAL_KNOB", "")
    with pytest.raises(KeyError):
        conf.env_int("CONSTDB_POOL_FLUSH_MB", 1536)  # the reference's


def test_env_rule_helpers_cover_the_ports_conf():
    """The rule's helper set names every env_* reader the port's conf.py
    defines."""
    readers = {n for n in vars(conf) if n.startswith("env_")
               and callable(getattr(conf, n))}
    assert readers and readers <= EnvRegistryRule.HELPERS


def test_stage_pure_markers_are_the_engines():
    """Each STAGE-PURE device marker is a method of the port's engine,
    and the engine module binds the kernel module as KN."""
    from constdb_tpu_torch.engine import cuda as C
    for name in StagePureRule.DEVICE_MARKERS:
        assert callable(getattr(C.TorchMergeEngine, name, None)), name
    assert C.KN.__name__ == "constdb_tpu_torch.ops.kernels"
    assert StagePureRule.DEVICE_NAMES == {"torch", "KN"}
