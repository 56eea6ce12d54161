"""The port's staging tables and crc64 against the reference.

The port's native tier (its own C++ tables through its CPython
extension, built with g++ at first use), its pure-Python tier and the
reference package's factories (`constdb_tpu.utils.native_tables`, which
take whatever tier the reference has built) give equal ids, values and
masks on the same inputs, drawn from a seed with numpy, across table
growth.  The port's CRC64 equals the reference's table-driven Python CRC
streamed in pieces, and a broken source raises from the build instead of
falling back.
"""

import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from constdb_tpu.utils import checksum as RC
from constdb_tpu.utils import native_tables as RT
from constdb_tpu_torch.store.keyspace import KeySpace
from constdb_tpu_torch.utils import checksum as PC
from constdb_tpu_torch.utils import native as N
from constdb_tpu_torch.utils import tables as PT
from constdb_tpu_torch.utils.build import build_artifacts

TIERS = {
    "port-native": (PT._ExtStrTable, PT._ExtI64Dict),
    "port-pure": (PT._PyStrTable, PT._PyI64Dict),
    "reference": (RT.StrTable, RT.I64Dict),
}


def _keys(rng, n, pool):
    """n byte-strings drawn from `pool` distinct ones (repeats included):
    the empty string, and others with up to 10 trailing NULs."""
    ids = rng.integers(0, pool, n).tolist()
    return [b"" if i == 0 else b"k%d" % i + bytes(i % 11) for i in ids]


@pytest.mark.parametrize("tier", list(TIERS))
def test_str_table_ids_equal_across_tiers(tier):
    rng = np.random.default_rng(1)
    t = TIERS[tier][0](16)
    want: dict = {}
    # batches from tiny to past several doublings of the 16-slot start
    for n, pool in ((1, 4), (10, 8), (300, 200), (5000, 3000),
                    (40000, 60000), (3, 60000)):
        items = _keys(rng, n, pool)
        first = len(want)
        exp = [want.setdefault(b, len(want)) for b in items]
        ids, n_new = t.get_or_insert_batch(items)
        assert ids.dtype == np.int64 and ids.tolist() == exp
        assert n_new == len(want) - first
        probe = items[: 50] + [b"absent%d" % i for i in range(20)]
        assert t.lookup_batch(probe).tolist() == \
            [want.get(b, -1) for b in probe]
    assert len(t) == len(want)
    assert t.get_or_insert(b"one more") == len(want)
    assert t.lookup(b"one more") == len(want)
    assert t.lookup(b"never") == -1
    for b, i in list(want.items())[:: 997]:
        assert t.bytes_of(i) == b
    empty, n_new = t.get_or_insert_batch([])
    assert empty.tolist() == [] and n_new == 0


@pytest.mark.parametrize("tier", list(TIERS))
def test_i64_dict_equal_across_tiers(tier):
    rng = np.random.default_rng(2)
    d = TIERS[tier][1](16)
    want: dict = {}
    nxt = 100
    for n, span in ((5, 10), (400, 300), (20000, 50000), (30000, 1 << 40)):
        keys = rng.integers(-span, span, n).astype(np.int64)
        vals, n_new = d.get_or_assign_batch(keys, nxt)
        exp, start = [], nxt
        for k in keys.tolist():
            if k not in want:
                want[k] = nxt
                nxt += 1
            exp.append(want[k])
        assert vals.tolist() == exp and n_new == nxt - start
        # overwrite a third of them, delete a few, then look all up
        pk = keys[::3]
        pv = rng.integers(-(1 << 62), 1 << 62, len(pk)).astype(np.int64)
        d.put_batch(pk, pv)
        want.update(zip(pk.tolist(), pv.tolist()))
        for k in keys[1::50].tolist():
            assert d.delete(k, -7) == want.pop(k, -7)
        probe = np.concatenate([keys, np.array([1 << 50, -(1 << 50)])])
        assert d.lookup_batch(probe, -9).tolist() == \
            [want.get(k, -9) for k in probe.tolist()]
        assert len(d) == len(want)
    # a deleted key comes back (tombstone reuse) and single-key ops agree
    k = next(iter(want))
    assert d.delete(k) == want.pop(k)
    assert d.get(k, -5) == -5
    d.put(k, 42)
    assert d.get(k) == 42 and len(d) == len(want) + 1
    assert d.delete(1 << 61, -3) == -3


@pytest.mark.parametrize("tier", list(TIERS))
def test_nonnull_mask_equal_across_tiers(tier):
    fn = {"port-native": PT.nonnull_mask, "port-pure": PT._nonnull_mask_py,
          "reference": RT.nonnull_mask}[tier]
    rng = np.random.default_rng(3)
    for n in (0, 1, 17, 4096):
        items = [None if r < 0.3 else (b"" if r < 0.4 else b"x%d" % i)
                 for i, r in enumerate(rng.random(n).tolist())]
        want = np.array([v is not None for v in items], dtype=bool)
        for seq in (items, tuple(items)):
            m = fn(seq)
            assert m.dtype == bool and np.array_equal(m, want)
            assert m.flags.writeable
            if n:
                m[0] = not m[0]   # writable, and a private copy
                assert fn(seq)[0] == want[0]


def test_factories_take_the_native_tier_and_the_knob(monkeypatch):
    """The factories always take the native tier: no knob selects the pure
    one, not the reference's CONSTDB_NO_NATIVE either."""
    ks = KeySpace()
    for name in ("key_index", "member_index", "el_index", "tns_index"):
        assert PT.tier(getattr(ks, name)) == "native"
    for knob in ("CONSTDB_NO_NATIVE", "CONSTDB_TORCH_NO_NATIVE"):
        monkeypatch.setenv(knob, "1")
    assert isinstance(PT.StrTable(), PT._ExtStrTable)
    assert isinstance(PT.I64Dict(), PT._ExtI64Dict)
    assert PT.tier(KeySpace().key_index) == "native"
    assert PT.tier(PT._PyStrTable()) == "pure"


def test_crc64_matches_reference_streamed():
    assert PC.crc64(b"123456789") == 0x995DC9BBDF1939FA
    assert RC._crc64_py(b"123456789") == 0x995DC9BBDF1939FA
    assert PC.crc64(b"") == 0
    rng = np.random.default_rng(4)
    for n in (1, 7, 8, 9, 63, 1000, 65537):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        want = RC._crc64_py(data)
        assert PC.crc64(data) == PC._crc64_py(data) == want
        assert PC.crc64(bytearray(data)) == want
        assert PC.crc64(memoryview(data)) == want
        assert PC.crc64(np.frombuffer(data, np.uint8)) == want
        cuts = sorted(set(rng.integers(0, n + 1, 5).tolist()))
        crc = 0
        for a, b in zip([0] + cuts, cuts + [n]):
            crc = PC.crc64(data[a:b], crc)
        assert crc == want
        s = PC.StreamChecksum()
        assert s.alg == PC.StreamChecksum.ALG_CRC64
        r = RC.StreamChecksum(RC.StreamChecksum.ALG_CRC64)
        for a, b in zip([0] + cuts, cuts + [n]):
            s.update(data[a:b])
            r.update(data[a:b])
        assert s.digest() == r.digest() == want


def test_broken_source_raises_from_the_build(tmp_path):
    src = tmp_path / "native"
    shutil.copytree(N.SRC, src)
    with open(src / "tables.cpp", "a") as f:
        f.write("\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        N.build(src, tmp_path / "build")
    with pytest.raises(RuntimeError, match="native build failed"):
        N.load(src, tmp_path / "build")
    # nothing half-built is left to be picked up later
    assert not list((tmp_path / "build").rglob("*.so"))


def test_stamp_covers_every_source_file(tmp_path):
    """A header beside the sources, or a changed one, changes the stamp
    (and so the build directory)."""
    src = tmp_path / "native"
    shutil.copytree(N.SRC, src)
    first = N.stamp_of(src)
    assert first == N.stamp_of(N.SRC)
    (src / "extra.h").write_text("#define X 1\n")
    second = N.stamp_of(src)
    (src / "extra.h").write_text("#define X 2\n")
    assert len({first, second, N.stamp_of(src)}) == 3


def test_build_artifacts_builds_once_under_its_lock(tmp_path):
    """Concurrent first uses build each artifact once; a failed command
    raises, naming the artifact, and leaves no file behind."""
    log = tmp_path / "runs"
    fake = [sys.executable, "-c",
            "import sys, time; open(sys.argv[1], 'a').write('x'); "
            "time.sleep(0.2); open(sys.argv[3], 'w').write('built')",
            str(log)]
    out = tmp_path / "out"
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda _: build_artifacts(out, {"a.so": fake}, "t"),
                      range(4)))
    assert log.read_text() == "x" and (out / "a.so").read_text() == "built"
    bad = [sys.executable, "-c", "import sys; print('no'); sys.exit(3)"]
    with pytest.raises(RuntimeError,
                       match=r"(?s)t failed: b\.so .*exit 3.*no"):
        build_artifacts(out, {"a.so": fake, "b.so": bad}, "t")
    assert sorted(p.name for p in out.iterdir()) == ["a.so", "lock"]
    assert log.read_text() == "x"


def test_stale_build_is_refused(tmp_path, monkeypatch):
    """Artifacts whose compiled-in stamp differs from the sources' are
    refused at load."""
    built = N.load().path
    stale = "0" * 64
    monkeypatch.setattr(N, "stamp_of", lambda src=N.SRC: stale)
    out = tmp_path / stale[:16]
    out.mkdir()
    shutil.copy(built / N.EXT_NAME, out / N.EXT_NAME)
    with pytest.raises(RuntimeError, match="build stamp"):
        N.load(N.SRC, tmp_path)
