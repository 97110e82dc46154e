"""The port's tiered storage tiers and ``TieredTable``
(``torchrec_tpu_torch/tiered/storage.py``) against the JAX package's
(``torchrec_tpu/tiered/storage.py``).

* ``opt_slot_widths`` equal for all eight fused optimizers.
* ``RamStore`` / ``DiskStore`` / ``HostRamCache``: after the same writes
  and flushes, both packages read the same rows (``np.array_equal``) and
  publish the same generation numbers; a subprocess SIGKILLed between
  flushes reopens at the last published generation.
* ``TieredTable``'s slots, evictions and fetch plans on one seeded Zipf
  stream equal the JAX table's (``np.array_equal``) for ``lru``, ``lfu``
  and ``lfu_aged``, both on their own native transformers (the JAX one
  built from its ``csrc/`` with g++ into a private directory).
* ``plan_cache_io`` equal on a shared transformer type.
* The port never falls back to the pure-Python transformer: a failed host
  library build raises; ``python_transformer=True`` names it.

Every comparison is exact: these are integer plans and float32 copies.
"""

import ctypes
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torchrec_tpu.inference import serving as jserving
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.tiered import storage as jstorage
from torchrec_tpu_torch.inference import serving as tserving
from torchrec_tpu_torch.ops import _native
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.tiered import (
    DiskStore,
    HostRamCache,
    RamStore,
    TieredTable,
    opt_slot_widths,
    plan_cache_io,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's id transformers (``csrc/*.cpp``) built with g++
    into a private directory and bound as the port's host library is (its
    ``trec_`` names); the JAX transformers load it in place of
    ``csrc_build.load_native``, and its tiered tables take the native
    transformers."""
    srcs = ["id_transformer.cpp", "lfu_id_transformer.cpp"]
    out = str(tmp_path_factory.mktemp("jax_native") / "libjax.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o",
                    out, *(os.path.join(ROOT, "csrc", s) for s in srcs),
                    "-lpthread"], check=True, capture_output=True)
    lib = ctypes.CDLL(out, mode=ctypes.RTLD_GLOBAL)
    for name, (argtypes, restype) in _native._HOST_SIGNATURES.items():
        jname = name.replace("trt_", "trec_")
        if not hasattr(lib, jname):
            continue
        fn = getattr(lib, jname)
        fn.argtypes, fn.restype = list(argtypes), restype
    mp = pytest.MonkeyPatch()
    mp.setattr(jserving, "load_native", lambda: lib)
    mp.setattr(jstorage, "_NATIVE_OK", True)
    try:
        yield lib
    finally:
        mp.undo()


@pytest.mark.parametrize("optim", [o.value for o in EmbOptimType])
def test_opt_slot_widths_match_jax(optim):
    got = opt_slot_widths(FusedOptimConfig(optim=EmbOptimType(optim)), 8)
    want = jstorage.opt_slot_widths(
        JFused(optim=JOptim(optim), learning_rate=0.1), 8)
    assert got == want


def _fill(v):
    def fill(buf):
        buf[...] = v
    return fill


def _script(store_a, store_b, rng):
    """The same writes and flushes through two stores; returns the
    generations each flush published."""
    gens = []
    for _ in range(4):
        ids = rng.choice(store_a.rows, size=5, replace=False).astype(np.int64)
        vals = rng.randn(5, store_a.width).astype(np.float32)
        store_a.write(ids, vals)
        store_b.write(ids, vals)
        gens.append((store_a.flush(), store_b.flush()))
    return gens


def test_ram_store_matches_jax():
    a, b = RamStore(20, 3, _fill(0.5)), jstorage.RamStore(20, 3, _fill(0.5))
    gens = _script(a, b, np.random.RandomState(0))
    assert all(g == (None, None) for g in gens)
    ids = np.arange(20, dtype=np.int64)
    np.testing.assert_array_equal(a.read(ids), b.read(ids))
    np.testing.assert_array_equal(a.snapshot(), b.snapshot())


def test_disk_store_and_ram_cache_match_jax(tmp_path):
    pa, pb = str(tmp_path / "a.tier"), str(tmp_path / "b.tier")
    a = HostRamCache(DiskStore(pa, 32, 4, _fill(1.0), keep_generations=2), 6)
    b = jstorage.HostRamCache(
        jstorage.DiskStore(pb, 32, 4, _fill(1.0), keep_generations=2), 6)
    gens = _script(a, b, np.random.RandomState(1))
    assert [ga for ga, _ in gens] == [gb for _, gb in gens] == [2, 3, 4, 5]
    ids = np.arange(32, dtype=np.int64)
    np.testing.assert_array_equal(a.read(ids), b.read(ids))
    # the same generations survive pruning, and both reopen alike
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["a.tier.g4", "a.tier.g5", "a.tier.work",
         "b.tier.g4", "b.tier.g5", "b.tier.work"])
    a2, b2 = DiskStore(pa, 32, 4), jstorage.DiskStore(pb, 32, 4)
    assert a2.generation == b2.generation == 5
    np.testing.assert_array_equal(a2.read(ids), b2.read(ids))
    a2.load_generation(4)
    b2.load_generation(4)
    np.testing.assert_array_equal(a2.read(ids), b2.read(ids))
    with pytest.raises(FileNotFoundError, match="keep_generations"):
        a2.load_generation(2)


def test_disk_store_kill_between_flushes(tmp_path):
    """A SIGKILL (no finalizer runs) after unflushed writes: reopening
    loads the last published generation, the later writes gone."""
    p = str(tmp_path / "t.tier")
    child = textwrap.dedent(f"""
        import os, signal, sys
        import numpy as np
        sys.path.insert(0, {ROOT!r})
        from torchrec_tpu_torch.tiered import DiskStore
        s = DiskStore({p!r}, 8, 2, init_fn=lambda b: b.__setitem__(..., 0.0))
        s.write(np.array([1]), np.full((1, 2), 3.0, np.float32))
        s.flush()
        s.write(np.array([1]), np.full((1, 2), 8.0, np.float32))
        s.write(np.array([5]), np.full((1, 2), 8.0, np.float32))
        s.array.flush()
        open({p!r} + ".g99.tmp", "wb").write(b"torn")
        os.kill(os.getpid(), signal.SIGKILL)
        """)
    r = subprocess.run([sys.executable, "-c", child], capture_output=True)
    assert r.returncode == -signal.SIGKILL, r.stderr.decode()
    s = DiskStore(p, 8, 2)
    assert s.generation == 2
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    rows = s.read(np.arange(8, dtype=np.int64))
    np.testing.assert_array_equal(rows[1], [3.0, 3.0])
    np.testing.assert_array_equal(rows[5], [0.0, 0.0])


def _zipf_stream(seed, n, size, rows):
    rng = np.random.RandomState(seed)
    return [((rng.zipf(1.2, size=size) - 1) % rows).astype(np.int64)
            for _ in range(n)]


@pytest.mark.parametrize("policy", ["lru", "lfu", "lfu_aged"])
def test_tiered_table_sequences_match_jax(jax_native, policy):
    """Slots, evictions, fetch plans, counters and the resident map of one
    seeded Zipf stream through both packages' tables (both native)."""
    kw = dict(opt_slots={"momentum": 1}, eviction_policy=policy, seed=3)
    t = TieredTable("t", 400, 4, 48, **kw)
    j = jstorage.TieredTable("t", 400, 4, 48, **kw)
    assert isinstance(t._transformer, (tserving.IdTransformer,
                                       tserving.LfuIdTransformer))
    assert isinstance(j._transformer, (jserving.IdTransformer,
                                       jserving.LfuIdTransformer))
    evictions = 0
    for ids in _zipf_stream(7, 12, 40, 400):
        s1, io1, c1 = t.remap(ids)
        s2, io2, c2 = j.remap(ids)
        np.testing.assert_array_equal(s1, s2)
        assert c1 == c2
        for f in ("fetch_slots", "fetch_logical", "writeback_slots",
                  "writeback_logical"):
            np.testing.assert_array_equal(getattr(io1, f), getattr(io2, f))
        evictions += c1[2]
    assert evictions > 0
    assert t._resident == j._resident
    # the host tiers' seeded default init is the JAX table's
    ids = np.arange(400, dtype=np.int64)
    np.testing.assert_array_equal(t.read_rows(ids), j.read_rows(ids))


def test_plan_cache_io_matches_jax(jax_native):
    a, b = tserving.IdTransformer(16), jserving.IdTransformer(16)
    for ids in _zipf_stream(11, 6, 12, 100):
        sa, ioa, na = plan_cache_io(a, ids, table_name="t", cache_rows=16)
        sb, iob, nb = jstorage.plan_cache_io(b, ids, table_name="t",
                                             cache_rows=16)
        np.testing.assert_array_equal(sa, sb)
        assert na == nb
        for f in ("fetch_slots", "fetch_logical", "writeback_slots",
                  "writeback_logical"):
            np.testing.assert_array_equal(getattr(ioa, f), getattr(iob, f))
    with pytest.raises(ValueError, match="distinct-id working set"):
        plan_cache_io(tserving.IdTransformer(4), np.arange(5), table_name="t",
                      cache_rows=4)


def test_no_silent_python_fallback(monkeypatch):
    """A failed host-library build raises out of the table; the
    pure-Python LFU transformer serves only when named."""
    t = TieredTable("t", 50, 2, 8, eviction_policy="lfu",
                    python_transformer=True)
    assert isinstance(t._transformer, tserving.PyLfuIdTransformer)

    def broken():
        raise RuntimeError("host library build failed")

    monkeypatch.setattr(tserving, "load_host_library", broken)
    for policy in ("lru", "lfu", "lfu_aged"):
        with pytest.raises(RuntimeError, match="build failed"):
            TieredTable("t", 50, 2, 8, eviction_policy=policy)
    with pytest.raises(ValueError, match="native only"):
        TieredTable("t", 50, 2, 8, eviction_policy="lru",
                    python_transformer=True)


def test_parallel_init_is_a_function_of_the_row():
    """``init_fn`` chunks fill on threads: the rows equal one serial
    fill, the slot columns zero."""
    rows = np.random.RandomState(0).randn(200_000, 4).astype(np.float32)
    t = TieredTable("t", 200_000, 4, 8, opt_slots={"momentum": 4},
                    init_fn=lambda s, e: rows[s:e])
    got = t.host_rows_view()
    np.testing.assert_array_equal(got[:, :4], rows)
    assert not got[:, 4:].any()
