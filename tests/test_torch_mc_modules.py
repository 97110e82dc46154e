"""Port parity for managed collision (``modules/mc_modules.py``): slots,
evictions and counters of every eviction policy against the JAX package's
modules on the same seeded streams (exact: both run the same C++
transformers), ``remap_packed`` over the full int64 range, ``remap_kjt``,
the capacity guard, ``reset_evicted_rows`` and the two pairings with the
port's collections (the pooled and sequence outputs exactly those of the
collection on the remapped KJT)."""

import numpy as np
import pytest
import torch

import torch_dynamic_helpers as helpers
from torchrec_tpu.modules import mc_modules as jmc
from torchrec_tpu_torch.modules import mc_modules as tmc
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

POLICIES = ("lru", "lfu", "distance_lfu", "multi_probe")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    return helpers.build_jax_native(str(tmp_path_factory.mktemp("jaxlib")))


@pytest.fixture
def jax_native(jax_lib, monkeypatch):
    helpers.patch_jax_native(monkeypatch, jax_lib)


def _stream(seed, steps=12, n=40):
    """Zipf-skewed raw ids over the whole int64 range: a hot head and a
    long tail, so a 64-slot table evicts every policy's way."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(200)
    ids = (rng.randint(-(1 << 62), 1 << 62, size=200).astype(np.int64)
           | np.int64(1))
    p = 1.0 / (ranks + 1.0) ** 1.1
    p /= p.sum()
    return [ids[rng.choice(200, size=n, p=p)] for _ in range(steps)]


@pytest.mark.parametrize("policy", POLICIES)
def test_mch_slots_evictions_counters_match_jax(jax_native, policy):
    t = tmc.MCHManagedCollisionModule(64, "t", eviction_policy=policy)
    j = jmc.MCHManagedCollisionModule(64, "t", eviction_policy=policy)
    evicted = 0
    for ids in _stream(3):
        ts, tev = t.remap(ids)
        js, jev = j.remap(ids)
        np.testing.assert_array_equal(ts, js)
        assert (tev is None) == (jev is None)
        if tev is not None:
            np.testing.assert_array_equal(tev.global_ids, jev.global_ids)
            np.testing.assert_array_equal(tev.slots, jev.slots)
            evicted += len(tev.slots)
        assert ts.min() >= 0 and ts.max() < 64
    assert evicted > 0
    assert t.scalar_metrics() == j.scalar_metrics()


def test_remap_packed_full_int64_range_matches_jax(jax_native):
    """Ids that collide under int32 truncation get distinct slots, and the
    packed remap over two keys equals the JAX one."""
    def coll(mod):
        return mod.ManagedCollisionCollection({
            "f0": mod.MCHManagedCollisionModule(8, "t0"),
            "f1": mod.MCHManagedCollisionModule(8, "t1",
                                                eviction_policy="lfu")})

    t, j = coll(tmc), coll(jmc)
    a, b = 5, 5 + (1 << 32)
    values = np.asarray([a, b, a, -(1 << 63), (1 << 63) - 1, a], np.int64)
    lengths = np.asarray([2, 1, 2, 1], np.int32)
    tout, tev = t.remap_packed(["f0", "f1"], values, lengths)
    jout, jev = j.remap_packed(["f0", "f1"], values, lengths)
    np.testing.assert_array_equal(tout, jout)
    assert tout[0] != tout[1] and tout[0] == tout[2]
    assert not tev and not jev


def test_remap_kjt_equals_remap_packed():
    """The KJT entry (int64 values kept whole) gives the packed entry's
    slots in its per-key regions."""
    rng = np.random.RandomState(2)
    keys = ["f0", "f1"]
    lengths = rng.randint(0, 3, size=(8,)).astype(np.int32)
    values = rng.randint(0, 1 << 60, size=int(lengths.sum())).astype(
        np.int64)
    mk = lambda: tmc.ManagedCollisionCollection(  # noqa: E731
        {k: tmc.MCHManagedCollisionModule(16, k) for k in keys})
    packed, _ = mk().remap_packed(keys, values, lengths)
    kjt = KeyedJaggedTensor.from_lengths_packed(keys, values, lengths,
                                                caps=8)
    out, _ = mk().remap_kjt(kjt)
    ref = KeyedJaggedTensor.from_lengths_packed(keys, packed, lengths,
                                                caps=8)
    assert out.values().dtype == torch.int64
    assert torch.equal(out.values()[ref.valid_mask()],
                       ref.values()[ref.valid_mask()])


@pytest.mark.parametrize("policy", ("lru", "lfu", "distance_lfu"))
def test_batch_exceeding_capacity_raises(policy):
    m = tmc.MCHManagedCollisionModule(4, "t", eviction_policy=policy)
    with pytest.raises(ValueError, match="working set"):
        m.remap(np.arange(8, dtype=np.int64))


def test_reset_evicted_rows_in_place():
    table = torch.ones((6, 3))
    out = tmc.reset_evicted_rows(table, np.asarray([1, 4, 9]))
    assert out is table
    assert torch.equal(table[[1, 4]], torch.zeros((2, 3)))
    assert torch.equal(table[[0, 2, 3, 5]], torch.ones((4, 3)))
    tmc.reset_evicted_rows(table, [0], init_fn=lambda s: torch.full(s, 2.0))
    assert torch.equal(table[0], torch.full((3,), 2.0))


def test_mc_ebc_and_ec_pairings():
    """Raw ids far outside the tables remap into bounded slots; the pooled
    (EBC) and sequence (EC) outputs are the collections' own on the
    remapped KJT, and a re-seen id keeps its row."""
    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
        EmbeddingConfig,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        EmbeddingBagCollection,
        EmbeddingCollection,
    )

    Z = 16
    raw = np.asarray([1_000_001, 2_000_002, 1_000_001, 7], np.int64)
    lengths = np.asarray([2, 2], np.int32)
    kjt = KeyedJaggedTensor.from_lengths_packed(["s"], raw, lengths, caps=8)
    ebc = EmbeddingBagCollection(
        (EmbeddingBagConfig(num_embeddings=Z, embedding_dim=4, name="t_s",
                            feature_names=["s"]),),
        device="cpu", generator=torch.Generator().manual_seed(0))
    mc = tmc.ManagedCollisionEmbeddingBagCollection(
        tmc.ManagedCollisionCollection(
            {"s": tmc.MCHManagedCollisionModule(Z, "t_s")}), ebc)
    assert dict(mc.named_children())["apply_fn"] is ebc
    kt = mc(kjt)
    remapped, _ = tmc.ManagedCollisionCollection(
        {"s": tmc.MCHManagedCollisionModule(Z, "t_s")}).remap_kjt(kjt)
    assert remapped.values()[:4].max() < Z
    assert torch.equal(kt.values(), ebc(remapped).values())
    assert mc.scalar_metrics()["mch/t_s/lookup_count"] == 4.0

    ec = EmbeddingCollection(
        (EmbeddingConfig(num_embeddings=Z, embedding_dim=4, name="t_s",
                         feature_names=["s"]),),
        device="cpu", generator=torch.Generator().manual_seed(1))
    mc_ec = tmc.ManagedCollisionEmbeddingCollection(
        tmc.ManagedCollisionCollection(
            {"s": tmc.MCHManagedCollisionModule(Z, "t_s")}), ec)
    jt = mc_ec(kjt)["s"]
    assert torch.equal(jt.lengths().to(torch.int32),
                       torch.tensor([2, 2], dtype=torch.int32))
    assert torch.equal(jt.values()[0], jt.values()[2])
    assert torch.equal(jt.values(), ec(remapped)["s"].values())
