"""Port parity for the input guardrails: ``sanitize_ids`` and the traced
``sanitize_kjt`` against the JAX package's, every corruption mode of the
host engine ``InputGuardrails`` against the JAX one, STRICT, the
quarantine store, and the guarded DMP step against the unguarded one on a
table-wise plan and a dedup'd row-wise plan.

Tolerances: none.  The sanitizers and the host engine are integer and
copy work (exact); the guarded step computes the unguarded step's
arithmetic (the synthesised unit weights multiply exactly), so its
losses, logits and tables are ``torch.equal``.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.datasets.utils import Batch as JBatch
from torchrec_tpu.ops.embedding_ops import sanitize_ids as jsanitize_ids
from torchrec_tpu.robustness.policy import GuardrailPolicy as JPolicy
from torchrec_tpu.robustness.policy import GuardrailsConfig as JConfig
from torchrec_tpu.robustness.policy import InputGuardrails as JGuardrails
from torchrec_tpu.robustness.sanitize import sanitize_kjt as jsanitize_kjt
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.datasets.random import RandomRecDataset
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.dlrm import DLRM
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection as TEBC,
)
from torchrec_tpu_torch.ops.embedding_ops import sanitize_ids
from torchrec_tpu_torch.ops.fused_update import FusedOptimConfig
from torchrec_tpu_torch.optim import adagrad
from torchrec_tpu_torch.parallel.model_parallel import DistributedModelParallel
from torchrec_tpu_torch.parallel.types import (
    ParameterSharding,
    ShardingType,
    table_wise_plan,
)
from torchrec_tpu_torch.robustness import (
    GuardedIterator,
    GuardrailPolicy,
    GuardrailsConfig,
    InputGuardrailError,
    InputGuardrails,
    QuarantineStore,
    sanitize_kjt,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

KEYS = ["a", "b", "c"]
ROWS = {"a": 50, "b": 20, "c": 100}
B, CAPS = 8, [24, 16, 32]


def _raw(seed, weighted):
    """A KJT's host buffers, ids in range, padding slots holding
    garbage (which the guardrails must leave alone)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, 3, size=len(KEYS) * B).astype(np.int32)
    values = np.zeros(sum(CAPS), np.int64)
    off = 0
    for f, k in enumerate(KEYS):
        n = int(lengths[f * B:(f + 1) * B].sum())
        values[off:off + n] = rng.randint(0, ROWS[k], size=n)
        values[off + n:off + CAPS[f]] = -7  # padding garbage
        off += CAPS[f]
    weights = (rng.rand(sum(CAPS)).astype(np.float32) if weighted
               else None)
    dense = rng.rand(B, 4).astype(np.float32)
    labels = rng.randint(0, 2, size=B).astype(np.float32)
    return dict(values=values, lengths=lengths, weights=weights,
                dense=dense, labels=labels, bw=None)


def _corrupt(raw, mode):
    """``raw`` with one corruption of kind ``mode`` (its key: ``b``)."""
    r = {k: (None if v is None else v.copy()) for k, v in raw.items()}
    co = [0, CAPS[0], CAPS[0] + CAPS[1]]
    occ_b = int(r["lengths"][B:2 * B].sum())
    if mode in ("negative_ids", "oob_ids"):
        bad = -3 if mode == "negative_ids" else ROWS["b"] + 4
        r["lengths"][B] = max(r["lengths"][B], 2)
        occ_b = int(r["lengths"][B:2 * B].sum())
        r["values"][co[1]:co[1] + occ_b] = np.arange(occ_b) % ROWS["b"]
        r["values"][co[1]] = bad
        r["values"][co[1] + 1] = bad
    elif mode == "lied_lengths":  # lengths claim more ids than the cap
        r["lengths"][B:2 * B] = CAPS[1]
    elif mode == "negative_length":
        r["lengths"][B + 1] = -1
    elif mode == "float_ids":
        r["values"] = r["values"].astype(np.float32)
        r["values"][co[1]] = 2.5
    elif mode == "nonfinite_dense":
        r["dense"][1, 2] = np.nan
        r["dense"][3, 0] = np.inf
    elif mode == "nonfinite_labels":
        r["labels"][0] = np.nan
    elif mode == "nonfinite_weights":
        r["bw"] = np.ones(B, np.float32)
        r["bw"][5] = np.inf
    assert occ_b <= CAPS[1] or mode == "lied_lengths"
    return r


def _port_batch(r):
    kjt = KeyedJaggedTensor(
        KEYS, torch.from_numpy(r["values"]), torch.from_numpy(r["lengths"]),
        None if r["weights"] is None else torch.from_numpy(r["weights"]),
        stride=B, caps=CAPS)
    return Batch(torch.from_numpy(r["dense"]), kjt,
                 torch.from_numpy(r["labels"]),
                 None if r["bw"] is None else torch.from_numpy(r["bw"]))


def _jax_batch(r):
    kjt = JKJT(KEYS, jnp.asarray(r["values"]), jnp.asarray(r["lengths"]),
               None if r["weights"] is None else jnp.asarray(r["weights"]),
               stride=B, caps=CAPS)
    return JBatch(jnp.asarray(r["dense"]), kjt, jnp.asarray(r["labels"]),
                  None if r["bw"] is None else jnp.asarray(r["bw"]))


@pytest.mark.parametrize("weighted", [False, True])
def test_sanitize_ids_matches_jax(weighted):
    rng = np.random.RandomState(1)
    ids = rng.randint(-5, 60, size=300).astype(np.int32)
    w = rng.rand(300).astype(np.float32) if weighted else None
    got = sanitize_ids(torch.from_numpy(ids), 50,
                       None if w is None else torch.from_numpy(w))
    want = jsanitize_ids(jnp.asarray(ids), 50,
                         None if w is None else jnp.asarray(w))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    clean = ids % 50
    ids_c, w_c, bad = sanitize_ids(torch.from_numpy(clean), 50,
                                   None if w is None else torch.from_numpy(w))
    assert not bad.any() and np.array_equal(ids_c.numpy(), clean)
    if w is not None:  # the same bits
        assert np.array_equal(w_c.numpy().view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("weighted", [False, True])
def test_sanitize_kjt_matches_jax(weighted):
    r = _corrupt(_raw(2, weighted), "oob_ids")
    co = [0, CAPS[0], CAPS[0] + CAPS[1]]
    r["lengths"][:B] = np.maximum(r["lengths"][:B], 1)
    occ_a = int(r["lengths"][:B].sum())
    r["values"][co[0]:co[0] + occ_a] %= ROWS["a"]  # real slots in range
    r["values"][co[0]] = -1  # then one negative id on key a
    port, ref = _port_batch(r), _jax_batch(r)
    kjt, viol = sanitize_kjt(port.sparse_features, ROWS)
    jkjt, jviol = jsanitize_kjt(ref.sparse_features, ROWS)
    np.testing.assert_array_equal(viol.numpy(), np.asarray(jviol))
    assert viol.tolist() == [1, 2, 0] and viol.dtype == torch.int32
    np.testing.assert_array_equal(kjt.values().numpy(),
                                  np.asarray(jkjt.values()))
    np.testing.assert_array_equal(kjt.weights_or_none().numpy(),
                                  np.asarray(jkjt.weights()))
    # padding garbage untouched, and clean input keeps its bits
    assert (kjt.values().numpy() == -7).sum() == (r["values"] == -7).sum()
    clean = _port_batch(_raw(3, weighted)).sparse_features
    kc, vc = sanitize_kjt(clean, ROWS)
    assert not vc.any()
    assert torch.equal(kc.values(), clean.values())
    assert torch.equal(kc.lengths(), clean.lengths())
    want_w = (clean.weights_or_none() if weighted
              else torch.ones(sum(CAPS), dtype=torch.float32))
    assert np.array_equal(kc.weights_or_none().numpy().view(np.int32),
                          want_w.numpy().view(np.int32))


MODES = ["negative_ids", "oob_ids", "lied_lengths", "negative_length",
         "float_ids", "nonfinite_dense", "nonfinite_labels",
         "nonfinite_weights"]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_guardrails_diagnose_and_repair_match_jax(mode, weighted):
    r = _corrupt(_raw(4, weighted), mode)
    port = InputGuardrails(GuardrailsConfig(), feature_rows=ROWS)
    ref = JGuardrails(JConfig(), feature_rows=ROWS)
    d, jd = port.diagnose(_port_batch(r)), ref.diagnose(_jax_batch(r))
    assert jd is not None and d is not None
    assert (d.kind, d.key, d.count) == (jd.kind, jd.key, jd.count)
    fixed, jfixed = port.sanitize(_port_batch(r)), ref.sanitize(_jax_batch(r))
    k, jk = fixed.sparse_features, jfixed.sparse_features
    for a, b in ((k.values(), jk.values()), (k.lengths(), jk.lengths()),
                 (fixed.dense_features, jfixed.dense_features),
                 (fixed.labels, jfixed.labels)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (k.weights_or_none() is None) == (jk.weights_or_none() is None)
    if k.weights_or_none() is not None:
        np.testing.assert_array_equal(k.weights_or_none().numpy(),
                                      np.asarray(jk.weights()))
    if r["bw"] is not None:
        np.testing.assert_array_equal(fixed.weights.numpy(),
                                      np.asarray(jfixed.weights))
    if mode not in ("negative_length", "lied_lengths"):
        assert port.diagnose(fixed) is None  # the repair holds
    # SANITIZE counts the batch and hands back the repair
    out = port.apply(_port_batch(r))
    assert out is not None and port.sanitized_batches == 1
    assert port.scalar_metrics()[f"guardrails/violations/{d.kind}"] == d.count
    assert port.diagnose(_port_batch(_raw(4, weighted))) is None


def test_strict_raises_naming_the_key():
    g = InputGuardrails(GuardrailsConfig(policy=GuardrailPolicy.STRICT),
                        feature_rows=ROWS)
    with pytest.raises(InputGuardrailError, match="key b"):
        g.apply(_port_batch(_corrupt(_raw(5, True), "oob_ids")))
    assert g.apply(_port_batch(_raw(5, True))) is not None
    with pytest.raises(ValueError, match="quarantine_dir"):
        InputGuardrails(GuardrailsConfig(policy=GuardrailPolicy.QUARANTINE))
    assert JPolicy.STRICT.value == GuardrailPolicy.STRICT.value


def test_quarantine_round_trip_bound_and_torn_entries(tmp_path):
    bad = _port_batch(_corrupt(_raw(6, True), "negative_ids"))
    g = InputGuardrails(GuardrailsConfig(
        policy=GuardrailPolicy.QUARANTINE, quarantine_dir=str(tmp_path),
        max_quarantined=2), feature_rows=ROWS)
    clean = _port_batch(_raw(6, True))
    stream = GuardedIterator(iter([bad, clean, bad, bad]), g)
    assert list(stream) == [clean]  # the bad ones skipped
    store = g.quarantine
    assert g.quarantined_batches == 3 and len(store) == 2
    assert store.entries() == ["q_000001", "q_000002"]  # oldest dropped
    batch, report = store.load("q_000002")
    assert report["diagnosis"]["kind"] == "negative_ids"
    assert report["diagnosis"]["key"] == "b"
    for a, b in ((batch.sparse_features.values(),
                  bad.sparse_features.values()),
                 (batch.sparse_features.lengths(),
                  bad.sparse_features.lengths()),
                 (batch.sparse_features.weights_or_none(),
                  bad.sparse_features.weights_or_none()),
                 (batch.dense_features, bad.dense_features)):
        assert torch.equal(a, b)
    # a payload without its report, or a report still being written, is
    # not an entry; a new store continues the numbering
    np.savez(os.path.join(tmp_path, "q_000009.npz"), x=np.zeros(1))
    with open(os.path.join(tmp_path, "q_000010.json.tmp"), "w") as f:
        json.dump({}, f)
    again = QuarantineStore(str(tmp_path), max_entries=2)
    assert again.entries() == ["q_000001", "q_000002"]
    assert again.put(bad, {"kind": "x"}) == "q_000003"


# -- the guarded step -------------------------------------------------------

DKEYS = [f"f{i}" for i in range(4)]
DROWS, D, DB, DENSE_IN = 200, 8, 32, 13
IDS = [3, 1, 2, 4]
PLANS = {
    "tw": lambda tables: table_wise_plan(tables),
    "rw_dedup": lambda tables: {
        t.name: ParameterSharding(ShardingType.ROW_WISE, ranks=[0],
                                  dedup=True) for t in tables},
}


def _dmp(plan, guardrails, kernel):
    tables = tuple(EmbeddingBagConfig(num_embeddings=DROWS, embedding_dim=D,
                                      name=f"t_{k}", feature_names=[k])
                   for k in DKEYS)
    caps = {k: DB * n for k, n in zip(DKEYS, IDS)}
    return DistributedModelParallel(
        DLRM(TEBC(tables, device="meta"), DENSE_IN, (16, D), (16, 1)),
        tables, PLANS[plan](tables), DB, caps,
        fused_config=FusedOptimConfig(learning_rate=0.05),
        dense_optimizer=adagrad(0.05), device="cpu", guardrails=guardrails,
        lookup_kernel=kernel, update_kernel=kernel)


def _poison(batch, key_index, ids):
    """``batch`` with its first real ids of one key replaced by ``ids``."""
    kjt = batch.sparse_features
    values = kjt.values().clone()
    start = kjt.cap_offsets()[key_index]
    values[start:start + len(ids)] = torch.tensor(ids, dtype=values.dtype)
    return dataclasses.replace(batch, sparse_features=kjt.with_values(values))


@pytest.mark.parametrize("kernel", ["tbe", "dedup"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_guarded_step_equals_unguarded_on_clean_batches(plan, kernel):
    plain = _dmp(plan, None, kernel)
    guarded = _dmp(plan, GuardrailsConfig(), kernel)
    s0 = plain.init(torch.Generator().manual_seed(0))
    s1 = guarded.init(torch.Generator().manual_seed(0))
    it = iter(RandomRecDataset(DKEYS, DB, [DROWS] * 4, IDS,
                               num_dense=DENSE_IN, manual_seed=0))
    for _ in range(3):
        b = next(it)
        s0, m0 = plain.train_step(s0, b)
        s1, m1 = guarded.train_step(s1, b)
        for k in m0:
            assert torch.equal(m0[k], m1[k]), k
        assert m1["id_violations"].tolist() == [0] * 4
        assert "id_violations" not in m0
        assert ("dedup_overflow" in m1) == (plan == "rw_dedup")
    w0, w1 = plain.table_weights(s0), guarded.table_weights(s1)
    assert all(np.array_equal(w0[t], w1[t]) for t in w0)
    # a corrupt batch: counted per key, no row the valid ids miss moves,
    # the loss stays finite
    b = _poison(next(it), 2, [-1, DROWS, DROWS + 9])
    before = guarded.table_weights(s1)
    s1, m = guarded.train_step(s1, b)
    assert m["id_violations"].tolist() == [0, 0, 3, 0]
    assert torch.isfinite(m["loss"])
    after = guarded.table_weights(s1)
    kjt = b.sparse_features
    for f, k in enumerate(DKEYS):
        occ = int(kjt.lengths()[f * DB:(f + 1) * DB].sum())
        start = kjt.cap_offsets()[f]
        ids = kjt.values()[start:start + occ].numpy()
        touched = np.zeros(DROWS, bool)
        touched[ids[(ids >= 0) & (ids < DROWS)]] = True
        untouched = ~touched
        assert np.array_equal(after[f"t_{k}"][untouched],
                              before[f"t_{k}"][untouched]), k
