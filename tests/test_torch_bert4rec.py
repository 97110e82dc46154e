"""Port parity for BERT4Rec and the sequence train step at one rank: the
port's ``TransformerBlock``, ``BERT4Rec`` (through its item collection and
``forward_from_embeddings``, with a session of length 0) and
``masked_item_loss`` with its gradient against flax and JAX, the weights
carried by ``convert.py``; ``optim/adam.py`` against ``optax.adam``; and
a 5-step unsharded ``SequenceModelParallel`` run (plain B6 with fused
Adam on the item table, dense Adam) against the JAX one.

Tolerances, with their reasons:

* Forward, ``atol = 1e-5`` (``rtol = 1e-5``): XLA and PyTorch sum the
  projections, the attention products and the LayerNorm moments in other
  orders; the scores, the masking and the GELU are the same formulas.
* The loss ``rtol = 1e-6`` and its gradient ``atol = 1e-6``.
* Adam over 5 steps, ``rtol = 1e-6, atol = 1e-7``: the same formula in
  the same order; ``1 - b**t`` is float32 on both sides but XLA's ``pow``
  and numpy's may differ in the last bit.
* The 5-step run: losses ``rtol = 1e-5``, dense parameters and tables
  ``atol = 5e-5`` after 5 Adam steps at lr 1e-2 (Adam moves every element
  by about ``lr`` whatever its gradient's size, so where a gradient is
  near zero the forward's last-bit differences change the step; measured
  below 1e-5 on most elements), the Adam moments ``rtol = 1e-3, atol =
  1e-7``.  The attention's key bias is left out of that comparison: it
  adds one constant to each query's scores, which the softmax ignores, so
  its gradient is zero in exact arithmetic and each side's Adam turns its
  own rounding noise there into steps of about ``lr``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from torchrec_tpu.datasets.utils import Batch as JBatch
from torchrec_tpu.models.experimental.bert4rec import BERT4Rec as JBERT
from torchrec_tpu.models.experimental.bert4rec import (
    TransformerBlock as JBlock,
)
from torchrec_tpu.models.experimental.bert4rec import (
    masked_item_loss as j_loss,
)
from torchrec_tpu.modules.embedding_configs import EmbeddingConfig as JCfg
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import FusedOptimConfig as JFused
from torchrec_tpu.parallel.comm import ShardingEnv as JEnv
from torchrec_tpu.parallel.comm import create_mesh
from torchrec_tpu.parallel.model_parallel import stack_batches
from torchrec_tpu.parallel.sequence_model_parallel import (
    SequenceModelParallel as JSMP,
)
from torchrec_tpu.parallel.types import ParameterSharding as JPS
from torchrec_tpu.parallel.types import ShardingType as JST
from torchrec_tpu.sparse import JaggedTensor as JJT
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.convert import (
    flax_params_from_state_dict,
    sequence_train_state_from_jax,
    sequence_train_state_to_jax,
    state_dict_from_flax,
)
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.examples.bert4rec.main import (
    make_loss_fn,
    make_session_batch,
)
from torchrec_tpu_torch.models.experimental.bert4rec import (
    BERT4Rec,
    TransformerBlock,
    masked_item_loss,
)
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.ops.fused_update import EmbOptimType, FusedOptimConfig
from torchrec_tpu_torch.optim.adam import adam
from torchrec_tpu_torch.parallel.sequence_model_parallel import (
    SequenceModelParallel,
)
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

B, L, V, D, H = 4, 8, 1000, 16, 2
CPU = torch.device("cpu")


def _np(t):
    return t.detach().cpu().numpy()


def _lengths_with_empty(rng):
    lengths = rng.randint(1, L + 1, size=(B,)).astype(np.int32)
    lengths[1] = 0  # a session of length 0: every key masked
    return lengths


def test_transformer_block_matches_flax():
    rng = np.random.RandomState(0)
    x = rng.randn(B, L, D).astype(np.float32)
    lengths = _lengths_with_empty(rng)
    mask = np.arange(L)[None, :] < lengths[:, None]
    blk = JBlock(H, D)
    params = blk.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))
    want = np.asarray(blk.apply(params, jnp.asarray(x), jnp.asarray(mask)))
    port = TransformerBlock(H, D)
    port.load_state_dict(state_dict_from_flax(params))
    got = _np(port(torch.from_numpy(x), torch.from_numpy(mask)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got[1]).all()  # finfo.min, not -inf: no NaN
    back = flax_params_from_state_dict(port.state_dict(), num_heads=H)
    jax.tree.map(np.testing.assert_array_equal, back,
                 jax.tree.map(np.asarray, params))


def _jax_model(num_blocks=2):
    return JBERT(vocab_size=V, max_len=L, emb_dim=D, num_blocks=num_blocks,
                 num_heads=H)


def _port_model(num_blocks=2, device="meta"):
    return BERT4Rec(vocab_size=V, max_len=L, emb_dim=D,
                    num_blocks=num_blocks, num_heads=H, device=device,
                    generator=torch.Generator().manual_seed(0))


def _dense_init(model, rng_key):
    return model.init(rng_key, jnp.zeros((B, L, D)), jnp.ones((B, L), bool),
                      method=JBERT.forward_from_embeddings)


def test_bert4rec_forward_from_embeddings_matches_flax():
    rng = np.random.RandomState(1)
    x = rng.randn(B, L, D).astype(np.float32)
    mask = np.arange(L)[None, :] < _lengths_with_empty(rng)[:, None]
    jm = _jax_model()
    params = _dense_init(jm, jax.random.key(1))
    want = np.asarray(jm.apply(params, jnp.asarray(x), jnp.asarray(mask),
                               method=JBERT.forward_from_embeddings))
    pm = _port_model()
    res = pm.load_state_dict(state_dict_from_flax(params), strict=False)
    assert not res.unexpected_keys
    assert all(k.startswith("history.") for k in res.missing_keys)
    got = _np(pm.forward_from_embeddings(torch.from_numpy(x),
                                         torch.from_numpy(mask)))
    assert got.shape == (B, L, V)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bert4rec_forward_through_collection_matches_flax():
    """The whole model: the item KJT through the port's
    ``EmbeddingCollection`` (the flax tree's ``history/ec/t_item``)."""
    rng = np.random.RandomState(2)
    lengths = _lengths_with_empty(rng)
    values = rng.randint(0, V, size=(int(lengths.sum()),))
    jkjt = JKJT.from_lengths_packed(["item"], values, lengths, caps=B * L)
    jm = _jax_model(num_blocks=1)
    params = jm.init(jax.random.key(2), jkjt)
    want = np.asarray(jm.apply(params, jkjt))
    pm = _port_model(num_blocks=1, device="cpu")
    inner = dict(params["params"])
    table = np.array(inner.pop("history")["ec"]["t_item"])
    sd = state_dict_from_flax(inner)
    sd["history.ec.t_item"] = torch.from_numpy(table)
    pm.load_state_dict(sd)
    kjt = KeyedJaggedTensor.from_lengths_packed(["item"], values, lengths,
                                                caps=B * L)
    np.testing.assert_allclose(_np(pm(kjt)), want, rtol=1e-5, atol=1e-5)


def test_masked_item_loss_and_grad_match_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(B, L, V).astype(np.float32)
    targets = rng.randint(0, V, size=(B, L))
    mask = (rng.rand(B, L) < 0.3).astype(np.float32)
    want, g_want = jax.value_and_grad(j_loss)(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask))
    t = torch.from_numpy(logits).requires_grad_()
    got = masked_item_loss(t, torch.from_numpy(targets),
                           torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(t.grad), np.asarray(g_want), atol=1e-6)
    # no masked position: the denominator's floor of 1, loss 0
    zero = masked_item_loss(t, torch.from_numpy(targets),
                            torch.zeros((B, L)))
    assert zero.item() == 0.0


def test_adam_matches_optax_over_five_steps():
    rng = np.random.RandomState(4)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.randn(*s) * 10.0 ** rng.randint(-6, 1)).astype(
        np.float32) for k, s in shapes.items()} for _ in range(5)]
    tx = optax.adam(1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    st = tx.init(jp)
    opt = adam(1e-2)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    assert ts["count"] == int(st[0].count) == 5
    for k in shapes:
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(_np(ts["mu"][k]), np.asarray(st[0].mu[k]),
                                   rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(_np(ts["nu"][k]), np.asarray(st[0].nu[k]),
                                   rtol=1e-6, atol=1e-16)


def _jax_loss(model, dense_params, emb_values, b):
    lengths = b.sparse_features["item"].lengths()
    x = JJT(emb_values["item"], lengths).to_padded_dense(L)
    mask = jnp.arange(L)[None, :] < lengths[:, None]
    logits = model.apply(dense_params, x, mask,
                         method=JBERT.forward_from_embeddings)
    return j_loss(logits, b.dense_features.astype(jnp.int32), b.labels)


def _to_jax_batch(b: Batch) -> JBatch:
    kjt = b.sparse_features
    lengths = kjt.lengths().numpy()
    n = int(lengths.sum())
    jkjt = JKJT.from_lengths_packed(["item"], kjt.values().numpy()[:n],
                                    lengths, caps=B * L)
    return JBatch(jnp.asarray(b.dense_features.numpy()), jkjt,
                  jnp.asarray(b.labels.numpy()))


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def test_unsharded_training_matches_jax():
    tables = (JCfg(num_embeddings=V, embedding_dim=D, name="t_item",
                   feature_names=["item"]),)
    fused = dict(optim=JOptim.ADAM, learning_rate=1e-2)
    jm = _jax_model()
    env = JEnv.from_mesh(create_mesh((1,), ("model",),
                                     devices=jax.devices()[:1]))
    plan = {"t_item": JPS(JST.ROW_WISE, ranks=[0])}
    jsmp = JSMP(model=jm, tables=tables, env=env, plan=plan,
                batch_size_per_device=B, feature_caps={"item": B * L},
                loss_fn=_jax_loss, fused_config=JFused(**fused),
                dense_optimizer=optax.adam(1e-2))
    jstate = jsmp.init(jax.random.key(5), lambda k: _dense_init(jm, k))
    port_state = sequence_train_state_from_jax(
        jax.tree.map(np.asarray, jstate), CPU)
    smp = SequenceModelParallel(
        _port_model(), [EmbeddingConfig(num_embeddings=V, embedding_dim=D,
                                        name="t_item",
                                        feature_names=["item"])],
        None, {"t_item": ParameterSharding(ShardingType.ROW_WISE,
                                           ranks=[0])},
        B, {"item": B * L}, make_loss_fn(L),
        FusedOptimConfig(optim=EmbOptimType.ADAM, learning_rate=1e-2),
        adam(1e-2), device="cpu")
    # a fresh port state has the JAX state's structure
    fresh = smp.init(torch.Generator().manual_seed(0))
    assert fresh["dense"].keys() == port_state["dense"].keys()
    assert {g: st.keys() for g, st in fresh["fused"].items()} == {
        g: st.keys() for g, st in port_state["fused"].items()}
    rng = np.random.RandomState(6)
    batches = [make_session_batch(rng, B, L, V) for _ in range(5)]
    jstep = jsmp.make_train_step(donate=False)
    j_losses, p_losses = [], []
    for b in batches:
        jstate, m = jstep(jstate, stack_batches([_to_jax_batch(b)]))
        j_losses.append(float(m["loss"]))
        port_state, pm = smp.train_step(port_state, b)
        p_losses.append(float(pm["loss"]))
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5)
    got = sequence_train_state_to_jax(port_state, num_heads=H)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["dense_opt"]["count"]) == int(want["dense_opt"][0].count)
    for path, a in _leaves(got["dense"]).items():
        if path[-2:] == ("key", "bias"):
            continue  # zero gradient in exact arithmetic (module docstring)
        np.testing.assert_allclose(a, _at(want["dense"], path), atol=5e-5,
                                   err_msg="/".join(path))
        np.testing.assert_allclose(
            _at(got["dense_opt"]["mu"], path),
            _at(want["dense_opt"][0].mu, path), rtol=1e-3, atol=1e-7,
            err_msg="/".join(path))
    np.testing.assert_allclose(smp.table_weights(port_state)["t_item"],
                               np.asarray(jsmp.table_weights(jstate)[
                                   "t_item"]), atol=5e-5)
    for g, st in want["fused"].items():
        for k, v in st.items():
            np.testing.assert_allclose(np.asarray(got["fused"][g][k]),
                                       np.asarray(v), rtol=1e-3, atol=1e-7,
                                       err_msg=f"{g}/{k}")


def test_example_main_trains_on_cpu():
    """The BERT4Rec application at one rank on the CPU (it runs on the
    card unless asked): finite losses, 12 dense Adam steps, and the item
    table's rowwise-Adagrad state (the JAX default fused optimizer)
    stepped through the plain B6."""
    from torchrec_tpu_torch.examples.bert4rec.main import main

    out = main(["--device", "cpu", "--steps", "12", "--vocab", "300",
                "--max_len", "6", "--emb_dim", "8", "--num_heads", "2",
                "--batch_size", "4"])
    assert len(out["losses"]) == 12 and np.isfinite(out["losses"]).all()
    smp, state = out["smp"], out["state"]
    assert state["step"] == 12
    assert state["dense_opt"]["count"] == 12
    assert all(st["momentum"].any() for st in state["fused"].values())
    w = smp.table_weights(state)["t_item"]
    assert w.shape == (300, 8) and np.isfinite(w).all()
