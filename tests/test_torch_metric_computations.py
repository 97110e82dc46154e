"""Port parity for every metric computation of ``metrics/computations.py``:
the ten ``DEFAULT_COMPUTATIONS`` (windowed, lifetime and window values) and
the eight factories, against the JAX package on the same seeded numpy
batches: two tasks, 5 batches so that the window (3 batches, or 64 raw
examples) wraps, predictions drawn from a few values (ties), zero weights.

Float results within ``rtol = 1e-6, atol = 1e-7`` (both sum in float32,
in different orders); integer and order results exact: the raw-example
buffers, the stable sorts' orders, the session segments and ranks, and
the hindsight threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.metrics import computations as J
from torchrec_tpu.metrics.metric_module import MetricsConfig as JConfig
from torchrec_tpu.metrics.metric_module import RecTaskInfo as JTask
from torchrec_tpu.metrics.metric_module import (
    generate_metric_module as j_generate,
)
from torchrec_tpu.metrics.rec_metric import RecMetric as JRecMetric
from torchrec_tpu_torch.metrics import computations as P
from torchrec_tpu_torch.metrics import (
    MetricsConfig,
    RecTaskInfo,
    TowerQPSMetric,
    generate_metric_module,
)
from torchrec_tpu_torch.metrics.cpu_offloaded import CpuOffloadedMetricModule
from torchrec_tpu_torch.metrics.rec_metric import RecMetric

RTOL, ATOL = 1e-6, 1e-7
T, B, N_BATCHES, WINDOW_BATCHES, WINDOW = 2, 24, 5, 3, 64
TASKS = ("ctr", "cvr")
CPU = torch.device("cpu")


def _batches(seed=0, classes=None, grid=None):
    """[T, B] float32 (preds, labels, weights, sessions) per batch:
    predictions from a few values, a quarter of the weights zero."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(N_BATCHES):
        if classes is not None:
            preds = rng.randint(-1, classes + 1, (T, B)).astype(np.float32)
            labels = rng.randint(-1, classes + 1, (T, B)).astype(np.float32)
        else:
            preds = np.clip(np.round(rng.rand(T, B) * 8) / 8, 0.02, 0.98)
            if grid is not None:  # some predictions on the threshold grid
                on = rng.rand(T, B) < 0.3
                preds[on] = rng.randint(0, grid, on.sum()) / (grid - 1)
            preds = preds.astype(np.float32)
            labels = (rng.rand(T, B) < 0.35).astype(np.float32)
        weights = rng.choice([0.0, 0.5, 1.0, 2.0], size=(T, B)).astype(
            np.float32)
        sessions = rng.randint(0, 6, (T, B)).astype(np.int32)
        out.append((preds, labels, weights, sessions))
    return out


def _close(got, want, keys=None):
    keys = sorted(want) if keys is None else keys
    assert sorted(got) == sorted(want)
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", sorted(J.DEFAULT_COMPUTATIONS))
def test_default_computation_matches_jax(name):
    assert sorted(P.DEFAULT_COMPUTATIONS) == sorted(J.DEFAULT_COMPUTATIONS)
    jm = JRecMetric(J.DEFAULT_COMPUTATIONS[name], TASKS, WINDOW_BATCHES)
    pm = RecMetric(P.DEFAULT_COMPUTATIONS[name], TASKS, WINDOW_BATCHES)
    js, ps = jm.init(), pm.init(CPU)
    for p, l, w, _ in _batches(seed=len(name)):
        js = jm.update(js, jnp.asarray(p), jnp.asarray(l), jnp.asarray(w))
        ps = pm.update(ps, _t(p), _t(l), _t(w))
    want = {k: float(v) for k, v in jm.compute(js).items()}
    got = {k: float(v) for k, v in pm.compute(ps).items()}
    _close(got, want)


FACTORIES = {
    # name: (the factory call on a module, batch kind, extra channel)
    "multiclass_recall": (lambda m: m.make_multiclass_recall(4),
                          "classes", None),
    "hindsight_target_pr": (lambda m: m.make_hindsight_target_pr(0.4, 50),
                            "grid", None),
    "recalibrated_ne": (lambda m: m.make_recalibrated_ne(0.3), "probs",
                        None),
    "rauc": (lambda m: m.make_rauc(WINDOW), "probs", None),
    "segmented_ne": (lambda m: m.make_segmented_ne(4), "probs", "segments"),
    "ndcg": (lambda m: m.make_ndcg(WINDOW, k=3), "probs", "sessions_only"),
    "gauc": (lambda m: m.make_gauc(WINDOW), "probs", "sessions_only"),
    "session_pr": (lambda m: m.make_session_pr(2, WINDOW), "probs",
                   "sessions"),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factory_matches_jax(name):
    make, kind, extra = FACTORIES[name]
    jc, pc = make(J), make(P)
    assert jc.namespace == pc.namespace and jc.windowed == pc.windowed
    batches = _batches(seed=7, classes=4 if kind == "classes" else None,
                       grid=50 if kind == "grid" else None)
    if jc.windowed:
        jm = JRecMetric(jc, TASKS, WINDOW_BATCHES)
        pm = RecMetric(pc, TASKS, WINDOW_BATCHES)
        js, ps = jm.init(), pm.init(CPU)
        for p, l, w, _ in batches:
            js = jm.update(js, jnp.asarray(p), jnp.asarray(l),
                           jnp.asarray(w))
            ps = pm.update(ps, _t(p), _t(l), _t(w))
        want = {k: float(v) for k, v in jm.compute(js).items()}
        got = {k: float(v) for k, v in pm.compute(ps).items()}
        if name == "hindsight_target_pr":
            # the threshold is an index: exact
            th = [k for k in want if k.endswith("hindsight_target_pr")]
            assert th and all(got[k] == want[k] for k in th)
        _close(got, want)
        return
    js, ps = jc.init(T), pc.init(T, CPU)
    for p, l, w, s in batches:
        if extra is None:
            args = (p, l, w)
        elif extra == "sessions_only":
            args = (p, l, s)
        else:  # segments / sessions ride after the weights
            args = (p, l, w, s)
        js = jc.update(js, *map(jnp.asarray, args))
        ps = pc.update(ps, *map(_t, args))
    for k, v in js.items():  # the raw-example buffers, bit for bit
        if k == "ptr":
            assert int(v) == ps[k]
        elif extra != "segments":
            assert np.array_equal(np.asarray(v), ps[k].numpy()), k
    want = {k: np.asarray(v) for k, v in jc.compute(js).items()}
    got = {k: v.numpy() for k, v in pc.compute(ps).items()}
    _close(got, want)


def test_sort_and_segment_helpers_are_exact():
    """The stable lexsort, the dense segments and the in-session ranks
    against numpy / JAX on keys full of ties."""
    rng = np.random.RandomState(3)
    p = (rng.randint(0, 4, 97) / 4).astype(np.float32)
    s = rng.randint(-1, 9, 97).astype(np.int32)
    want = np.asarray(jnp.lexsort((-jnp.asarray(p), jnp.asarray(s))))
    order = P._lexsort(-_t(p), _t(s))
    assert np.array_equal(order.numpy(), want)
    assert np.array_equal(want, np.lexsort((-p, s)))
    ss = s[want]
    jsid, jstart = J._dense_segments(jnp.asarray(ss))
    sid, start = P._dense_segments(_t(ss))
    assert np.array_equal(sid.numpy(), np.asarray(jsid))
    assert np.array_equal(start.numpy(), np.asarray(jstart))
    seg_start = np.maximum.accumulate(np.where(np.asarray(jstart),
                                               np.arange(97), 0))
    assert np.array_equal(P._rank_in_segment(start).numpy(),
                          np.arange(97) - seg_start)


def test_metric_module_and_offloaded_match_jax():
    """``generate_metric_module`` over every default computation and AUC,
    and the CPU-offloaded module fed the same batches: both within the
    tolerance of the JAX module; a worker error re-raises on the next
    call; TowerQPSMetric leaves its warm-up out."""
    names = sorted(J.DEFAULT_COMPUTATIONS) + ["auc"]
    jcfg = JConfig(tasks=[JTask(t) for t in TASKS], metrics=names,
                   window_batches=WINDOW_BATCHES, auc_window_examples=WINDOW)
    cfg = MetricsConfig(tasks=[RecTaskInfo(t) for t in TASKS],
                        metrics=names, window_batches=WINDOW_BATCHES,
                        auc_window_examples=WINDOW)
    jmod = j_generate(jcfg, B)
    mod = generate_metric_module(cfg, B, device="cpu")
    off = CpuOffloadedMetricModule(cfg, B, queue_size=2)
    for p, l, w, _ in _batches(seed=11):
        jmod.update({t: jnp.asarray(p[i]) for i, t in enumerate(TASKS)},
                    {t: jnp.asarray(l[i]) for i, t in enumerate(TASKS)},
                    {t: jnp.asarray(w[i]) for i, t in enumerate(TASKS)})
        for m in (mod, off):
            pt = {t: _t(p[i]).clone() for i, t in enumerate(TASKS)}
            m.update(pt, {t: _t(l[i]) for i, t in enumerate(TASKS)},
                     {t: _t(w[i]) for i, t in enumerate(TASKS)})
            for v in pt.values():
                v.fill_(0.5)  # the caller reuses its buffers

    def strip(d):
        return {k: v for k, v in d.items() if not k.startswith("throughput")}
    want = strip(jmod.compute())
    _close(strip(mod.compute()), want)
    _close(strip(off.compute()), want)
    off.inner.metrics["ne"] = None  # the worker's next update raises
    off.update({t: torch.zeros(B) for t in TASKS},
               {t: torch.zeros(B) for t in TASKS})
    with pytest.raises(AttributeError):
        off.flush()
    off.close()
    with pytest.raises(RuntimeError):
        off.update({t: torch.zeros(B) for t in TASKS},
                   {t: torch.zeros(B) for t in TASKS})

    q = TowerQPSMetric(batch_size=8, warmup_steps=2)
    for _ in range(5):
        q.update()
    out = q.compute()
    assert out["tower_qps-tower_qps|total_examples"] == 40.0
    assert out["tower_qps-tower_qps|lifetime_qps"] > 0
