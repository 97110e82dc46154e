"""Port parity for ``metrics/``: NE and log loss, calibration, CTR and
AUC / AUPRC of the port's ``RecMetricModule`` against the JAX package's
on the same batches (numpy from a seed), two tasks, weighted batches,
tied predictions, a window that wraps and a batch as long as the window.

Tolerance ``rtol = atol = 1e-6``: both sum in float32, XLA and PyTorch in
different orders (the Kahan-compensated lifetime sums, the window's sum
and AUC's cumulative sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.metrics import MetricsConfig as JConfig
from torchrec_tpu.metrics import RecMetricModule as JModule
from torchrec_tpu.metrics import RecTaskInfo as JTask
from torchrec_tpu_torch.metrics import (
    MetricsConfig,
    RecMetricModule,
    RecTaskInfo,
)

TASKS = ("ctr", "cvr")
METRICS = ("ne", "calibration", "ctr", "auc")
WINDOW = 64  # AUC window examples


def _batches(seed, sizes, ties):
    rng = np.random.RandomState(seed)
    out = []
    for b in sizes:
        preds, labels, weights = {}, {}, {}
        for t in TASKS:
            p = rng.rand(b).astype(np.float32)
            if ties:  # a fresh model's scores: few distinct values
                p = np.round(p * 4) / 4
                p = np.clip(p, 0.05, 0.95).astype(np.float32)
            preds[t] = p
            labels[t] = (rng.rand(b) < 0.3).astype(np.float32)
            weights[t] = rng.choice([0.0, 0.5, 1.0, 2.0], size=b).astype(
                np.float32)
        out.append((preds, labels, weights))
    return out


def _run(module, batches, to, weighted):
    for preds, labels, weights in batches:
        module.update({t: to(v) for t, v in preds.items()},
                      {t: to(v) for t, v in labels.items()},
                      {t: to(v) for t, v in weights.items()}
                      if weighted else None)
    return {k: v for k, v in module.compute().items()
            if not k.startswith("throughput")}


@pytest.mark.parametrize("case", [
    # (sizes of the batches, tied predictions, weighted)
    ("wrap", (24, 24, 24, 10, 30), False, True),
    ("ties", (20, 20, 20, 20), True, True),
    ("whole_window", (40, 100, 7), True, False),
    ("window_batches", (16,) * 7, False, True),
], ids=lambda c: c[0])
def test_rec_metric_module_matches_jax(case):
    _, sizes, ties, weighted = case
    batches = _batches(len(sizes), sizes, ties)
    jmod = JModule(JConfig(tasks=[JTask(t) for t in TASKS], metrics=METRICS,
                           window_batches=3, auc_window_examples=WINDOW),
                   batch_size=sizes[0])
    tmod = RecMetricModule(MetricsConfig(
        tasks=[RecTaskInfo(t) for t in TASKS], metrics=METRICS,
        window_batches=3, auc_window_examples=WINDOW),
        batch_size=sizes[0], device="cpu")
    want = _run(jmod, batches, jnp.asarray, weighted)
    got = _run(tmod, batches, torch.from_numpy, weighted)
    assert sorted(got) == sorted(want)
    assert any("auc" in k for k in got) and any("window_ne" in k
                                                for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_update_from_model_out_reads_the_tasks_columns():
    """A flat model-output dict, columns named by each task's
    ``prediction_name`` / ``label_name`` / ``weight_name``, updates the
    module as the per-task dicts do."""
    tasks = [RecTaskInfo("ctr", "click", "p_click", "w"),
             RecTaskInfo("cvr", "conv", "p_conv", "w")]
    (preds, labels, weights), = _batches(0, (32,), False)
    flat = {"p_click": preds["ctr"], "p_conv": preds["cvr"],
            "click": labels["ctr"], "conv": labels["cvr"],
            "w": weights["ctr"]}
    a = RecMetricModule(MetricsConfig(tasks=tasks, metrics=METRICS),
                        batch_size=32, device="cpu")
    a.update_from_model_out({k: torch.from_numpy(v) for k, v in flat.items()})
    b = RecMetricModule(MetricsConfig(tasks=tasks, metrics=METRICS),
                        batch_size=32, device="cpu")
    b.update({t: torch.from_numpy(preds[t]) for t in TASKS},
             {t: torch.from_numpy(labels[t]) for t in TASKS},
             {t: torch.from_numpy(weights["ctr"]) for t in TASKS})
    ga, gb = a.compute(), b.compute()
    assert {k: v for k, v in ga.items() if "throughput" not in k} == {
        k: v for k, v in gb.items() if "throughput" not in k}


def test_auc_ties_follow_buffer_order():
    """All scores tied: the stable descending sort keeps buffer order, so
    AUC is the trapezoid over that order (0.5 here), not a sort's
    accident."""
    tmod = RecMetricModule(MetricsConfig(tasks=[RecTaskInfo("ctr")],
                                         metrics=("auc",),
                                         auc_window_examples=8),
                           batch_size=8, device="cpu")
    tmod.update({"ctr": torch.full((8,), 0.5)},
                {"ctr": torch.tensor([1., 0., 1., 0., 0., 1., 0., 1.])})
    jmod = JModule(JConfig(tasks=[JTask("ctr")], metrics=("auc",),
                           auc_window_examples=8), batch_size=8)
    jmod.update({"ctr": jnp.full((8,), 0.5)},
                {"ctr": jnp.asarray([1., 0., 1., 0., 0., 1., 0., 1.])})
    key = "auc-ctr|lifetime_auc"
    assert tmod.compute()[key] == pytest.approx(jmod.compute()[key],
                                                abs=1e-7)
    assert tmod.compute()[key] == pytest.approx(0.5, abs=1e-7)
