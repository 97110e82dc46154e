"""Metric computations (a subset of ``torchrec_tpu/metrics/computations.py``):
NE and log loss, calibration, CTR, and AUC / AUPRC over a window of raw
examples, each with the JAX package's state and arithmetic in float32.

Update functions take ``preds``, ``labels`` and ``weights`` of shape
``[T, B]`` (T tasks) with the weights already defaulted to 1.  The other
computations of the JAX package (MSE, accuracy, NDCG, GAUC, ...) wait for
ROADMAP A12.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from torchrec_tpu_torch.metrics.metrics_namespace import MetricNamespace
from torchrec_tpu_torch.metrics.rec_metric import RecMetricComputation

State = Dict[str, torch.Tensor]
EPS = 1e-12


def _z(n_tasks: int, device: torch.device, *names: str) -> State:
    return {n: torch.zeros((n_tasks,), dtype=torch.float32, device=device)
            for n in names}


def _ce(preds: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    p = preds.clamp(EPS, 1 - EPS)
    return -(labels * torch.log2(p) + (1 - labels) * torch.log2(1 - p))


def _max_eps(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=EPS)


# -- NE / log loss -----------------------------------------------------------


def _ne_init(T, device):
    return _z(T, device, "ce_sum", "w_sum", "pos_sum", "neg_sum")


def _ne_update(st, preds, labels, weights):
    return {
        "ce_sum": st["ce_sum"] + (_ce(preds, labels) * weights).sum(-1),
        "w_sum": st["w_sum"] + weights.sum(-1),
        "pos_sum": st["pos_sum"] + (labels * weights).sum(-1),
        "neg_sum": st["neg_sum"] + ((1 - labels) * weights).sum(-1),
    }


def _ne_compute(st):
    w = _max_eps(st["w_sum"])
    ctr = (st["pos_sum"] / w).clamp(EPS, 1 - EPS)
    baseline = -(ctr * torch.log2(ctr) + (1 - ctr) * torch.log2(1 - ctr))
    ce = st["ce_sum"] / w
    return {"ne": ce / _max_eps(baseline), "logloss": ce}


NE = RecMetricComputation(
    MetricNamespace.NE.value, _ne_init, _ne_update, _ne_compute,
    name_namespaces={"logloss": MetricNamespace.LOG_LOSS.value},
)


# -- calibration -------------------------------------------------------------


def _cal_init(T, device):
    return _z(T, device, "pred_sum", "label_sum")


def _cal_update(st, preds, labels, weights):
    return {
        "pred_sum": st["pred_sum"] + (preds * weights).sum(-1),
        "label_sum": st["label_sum"] + (labels * weights).sum(-1),
    }


def _cal_compute(st):
    return {"calibration": st["pred_sum"] / _max_eps(st["label_sum"])}


CALIBRATION = RecMetricComputation(
    MetricNamespace.CALIBRATION.value, _cal_init, _cal_update, _cal_compute)


# -- CTR -----------------------------------------------------------------------


def _ctr_init(T, device):
    return _z(T, device, "label_sum", "w_sum")


def _ctr_update(st, preds, labels, weights):
    return {
        "label_sum": st["label_sum"] + (labels * weights).sum(-1),
        "w_sum": st["w_sum"] + weights.sum(-1),
    }


def _ctr_compute(st):
    return {"ctr": st["label_sum"] / _max_eps(st["w_sum"])}


CTR = RecMetricComputation(
    MetricNamespace.CTR.value, _ctr_init, _ctr_update, _ctr_compute)


# -- AUC / AUPRC over a ring buffer of raw examples --------------------------


def _make_ring_buffer(window_examples: int,
                      channels: Dict[str, Tuple[torch.dtype, float]]):
    """A ring of the last ``window_examples`` raw examples per task, one
    ``[T, W]`` tensor per channel and a host write pointer.  ``update``
    takes one ``[T, B]`` tensor per channel; a batch as long as the
    window or longer keeps its last ``W`` examples and resets the
    pointer."""

    def init(T, device):
        st = {name: torch.full((T, window_examples), fill, dtype=dt,
                               device=device)
              for name, (dt, fill) in channels.items()}
        st["ptr"] = 0
        return st

    def update(st, *arrays):
        if len(arrays) != len(channels):
            raise ValueError(f"{len(arrays)} arrays for {len(channels)} "
                             "channels")
        B = arrays[0].shape[-1]
        if B >= window_examples:
            out = {name: a[:, -window_examples:].to(dt).clone()
                   for (name, (dt, _)), a in zip(channels.items(), arrays)}
            out["ptr"] = 0
            return out
        dev = arrays[0].device
        idx = (st["ptr"] + torch.arange(B, device=dev)) % window_examples
        out = {}
        for (name, (dt, _)), a in zip(channels.items(), arrays):
            buf = st[name]
            buf[:, idx] = a.to(dt)
            out[name] = buf
        out["ptr"] = (st["ptr"] + B) % window_examples
        return out

    return init, update


_PLW = {
    "preds": (torch.float32, 0.0),
    "labels": (torch.float32, 0.0),
    "weights": (torch.float32, 0.0),
}


def _auc_one(p: torch.Tensor, l: torch.Tensor, w: torch.Tensor):
    """AUC (trapezoidal ROC over the examples in descending score, ties
    in buffer order as JAX's stable argsort leaves them) and AUPRC (step
    interpolation) of one task's window."""
    order = torch.argsort(-p, stable=True)
    ls, ws = l[order], w[order]
    tps = torch.cumsum(ls * ws, 0)
    fps = torch.cumsum((1 - ls) * ws, 0)
    P = _max_eps(tps[-1])
    N = _max_eps(fps[-1])
    tpr = tps / P
    fpr = fps / N
    zero = tpr.new_zeros(1)
    tpr0 = torch.cat([zero, tpr])
    fpr0 = torch.cat([zero, fpr])
    auc = ((fpr0[1:] - fpr0[:-1]) * (tpr0[1:] + tpr0[:-1]) / 2).sum()
    prec = tps / _max_eps(tps + fps)
    auprc = ((tpr0[1:] - tpr0[:-1]) * prec).sum()
    return auc, auprc


def make_auc(window_examples: int = 1 << 16) -> RecMetricComputation:
    """Windowed exact AUC and AUPRC over a ring buffer of raw (pred,
    label, weight) examples (reference auc.py)."""
    init, update = _make_ring_buffer(window_examples, dict(_PLW))

    def compute(st):
        pairs = [_auc_one(p, l, w) for p, l, w in
                 zip(st["preds"], st["labels"], st["weights"])]
        return {"auc": torch.stack([a for a, _ in pairs]),
                "auprc": torch.stack([b for _, b in pairs])}

    return RecMetricComputation(
        MetricNamespace.AUC.value, init, update, compute, windowed=False,
        name_namespaces={"auprc": MetricNamespace.AUPRC.value},
    )


DEFAULT_COMPUTATIONS = {
    MetricNamespace.NE.value: NE,
    MetricNamespace.CALIBRATION.value: CALIBRATION,
    MetricNamespace.CTR.value: CTR,
}
