"""Metric computations (``torchrec_tpu/metrics/computations.py``): the
JAX package's ten ``DEFAULT_COMPUTATIONS`` (NE and log loss, calibration,
CTR, MSE / RMSE / MAE, accuracy / precision / recall / F1, weighted
average, scalar, calibration-free NE, NE-positive, NMSE / NRMSE), AUC /
AUPRC over a window of raw examples, and the factories
``make_{multiclass_recall, ndcg, gauc, segmented_ne, hindsight_target_pr,
recalibrated_ne, rauc, session_pr}``, each with the JAX package's state
and arithmetic in float32, as torch ops on the state's device (the JAX
package computes them with ``jnp``, outside any kernel).

Update functions take ``preds``, ``labels`` and ``weights`` of shape
``[T, B]`` (T tasks) with the weights already defaulted to 1.  Every
sort is stable, as ``jnp.argsort`` and ``jnp.lexsort`` are: tied
predictions keep their buffer order.  A ``jax.ops.segment_*`` is an
``index_add_`` / ``scatter_reduce`` over ``n`` segments.
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


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                 n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(vals, seg, num_segments=n)``."""
    return vals.new_zeros((n,)).index_add_(0, seg, vals)


def _lexsort(*keys: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort(keys)``: the last key primary, each sort stable."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _dense_segments(sorted_keys: torch.Tensor):
    """``[n]`` sorted keys -> (``[n]`` dense 0-based segment indices, the
    segment starts)."""
    start = torch.cat([torch.ones((1,), dtype=torch.bool,
                                  device=sorted_keys.device),
                       sorted_keys[1:] != sorted_keys[:-1]])
    return torch.cumsum(start, 0) - 1, start


def _rank_in_segment(start: torch.Tensor) -> torch.Tensor:
    """0-based position of each element within its segment."""
    pos = torch.arange(start.shape[0], device=start.device)
    seg_start = torch.cummax(torch.where(start, pos, 0), 0).values
    return pos - seg_start


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


# -- MSE / RMSE / MAE ----------------------------------------------------------


def _mse_init(T, device):
    return _z(T, device, "se_sum", "ae_sum", "w_sum")


def _mse_update(st, preds, labels, weights):
    err = preds - labels
    return {
        "se_sum": st["se_sum"] + (err * err * weights).sum(-1),
        "ae_sum": st["ae_sum"] + (err.abs() * weights).sum(-1),
        "w_sum": st["w_sum"] + weights.sum(-1),
    }


def _mse_compute(st):
    w = _max_eps(st["w_sum"])
    mse = st["se_sum"] / w
    return {"mse": mse, "rmse": torch.sqrt(mse), "mae": st["ae_sum"] / w}


MSE = RecMetricComputation(
    MetricNamespace.MSE.value, _mse_init, _mse_update, _mse_compute,
    name_namespaces={"rmse": MetricNamespace.RMSE.value,
                     "mae": MetricNamespace.MAE.value},
)


# -- accuracy / precision / recall / F1 (threshold 0.5) ---------------------


def _acc_init(T, device):
    return _z(T, device, "tp", "fp", "tn", "fn")


def _acc_update(st, preds, labels, weights):
    hard = (preds >= 0.5).to(preds.dtype)
    pos = labels
    return {
        "tp": st["tp"] + (hard * pos * weights).sum(-1),
        "fp": st["fp"] + (hard * (1 - pos) * weights).sum(-1),
        "tn": st["tn"] + ((1 - hard) * (1 - pos) * weights).sum(-1),
        "fn": st["fn"] + ((1 - hard) * pos * weights).sum(-1),
    }


def _acc_compute(st):
    tp, fp, tn, fn = st["tp"], st["fp"], st["tn"], st["fn"]
    precision = tp / _max_eps(tp + fp)
    recall = tp / _max_eps(tp + fn)
    return {
        "accuracy": (tp + tn) / _max_eps(tp + fp + tn + fn),
        "precision": precision,
        "recall": recall,
        "f1": 2 * precision * recall / _max_eps(precision + recall),
    }


ACCURACY = RecMetricComputation(
    MetricNamespace.ACCURACY.value, _acc_init, _acc_update, _acc_compute,
    name_namespaces={"precision": MetricNamespace.PRECISION.value,
                     "recall": MetricNamespace.RECALL.value,
                     "f1": MetricNamespace.F1.value},
)


# -- weighted average of the predictions -------------------------------------


def _wavg_init(T, device):
    return _z(T, device, "pred_sum", "w_sum")


def _wavg_update(st, preds, labels, weights):
    return {
        "pred_sum": st["pred_sum"] + (preds * weights).sum(-1),
        "w_sum": st["w_sum"] + weights.sum(-1),
    }


def _wavg_compute(st):
    return {"weighted_avg": st["pred_sum"] / _max_eps(st["w_sum"])}


WEIGHTED_AVG = RecMetricComputation(
    MetricNamespace.WEIGHTED_AVG.value, _wavg_init, _wavg_update,
    _wavg_compute)


# -- scalar: an external value riding the ``preds`` channel ------------------


def _scalar_init(T, device):
    return _z(T, device, "value_sum", "count")


def _scalar_update(st, preds, labels, weights):
    return {
        "value_sum": st["value_sum"] + (preds * weights).sum(-1),
        "count": st["count"] + weights.sum(-1),
    }


def _scalar_compute(st):
    return {"scalar": st["value_sum"] / _max_eps(st["count"])}


SCALAR = RecMetricComputation(
    MetricNamespace.SCALAR.value, _scalar_init, _scalar_update,
    _scalar_compute)


# -- calibration-free NE -------------------------------------------------------


def _cfne_init(T, device):
    return _z(T, device, "ce_sum", "w_sum", "pos_sum", "pred_sum")


def _cfne_update(st, preds, labels, weights):
    return {
        "ce_sum": st["ce_sum"] + (_ce(preds, labels) * weights).sum(-1),
        "w_sum": st["w_sum"] + weights.sum(-1),
        "pos_sum": st["pos_sum"] + (labels * weights).sum(-1),
        "pred_sum": st["pred_sum"] + (preds * weights).sum(-1),
    }


def _cfne_compute(st):
    # NE with the baseline entropy at the mean prediction (both sides
    # sums, so the value does not depend on the sample size; the JAX
    # package's deliberate departure from the reference's formula)
    mean_pred = (st["pred_sum"] / _max_eps(st["w_sum"])).clamp(EPS, 1 - EPS)
    pred_norm = -(st["pos_sum"] * torch.log2(mean_pred)
                  + (st["w_sum"] - st["pos_sum"]) * torch.log2(1 - mean_pred))
    return {"cali_free_ne": st["ce_sum"] / _max_eps(pred_norm)}


CALI_FREE_NE = RecMetricComputation(
    MetricNamespace.CALI_FREE_NE.value, _cfne_init, _cfne_update,
    _cfne_compute)


# -- NE of the positives -------------------------------------------------------


def _nep_init(T, device):
    return _z(T, device, "ce_pos_sum", "w_sum", "pos_sum", "neg_sum")


def _nep_update(st, preds, labels, weights):
    p = preds.clamp(EPS, 1 - EPS)
    return {
        "ce_pos_sum": st["ce_pos_sum"]
        + (-weights * labels * torch.log2(p)).sum(-1),
        "w_sum": st["w_sum"] + weights.sum(-1),
        "pos_sum": st["pos_sum"] + (labels * weights).sum(-1),
        "neg_sum": st["neg_sum"] + ((1 - labels) * weights).sum(-1),
    }


def _nep_compute(st):
    w = _max_eps(st["w_sum"])
    mean_label = (st["pos_sum"] / w).clamp(EPS, 1 - EPS)
    ce_norm = -(st["pos_sum"] * torch.log2(mean_label)
                + st["neg_sum"] * torch.log2(1 - mean_label))
    return {"ne_positive": st["ce_pos_sum"] / _max_eps(ce_norm)}


NE_POSITIVE = RecMetricComputation(
    MetricNamespace.NE_POSITIVE.value, _nep_init, _nep_update, _nep_compute)


# -- NMSE / NRMSE: MSE over the all-ones predictor's -------------------------


def _nmse_init(T, device):
    return _z(T, device, "se_sum", "const_se_sum", "w_sum")


def _nmse_update(st, preds, labels, weights):
    return {
        "se_sum": st["se_sum"] + (weights * (labels - preds) ** 2).sum(-1),
        "const_se_sum": st["const_se_sum"]
        + (weights * (labels - 1.0) ** 2).sum(-1),
        "w_sum": st["w_sum"] + weights.sum(-1),
    }


def _nmse_compute(st):
    w = _max_eps(st["w_sum"])
    mse = st["se_sum"] / w
    const_mse = st["const_se_sum"] / w
    zero = const_mse == 0
    nmse = torch.where(zero, 0.0, mse / _max_eps(const_mse))
    nrmse = torch.where(zero, 0.0,
                        torch.sqrt(mse) / _max_eps(torch.sqrt(const_mse)))
    return {"nmse": nmse, "nrmse": nrmse}


NMSE = RecMetricComputation(
    MetricNamespace.NMSE.value, _nmse_init, _nmse_update, _nmse_compute,
    name_namespaces={"nrmse": MetricNamespace.NRMSE.value},
)


DEFAULT_COMPUTATIONS = {
    MetricNamespace.NE.value: NE,
    MetricNamespace.CALIBRATION.value: CALIBRATION,
    MetricNamespace.CTR.value: CTR,
    MetricNamespace.MSE.value: MSE,
    MetricNamespace.ACCURACY.value: ACCURACY,
    MetricNamespace.WEIGHTED_AVG.value: WEIGHTED_AVG,
    MetricNamespace.SCALAR.value: SCALAR,
    MetricNamespace.CALI_FREE_NE.value: CALI_FREE_NE,
    MetricNamespace.NE_POSITIVE.value: NE_POSITIVE,
    MetricNamespace.NMSE.value: NMSE,
}


# -- multiclass recall -----------------------------------------------------------


def make_multiclass_recall(n_classes: int) -> RecMetricComputation:
    """Mean per-class recall over ``n_classes``: ``preds`` are the
    predicted class ids and ``labels`` the true ones (as floats, cut to
    int32).  A negative class id counts from the end and one past the
    classes is dropped, as the JAX package's ``.at[].add(mode="drop")``
    does."""
    C = int(n_classes)

    def init(T, device):
        return {"tp": torch.zeros((T, C), dtype=torch.float32, device=device),
                "support": torch.zeros((T, C), dtype=torch.float32,
                                       device=device)}

    def update(st, preds, labels, weights):
        pred_cls = preds.to(torch.int32)
        true_cls = labels.to(torch.int32)
        hit = (pred_cls == true_cls).to(torch.float32) * weights
        idx = torch.where(true_cls < 0, true_cls + C, true_cls).long()
        keep = (idx >= 0) & (idx < C)
        tp, support = st["tp"].clone(), st["support"].clone()
        for t in range(tp.shape[0]):
            k = keep[t]
            tp[t].index_add_(0, idx[t][k], hit[t][k])
            support[t].index_add_(0, idx[t][k], weights[t][k])
        return {"tp": tp, "support": support}

    def compute(st):
        recall = st["tp"] / _max_eps(st["support"])
        return {"multiclass_recall": recall.mean(-1)}

    return RecMetricComputation(
        MetricNamespace.MULTICLASS_RECALL.value, init, update, compute)


# -- NDCG and GAUC: ranked within sessions ---------------------------------------
#
# Both keep a window of raw (pred, label, session) examples; used
# standalone: update(state, preds, labels, sessions), compute(state).
# Session ids may be any int32 (-1 is an empty slot); compute densifies.


def _make_session_buffer(window_examples: int):
    return _make_ring_buffer(window_examples, {
        "preds": (torch.float32, 0.0),
        "labels": (torch.float32, 0.0),
        "sessions": (torch.int32, -1),
    })


def make_ndcg(window_examples: int = 1 << 14,
              k: int = 10) -> RecMetricComputation:
    """Session-grouped NDCG@k over a window of examples, the mean over
    sessions (reference ndcg.py)."""
    init, update = _make_session_buffer(window_examples)

    def one(p, l, s):
        n = p.shape[0]
        order = _lexsort(-p, s)  # by session, then descending pred
        ss, ls = s[order], l[order]
        sid, start = _dense_segments(ss)
        rank = _rank_in_segment(start)
        valid = (ss >= 0) & (rank < k)
        disc = torch.log2(rank + 2.0)
        gain = (torch.pow(2.0, ls) - 1) / disc
        # the ideal order: labels descending within each session (the
        # same session boundaries)
        li = l[_lexsort(-l, s)]
        igain = (torch.pow(2.0, li) - 1) / disc
        dcg = _segment_sum(torch.where(valid, gain, 0.0), sid, n)
        idcg = _segment_sum(torch.where(valid, igain, 0.0), sid, n)
        seg_max = torch.full((n,), float("-inf"), device=p.device)
        seg_max = seg_max.scatter_reduce(
            0, sid, torch.where(ss >= 0, 1.0, 0.0), "amax")
        # an empty segment's -inf counts as no session (JAX's
        # ``segment_max * (idcg > EPS)`` compiles to this select)
        sess_valid = torch.where(idcg > EPS, seg_max, 0.0)
        per_session = torch.where(sess_valid > 0, dcg / _max_eps(idcg), 0.0)
        return per_session.sum() / torch.clamp(sess_valid.sum(), min=1.0)

    def compute(st):
        return {"ndcg": torch.stack([
            one(p, l, s) for p, l, s in
            zip(st["preds"], st["labels"], st["sessions"])])}

    return RecMetricComputation(
        MetricNamespace.NDCG.value, init, update, compute, windowed=False)


def make_gauc(window_examples: int = 1 << 14) -> RecMetricComputation:
    """Grouped AUC: the tie-averaged Mann-Whitney AUC of each session,
    averaged over the sessions holding both classes (reference
    gauc.py)."""
    init, update = _make_session_buffer(window_examples)

    def one(p, l, s):
        n = p.shape[0]
        order = _lexsort(p, s)
        ss, ls, ps = s[order], l[order], p[order]
        sid, start = _dense_segments(ss)
        rank = _rank_in_segment(start).to(torch.float32) + 1.0  # 1-based
        # equal (session, pred) runs share their mean rank
        run_start = start | torch.cat([
            torch.ones((1,), dtype=torch.bool, device=p.device),
            ps[1:] != ps[:-1]])
        rid = torch.cumsum(run_start, 0) - 1
        run_sum = _segment_sum(rank, rid, n)
        run_cnt = _segment_sum(torch.ones_like(rank), rid, n)
        rank_avg = (run_sum / torch.clamp(run_cnt, min=1.0))[rid]
        valid = ss >= 0
        pos_rank_sum = _segment_sum(
            torch.where(valid & (ls > 0), rank_avg, 0.0), sid, n)
        n_pos = _segment_sum(torch.where(valid, ls, 0.0), sid, n)
        n_tot = _segment_sum(torch.where(valid, 1.0, 0.0), sid, n)
        n_neg = n_tot - n_pos
        u = pos_rank_sum - n_pos * (n_pos + 1) / 2
        auc = u / _max_eps(n_pos * n_neg)
        has_both = (n_pos > 0) & (n_neg > 0)
        return (torch.where(has_both, auc, 0.0).sum()
                / torch.clamp(has_both.sum(), min=1))

    def compute(st):
        return {"gauc": torch.stack([
            one(p, l, s) for p, l, s in
            zip(st["preds"], st["labels"], st["sessions"])])}

    return RecMetricComputation(
        MetricNamespace.GAUC.value, init, update, compute, windowed=False)


# -- segmented NE -------------------------------------------------------------------


def make_segmented_ne(num_segments: int) -> RecMetricComputation:
    """NE per segment (e.g. a user cohort): additive sums per (task,
    segment).  Used standalone: update(state, preds, labels, weights,
    segments) with integer segment ids, clipped into
    ``[0, num_segments)``."""
    S = int(num_segments)

    def init(T, device):
        return {n: torch.zeros((T, S), dtype=torch.float32, device=device)
                for n in ("ce_sum", "w_sum", "pos_sum")}

    def update(st, preds, labels, weights, segments):
        seg = segments.to(torch.int32).clamp(0, S - 1).long()
        ce = _ce(preds, labels) * weights
        pl = labels * weights
        out = {k: v.clone() for k, v in st.items()}
        for t in range(preds.shape[0]):
            out["ce_sum"][t] += _segment_sum(ce[t], seg[t], S)
            out["w_sum"][t] += _segment_sum(weights[t], seg[t], S)
            out["pos_sum"][t] += _segment_sum(pl[t], seg[t], S)
        return out

    def compute(st):
        w = _max_eps(st["w_sum"])
        ctr = (st["pos_sum"] / w).clamp(EPS, 1 - EPS)
        baseline = -(ctr * torch.log2(ctr) + (1 - ctr) * torch.log2(1 - ctr))
        ne = (st["ce_sum"] / w) / _max_eps(baseline)
        return {f"segmented_ne_{k}": ne[:, k] for k in range(S)}

    return RecMetricComputation("segmented_ne", init, update, compute,
                                windowed=False)


# -- hindsight target precision / recall ------------------------------------------


def make_hindsight_target_pr(target_precision: float = 0.5,
                             granularity: int = 1000
                             ) -> RecMetricComputation:
    """Weighted TP / FP / FN at ``granularity`` thresholds ``i / (K - 1)``
    on [0, 1], from a histogram over buckets and a suffix sum (reference
    hindsight_target_pr.py:115); compute reports the first threshold
    whose precision reaches the target (its value on [0, 1]) and the
    precision and recall there.  A positive exactly on a threshold
    counts in TP (``pred >= t``) and in FN (``pred <= t``), as the
    reference's comparisons do: ``tie`` holds that weight."""
    K = int(granularity)

    def init(T, device):
        z = torch.zeros((T, K), dtype=torch.float32, device=device)
        return {"tp": z, "fp": z.clone(), "tie": z.clone(),
                "pos_total": torch.zeros((T,), dtype=torch.float32,
                                         device=device)}

    def update(st, preds, labels, weights):
        # pred >= i / (K - 1)  <=>  floor(pred * (K - 1)) >= i
        scaled = preds * (K - 1)
        fl = torch.floor(scaled)
        bucket = fl.to(torch.int32).clamp(0, K - 1).long()
        on_grid = (scaled == fl).to(preds.dtype)

        def hist(vals):  # [T, B] -> [T, K]
            return torch.stack([_segment_sum(v, b, K)
                                for v, b in zip(vals, bucket)])

        def suffix(h):  # entry i: the sum of the buckets >= i
            return torch.flip(torch.cumsum(torch.flip(h, [1]), 1), [1])

        return {
            "tp": st["tp"] + suffix(hist(weights * labels)),
            "fp": st["fp"] + suffix(hist(weights * (1 - labels))),
            "tie": st["tie"] + hist(weights * labels * on_grid),
            "pos_total": st["pos_total"] + (weights * labels).sum(-1),
        }

    def compute(st):
        tp, fp = st["tp"], st["fp"]
        fn = st["pos_total"][:, None] - tp + st["tie"]
        prec = torch.where(tp + fp == 0, 0.0, tp / _max_eps(tp + fp))
        rec = torch.where(tp + fn == 0, 0.0, tp / _max_eps(tp + fn))
        ok = prec >= target_precision
        idx = torch.where(ok.any(1), ok.to(torch.int8).argmax(1), K - 1)

        def take(a):
            return torch.gather(a, 1, idx[:, None])[:, 0]

        return {
            "hindsight_target_pr": idx.to(torch.float32) / (K - 1),
            "hindsight_target_precision": take(prec),
            "hindsight_target_recall": take(rec),
        }

    return RecMetricComputation(MetricNamespace.HINDSIGHT_TARGET_PR.value,
                                init, update, compute)


# -- recalibrated NE ------------------------------------------------------------------


def make_recalibrated_ne(recalibration_coefficient: float
                         ) -> RecMetricComputation:
    """NE of the predictions recalibrated for negative downsampling at
    rate ``w``, ``p' = p / (p + (1 - p) / w)``, the serving-time
    distribution."""
    w = float(recalibration_coefficient)

    def update(st, preds, labels, weights):
        p = preds.clamp(EPS, 1 - EPS)
        p = p / (p + (1.0 - p) / w)
        return _ne_update(st, p, labels, weights)

    def compute(st):
        out = _ne_compute(st)
        return {"recalibrated_ne": out["ne"],
                "recalibrated_logloss": out["logloss"]}

    return RecMetricComputation("recalibrated_ne", _ne_init, update, compute)


# -- RAUC (regression AUC) ---------------------------------------------------------------


def make_rauc(window_examples: int = 2048) -> RecMetricComputation:
    """1 - the share of inverted pairs (label order against prediction
    order) over a window of examples with a positive weight (reference
    rauc.py:211); pairwise ``O(W^2)`` at compute time."""
    init, update = _make_ring_buffer(window_examples, dict(_PLW))

    def one(p, l, w):
        valid = w > 0
        # invalid examples sort last; a pair needs both valid
        order = torch.argsort(torch.where(valid, l, float("inf")),
                              stable=True)
        ps, vs = p[order], valid[order]
        i = torch.arange(ps.shape[0], device=p.device)
        upper = i[None, :] > i[:, None]
        both = vs[:, None] & vs[None, :]
        inv = (upper & both & (ps[:, None] > ps[None, :])).sum()
        cnt = vs.sum().to(torch.float32)
        pairs = torch.clamp(cnt * (cnt - 1) / 2, min=1.0)
        return 1.0 - inv.to(torch.float32) / pairs

    def compute(st):
        return {"rauc": torch.stack([
            one(p, l, w) for p, l, w in
            zip(st["preds"], st["labels"], st["weights"])])}

    return RecMetricComputation(
        MetricNamespace.RAUC.value, init, update, compute, windowed=False)


# -- session precision / recall: predicted positive = top-k in its session -------


def make_session_pr(top_k: int, window_examples: int = 1 << 14
                    ) -> RecMetricComputation:
    """Used standalone: update(state, preds, labels, weights, sessions);
    compute -> {precision_session, recall_session}."""
    init, update = _make_ring_buffer(
        window_examples, {**_PLW, "sessions": (torch.int32, -1)})
    big = torch.iinfo(torch.int32).max

    def one(p, l, w, s):
        valid = s >= 0
        order = _lexsort(-p, torch.where(valid, s, big))
        ss, ls, ws, vs = s[order], l[order], w[order], valid[order]
        _, start = _dense_segments(ss)
        rank = _rank_in_segment(start)
        pred_pos = vs & (rank < top_k)
        pos = vs & (ls > 0)
        tp = torch.where(pred_pos & pos, ws, 0.0).sum()
        fp = torch.where(pred_pos & ~pos, ws, 0.0).sum()
        fn = torch.where(~pred_pos & pos, ws, 0.0).sum()
        return tp / _max_eps(tp + fp), tp / _max_eps(tp + fn)

    def compute(st):
        pairs = [one(p, l, w, s) for p, l, w, s in zip(
            st["preds"], st["labels"], st["weights"], st["sessions"])]
        return {"precision_session": torch.stack([a for a, _ in pairs]),
                "recall_session": torch.stack([b for _, b in pairs])}

    return RecMetricComputation(
        MetricNamespace.PRECISION_SESSION.value, init, update, compute,
        windowed=False,
        name_namespaces={
            "recall_session": MetricNamespace.RECALL_SESSION.value},
    )
