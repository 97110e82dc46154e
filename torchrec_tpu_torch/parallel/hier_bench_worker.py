"""The two-level sparse-comms A/B worker
(``torchrec_tpu/parallel/hier_bench_worker.py``): the port's two-level
ICI/DCN dists (``parallel/sharding/hier.py``) against the flat dists.

``python -m torchrec_tpu_torch.parallel.hier_bench_worker [--smoke]
[--slices 2] [--device cuda|cpu] [--out F]`` launches
``RANKS_PER_SLICE`` gloo processes a slice through
``parallel/multiprocess.launch``, a two-level world
(``ShardingEnv.from_process_group(num_slices=...)``); every rank runs
:func:`rank_main`, and rank 0's result is printed as ``RESULT {json}``.

The A/B: the same Zipf id stream through (a) the flat dedup'd row-wise
dist with an fp32 wire, (b) the flat dist under int8 qcomms (one step,
for its ledger), (c) the two-level dist with an fp32 DCN leg and (d) the
two-level dist with an int8 DCN leg.  Wire bytes are the first step's
``wire_accounting`` ledger (static shapes: the same bytes every step);
capacities come from the measured stream (:func:`measure_stream`) with
no room for an overflow (``dedup_overflow`` would show one).  The
contracts (:func:`contracts_hold`; the exit code): step 1's outputs
bitwise flat = two-level with an fp32 DCN leg, the later steps within
rtol 1e-5 / atol 1e-6 (the two backwards sum duplicates in other
orders), step 1 of the int8 leg within the qcomm int8 tolerance, and no
overflow.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import numpy as np

ZIPF_A = 1.2
RANKS_PER_SLICE = 2


def _zipf_ids(rng, rows: int, row_perm, size: int):
    """Ranked Zipf over [0, rows): p(rank k) ~ 1 / (k + 1)^a, the hot ranks
    scattered over the rows by a fixed permutation."""
    p = 1.0 / np.power(np.arange(1, rows + 1, dtype=np.float64), ZIPF_A)
    p /= p.sum()
    return row_perm[rng.choice(rows, size=size, p=p)].astype(np.int64)


def measure_stream(kjts_per_step, rows, n_feats, S, L, cap):
    """The dispatch geometry over the whole stream, on the host: the most
    distinct ids one (rank, feature, destination rank) sends sizes the
    source dedup capacity (flat and two-level stage 1), the largest
    (source slice, destination local rank, destination slice) union sizes
    the DCN capacity.  Returns (the flat dedup factor, the two-level
    factor, the mean slice-level duplication = aggregated slots / union
    distinct)."""
    N = S * L
    block = -(-rows // N)
    max_bucket = 1
    max_union = 1
    slice_dups = []
    for kjts in kjts_per_step:
        for s in range(S):
            union = {}  # (local dest, dest slice) -> stack rows
            agg_slots = {}
            for l_src in range(L):
                vals = np.asarray(kjts[s * L + l_src].values()).reshape(
                    n_feats, -1)
                for fi in range(n_feats):
                    dest = vals[fi] // block
                    stack_rows = fi * block + vals[fi] % block
                    for d in np.unique(dest):
                        rows_d = stack_rows[dest == d]
                        distinct = len(np.unique(rows_d))
                        max_bucket = max(max_bucket, distinct)
                        key = (int(d) % L, int(d) // L)
                        union.setdefault(key, set()).update(rows_d.tolist())
                        agg_slots[key] = agg_slots.get(key, 0) + distinct
            for key, u in union.items():
                max_union = max(max_union, len(u))
                slice_dups.append(agg_slots[key] / max(1, len(u)))
    flat_factor = max(1.0, cap / max_bucket)
    # the stage-1 send cap after source dedup, build_rw_layout's formula
    c1 = max(1, min(min(cap, block), int(np.ceil(cap / flat_factor))))
    hier_factor = max(1.0, (L * n_feats * c1) / max_union)
    return flat_factor, hier_factor, float(
        sum(slice_dups) / max(1, len(slice_dups)))


def contracts_hold(result: Dict) -> bool:
    """The worker's acceptance: bitwise at step 1 with an fp32 DCN leg,
    close later, the int8 leg within its tolerance, nothing dropped."""
    return bool(result["bit_exact_fp32_dcn"] and result["later_steps_close"]
                and result["int8_within_tol"]
                and result["overflow_flat"] == 0
                and result["overflow_hier"] == 0)


def rank_main(smoke: bool, num_slices: int, device_type: str) -> Dict:
    """One rank of the A/B (run by ``multiprocess.launch``): joins gloo as
    a two-level world of ``num_slices`` slices on ``device_type`` (every
    rank on the first card for ``"cuda"``) and returns :func:`run`'s
    result."""
    import torch

    from torchrec_tpu_torch.parallel import multiprocess
    from torchrec_tpu_torch.parallel.comm import ShardingEnv

    if device_type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device_type)
        torch.set_num_threads(1)  # the ranks share the host's cores
    multiprocess.initialize("gloo")
    return run(ShardingEnv.from_process_group("gloo", device=dev,
                                              num_slices=num_slices), smoke)


def run(env, smoke: bool, keep: Optional[Dict] = None) -> Dict:
    """The four arms on this rank of the two-level world ``env`` (every
    rank calls it; every rank returns the same result, the outputs
    gathered).  With ``keep``, the two-level fp32 arm's collection, its
    trained state, the optimizer config and this rank's first batch are
    left in it (``ebc``, ``params``, ``fused``, ``cfg``, ``batch``): a
    caller's check of the kernels at the worker's shapes."""
    import torch

    from torchrec_tpu_torch.modules.embedding_configs import (
        EmbeddingBagConfig,
        PoolingType,
    )
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        FusedOptimConfig,
    )
    from torchrec_tpu_torch.parallel.comm import all_gather
    from torchrec_tpu_torch.parallel.embeddingbag import (
        ShardedEmbeddingBagCollection,
    )
    from torchrec_tpu_torch.parallel.qcomm import (
        LINK_DCN,
        LINK_ICI,
        CommType,
        QCommsConfig,
        wire_accounting,
    )
    from torchrec_tpu_torch.parallel.sharding.hier import HierTopology
    from torchrec_tpu_torch.parallel.types import (
        ParameterSharding,
        ShardingType,
    )
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    dev = env.device
    N, r = env.world_size, env.rank
    S = env.num_slices
    L = N // S

    if smoke:
        R, D, F, B, IDS, steps = 4096, 32, 2, 4, 4, 2
    else:
        R, D, F, B, IDS, steps = 32768, 64, 4, 16, 4, 4
    CAP = B * IDS
    keys = [f"c{i}" for i in range(F)]
    tables = [EmbeddingBagConfig(num_embeddings=R, embedding_dim=D,
                                 name=f"t_{k}", feature_names=[k],
                                 pooling=PoolingType.SUM) for k in keys]
    cfg = FusedOptimConfig(optim=EmbOptimType.ROWWISE_ADAGRAD,
                           learning_rate=0.05)

    # the global stream, built the same on every rank
    rng = np.random.RandomState(7)
    row_perm = rng.permutation(R)

    def make_kjt(step_rng):
        vals = np.concatenate([_zipf_ids(step_rng, R, row_perm, B * IDS)
                               for _ in keys])
        lengths = np.full((F * B,), IDS, np.int64)
        return KeyedJaggedTensor.from_lengths_packed(keys, vals, lengths,
                                                     caps=[CAP] * F)

    kjts_per_step = [
        [make_kjt(np.random.RandomState(1000 + 97 * t + d))
         for d in range(N)] for t in range(steps)]
    flat_factor, hier_factor, slice_dup = measure_stream(
        kjts_per_step, R, F, S, L, CAP)
    mine = [kjts[r].to(dev) for kjts in kjts_per_step]
    rngw = np.random.RandomState(0)
    weights = {t.name: (rngw.randn(R, D) * 0.1).astype(np.float32)
               for t in tables}

    def build(hier: bool, qc):
        plan = {t.name: ParameterSharding(
            ShardingType.ROW_WISE, ranks=list(range(N)), dedup=True,
            dedup_factor=flat_factor, hier=hier, hier_factor=hier_factor)
            for t in tables}
        ebc = ShardedEmbeddingBagCollection.build(
            tables, plan, N, B, {k: CAP for k in keys}, qcomms=qc,
            hier_topo=HierTopology(S, L))
        params = ebc.params_from_tables(weights, device=dev, rank=r)
        return ebc, params, ebc.init_fused_state(cfg, device=dev)

    def step(ebc, params, fused, kjt):
        outs, ctxs = ebc.forward_local(params, kjt, env=env)
        kt = torch.cat([outs[k] for k in keys], dim=-1)  # [B, F * D]
        ebc.backward_and_update_local(
            params, fused, ctxs, {f: 2.0 * o for f, o in outs.items()},
            cfg, env=env)
        ov = ebc.dedup_overflow(ctxs)
        return kt, (torch.zeros((), dtype=torch.int32, device=dev)
                    if ov is None else ov)

    def run_arm(hier: bool, qc, n_steps: int):
        ebc, params, fused = build(hier, qc)
        outs: List[np.ndarray] = []
        overflow = 0
        led: Dict[str, float] = {}
        for i in range(n_steps):
            with wire_accounting() as ledger:
                kt, ov = step(ebc, params, fused, mine[i % len(mine)])
            if i == 0:
                led = dict(ledger)
            outs.append(all_gather(kt, env).cpu().numpy())
            overflow += int(all_gather(ov.reshape(1), env).sum())
        if keep is not None and hier and qc is None:
            keep.update(ebc=ebc, params=params, fused=fused, cfg=cfg,
                        batch=mine[0])
        return led, outs, overflow

    led_flat, outs_flat, ov_flat = run_arm(False, None, steps)
    led_flat8, _, _ = run_arm(False, QCommsConfig(CommType.INT8,
                                                  CommType.INT8), 1)
    led_hier, outs_hier, ov_hier = run_arm(True, None, steps)
    led_hier8, outs_hier8, ov_hier8 = run_arm(
        True, QCommsConfig(CommType.INT8, CommType.INT8), steps)

    bit_exact = np.array_equal(outs_flat[0], outs_hier[0])
    later_close = all(np.allclose(a, b, rtol=1e-5, atol=1e-6)
                      for a, b in zip(outs_flat[1:], outs_hier[1:]))
    int8_err = float(np.max(np.abs(outs_flat[0] - outs_hier8[0])))
    # int8 rowwise: one quantization step of the largest row per pooled
    # sum of IDS rows
    int8_tol = IDS * (max(float(np.abs(w).max()) for w in weights.values())
                      / 127.0) * 4.0 + 1e-4
    dcn_flat = led_flat.get(LINK_DCN, 0.0)
    dcn_flat8 = led_flat8.get(LINK_DCN, 0.0)
    dcn_hier8 = led_hier8.get(LINK_DCN, 0.0)
    return {
        "topology": f"{S}x{L}",
        "num_processes": N,
        "device": str(dev),
        "rows": R, "dim": D, "feats": F, "batch": B, "steps": steps,
        "zipf_a": ZIPF_A,
        "flat_dedup_factor": round(flat_factor, 3),
        "hier_factor": round(hier_factor, 3),
        "slice_duplication": round(slice_dup, 3),
        "dcn_bytes_flat_fp32": dcn_flat,
        "dcn_bytes_flat_int8": dcn_flat8,
        "dcn_bytes_hier_fp32": led_hier.get(LINK_DCN, 0.0),
        "dcn_bytes_hier_int8": dcn_hier8,
        "ici_bytes_flat_fp32": led_flat.get(LINK_ICI, 0.0),
        "ici_bytes_hier_int8": led_hier8.get(LINK_ICI, 0.0),
        "dcn_reduction_vs_flat": round(dcn_flat / max(dcn_hier8, 1.0), 3),
        "dcn_reduction_vs_flat_int8": round(
            dcn_flat8 / max(dcn_hier8, 1.0), 3),
        "bit_exact_fp32_dcn": bool(bit_exact),
        "later_steps_close": bool(later_close),
        "int8_step1_max_err": round(int8_err, 6),
        "int8_tol": round(int8_tol, 6),
        "int8_within_tol": bool(int8_err <= int8_tol),
        "overflow_flat": ov_flat,
        "overflow_hier": ov_hier + ov_hier8,
        "hier_ledger": dict(sorted(led_hier8.items())),
        "flat_ledger": dict(sorted(led_flat.items())),
    }


def main(argv: Optional[List[str]] = None) -> int:
    """Launch the ranks, print rank 0's ``RESULT {json}`` (and write it
    to ``--out``); exit 0 when :func:`contracts_hold`."""
    ap = argparse.ArgumentParser(prog="hier_bench_worker")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--slices", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from torchrec_tpu_torch.parallel import hier_bench_worker
    from torchrec_tpu_torch.parallel.multiprocess import launch

    # by its module name: the spawned ranks import it, not ``__main__``
    results = launch(hier_bench_worker.rank_main,
                     RANKS_PER_SLICE * args.slices,
                     args=(args.smoke, args.slices, args.device))
    result = results[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print("RESULT " + json.dumps(result), flush=True)
    return 0 if contracts_hold(result) else 1


if __name__ == "__main__":
    sys.exit(main())
