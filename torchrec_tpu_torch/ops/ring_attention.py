"""Ring attention: exact attention over a sequence sharded across ranks
(``torchrec_tpu/ops/ring_attention.py``): ``ring_attention``,
``full_attention_reference``, ``RingMultiHeadAttention`` and
``make_ring_attention_step``.

Each rank holds a ``T_local`` slice of the sequence's queries, keys and
values (rank ``i`` positions ``[i * T_local, (i + 1) * T_local)``).  The
queries stay put; the key/value blocks (and their padding mask) travel
around the ring, one hop to rank ``i + 1`` a step, with point-to-point
send and receive (``torch.distributed.batch_isend_irecv``), and each rank
folds every block into its output with the online-softmax recurrence of
the JAX package's ``_block_attn_update`` (a running max, normalizer and
accumulator, with its guards for fully masked blocks and rows).  A block
that causality masks whole is skipped (its update would be the
identity).  A fully masked query row gives zeros.

``torch.distributed``'s point-to-point ops carry no gradient, where JAX
differentiates through ``ppermute``.  So the ring is a
``torch.autograd.Function``: the forward saves each query row's
log-sum-exp, and the backward sends the key/value blocks around the ring
again, each with its ``dK``/``dV`` accumulator, and each rank adds its
queries' share (the flash-attention backward: ``P = exp(S - lse)``,
``dS = P * (dP - rowsum(dO * O))``); after ``N`` hops every accumulator
is home.  Nothing gathers the whole sequence.

The ring runs over a ``comm.ShardingEnv``'s group.  gloo takes only host
tensors for point-to-point ops, so over gloo the blocks cross through
host memory; NCCL sends them from the card.  The wire ledger records the
blocks' bytes under ``ring_attention:kv`` (forward) and
``ring_attention:bwd`` (backward).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from torchrec_tpu_torch.parallel.comm import ShardingEnv, record_wire_bytes


def _ring_shift(tensors: Sequence[torch.Tensor], env: ShardingEnv,
                tag: str) -> List[torch.Tensor]:
    """Each tensor to rank ``rank + 1`` of the ring; returns what rank
    ``rank - 1`` sent (new tensors on the inputs' device)."""
    N = env.world_size
    if N == 1 or env.group is None:
        return [t.clone() for t in tensors]
    r = env.rank
    nxt = dist.get_global_rank(env.group, (r + 1) % N)
    prv = dist.get_global_rank(env.group, (r - 1) % N)
    stage = env.backend == "gloo"
    ops, bufs = [], []
    for t in tensors:
        src = t.contiguous()
        if src.dtype == torch.bool:
            src = src.view(torch.uint8)
        if stage:
            src = src.cpu()
        record_wire_bytes(tag, src.numel() * src.element_size())
        buf = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, nxt, env.group),
                dist.P2POp(dist.irecv, buf, prv, env.group)]
        bufs.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = []
    for t, b in zip(tensors, bufs):
        b = b.to(t.device)
        out.append(b.view(torch.bool) if t.dtype == torch.bool else b)
    return out


def _scale(Dh: int) -> float:
    """``1 / sqrt(float32(Dh))`` in float32, as the JAX package forms
    it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(Dh))))


def _scores(q, k_blk, valid_blk, causal_ok, scale):
    """``[B, H, Tq, Tk]`` scaled scores, masked keys and causally hidden
    pairs at ``-inf``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_blk) * scale
    neg = torch.tensor(float("-inf"), dtype=s.dtype, device=s.device)
    if causal_ok is not None:
        s = torch.where(causal_ok[None, None], s, neg)
    return torch.where(valid_blk[:, None, None, :], s, neg)


def _causal_ok(my: int, src: int, T: int, device) -> torch.Tensor:
    """``[Tq, Tk]``: query (global ``my * T + i``) may see key (global
    ``src * T + j``)."""
    q_pos = my * T + torch.arange(T, device=device)
    k_pos = src * T + torch.arange(T, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def _block_attn_update(s, v_blk, m, l, acc):
    """One online-softmax step over a block's scores ``s`` (the JAX
    package's ``_block_attn_update``): ``m``/``l`` ``[B, H, Tq]``,
    ``acc`` ``[B, Tq, H, Dh]``."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.exp(m - m_new)
    corr = torch.where(torch.isfinite(m), corr, 0.0)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = (acc * corr.permute(0, 2, 1)[..., None]
               + torch.einsum("bhqk,bkhd->bqhd", p, v_blk))
    return m_new, l_new, acc_new


def _skipped(causal: bool, my: int, src: int) -> bool:
    """A block every query of this rank is causally barred from."""
    return causal and src > my


def _ring_forward(q, k, v, valid, causal, env):
    N, my = env.world_size, env.rank
    B, T, H, Dh = q.shape
    scale = _scale(Dh)
    m = torch.full((B, H, T), float("-inf"), device=q.device)
    l = torch.zeros((B, H, T), device=q.device)
    acc = torch.zeros((B, T, H, Dh), device=q.device)
    kb, vb, mb = k, v, valid
    for i in range(N):
        src = (my - i) % N
        if not _skipped(causal, my, src):
            ok = _causal_ok(my, src, T, q.device) if causal else None
            m, l, acc = _block_attn_update(_scores(q, kb, mb, ok, scale),
                                           vb, m, l, acc)
        if i < N - 1:
            kb, vb, mb = _ring_shift((kb, vb, mb), env, "ring_attention:kv")
    out = acc / torch.clamp_min(l, 1e-30).permute(0, 2, 1)[..., None]
    lse = torch.where(l > 0, m + torch.log(l),
                      torch.tensor(float("-inf"), device=q.device))
    return out, lse


def _ring_backward(q, k, v, valid, out, lse, dout, causal, env):
    N, my = env.world_size, env.rank
    B, T, H, Dh = q.shape
    scale = _scale(Dh)
    # rowsum(dO * O) per (b, h, q)
    delta = (dout * out).sum(dim=-1).permute(0, 2, 1)
    live = torch.isfinite(lse)[..., None]
    dq = torch.zeros_like(q)
    kb, vb, mb = k, v, valid
    dkb, dvb = torch.zeros_like(k), torch.zeros_like(v)
    for i in range(N):
        src = (my - i) % N
        if not _skipped(causal, my, src):
            ok = _causal_ok(my, src, T, q.device) if causal else None
            s = _scores(q, kb, mb, ok, scale)
            p = torch.exp(s - lse[..., None])
            p = torch.where(torch.isfinite(s) & live, p, 0.0)
            dvb = dvb + torch.einsum("bhqk,bqhd->bkhd", p, dout)
            dp = torch.einsum("bqhd,bkhd->bhqk", dout, vb)
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
            dkb = dkb + torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
        # the accumulators travel with their blocks; after N hops each is
        # back on the rank that owns its keys
        if i < N - 1:
            kb, vb, mb, dkb, dvb = _ring_shift((kb, vb, mb, dkb, dvb), env,
                                               "ring_attention:bwd")
        else:
            dkb, dvb = _ring_shift((dkb, dvb), env, "ring_attention:bwd")
    return dq, dkb, dvb


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, valid, causal, env):
        q32, k32, v32 = (t.to(torch.float32) for t in (q, k, v))
        out, lse = _ring_forward(q32, k32, v32, valid, causal, env)
        ctx.save_for_backward(q32, k32, v32, valid, out, lse)
        ctx.causal, ctx.env = causal, env
        ctx.dtypes = (q.dtype, k.dtype, v.dtype)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_backward(q, k, v, valid, out, lse,
                                    dout.to(torch.float32), ctx.causal,
                                    ctx.env)
        dq, dk, dv = (g.to(dt) for g, dt in zip((dq, dk, dv), ctx.dtypes))
        return dq, dk, dv, None, None, None


def ring_attention(
    q: torch.Tensor,  # [B, T_local, H, Dh], this rank's query slice
    k: torch.Tensor,
    v: torch.Tensor,
    env: ShardingEnv,
    kv_valid: Optional[torch.Tensor] = None,  # [B, T_local] bool
    causal: bool = False,
) -> torch.Tensor:
    """Exact attention over the sequence sharded across ``env``'s ranks:
    this rank's ``[B, T_local, H, Dh]`` output slice, differentiable in
    ``q``, ``k`` and ``v``.  ``causal`` masks by global position.  Every
    rank calls it together."""
    if kv_valid is None:
        kv_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    return _RingAttention.apply(q, k, v, kv_valid.to(torch.bool), causal,
                                env)


def full_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    kv_valid: Optional[torch.Tensor] = None, causal: bool = False,
) -> torch.Tensor:
    """Unsharded exact attention over ``[B, T, H, Dh]`` (the ring's
    oracle): masked scores ``-inf``, a fully masked row zeros."""
    B, T, H, Dh = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / torch.sqrt(
                         torch.tensor(float(Dh)))
    neg = torch.tensor(float("-inf"), device=s.device)
    if causal:
        pos = torch.arange(T, device=s.device)
        s = torch.where(pos[:, None] >= pos[None, :], s, neg)
    if kv_valid is not None:
        s = torch.where(kv_valid[:, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)


class RingMultiHeadAttention:
    """Multi-head attention over a sequence-sharded input: the
    projections are local products with replicated ``[Dm, Dm]`` weights
    (``wq``, ``wk``, ``wv``, ``wo``); only the key/value blocks move."""

    @staticmethod
    def apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              num_heads: int, env: ShardingEnv,
              kv_valid: Optional[torch.Tensor] = None,
              causal: bool = False) -> torch.Tensor:
        """``x`` ``[B, T_local, Dm]`` -> ``[B, T_local, Dm]``."""
        B, T, Dm = x.shape
        Dh = Dm // num_heads

        def proj(w):
            return (x @ w).reshape(B, T, num_heads, Dh)

        out = ring_attention(proj(params["wq"]), proj(params["wk"]),
                             proj(params["wv"]), env, kv_valid, causal)
        return out.reshape(B, T, Dm) @ params["wo"]

    @staticmethod
    def init(generator: torch.Generator,
             model_dim: int) -> Dict[str, torch.Tensor]:
        """Each weight normal with standard deviation ``1 /
        sqrt(model_dim)``, drawn from ``generator`` in the order wq, wk,
        wv, wo (on the generator's device)."""
        scale = 1.0 / model_dim ** 0.5
        return {n: torch.randn((model_dim, model_dim), generator=generator,
                               device=generator.device) * scale
                for n in ("wq", "wk", "wv", "wo")}


def make_ring_attention_step(env: ShardingEnv, num_heads: int,
                             causal: bool = False) -> Callable:
    """The sequence-sharded attention step: ``step(params, x_local,
    kv_valid_local)`` -> this rank's ``[B, T_local, Dm]`` output, the
    ring over ``env`` (JAX's ``jit(shard_map)`` wrapper; the port runs
    one process per rank, each with its slice)."""

    def step(params, x, kv_valid=None):
        return RingMultiHeadAttention.apply(params, x, num_heads, env,
                                            kv_valid, causal)

    return step
