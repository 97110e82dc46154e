"""Chunked pooled-embedding all-to-alls (``torchrec_tpu/parallel/
chunked_a2a.py``): the pooled output dist split into K column chunks,
each its own all-to-all, so that dense work on a chunk can start before
the whole output has arrived.  ``W @ concat(chunks) == sum_k W_k @
chunk_k``: the first dense layer decomposes over the chunks.

:func:`chunked_pooled_a2a` concatenates the chunks' results, bit for bit
one all-to-all of the whole payload.  :func:`chunked_a2a_linear` starts
the all-to-all of chunk ``k + 1`` (``async_op``) before the matmul of
chunk ``k`` and accumulates the partial products; it equals ``a2a(x) @ w``
up to the reassociated additions.  Each chunk's bytes go to the ledger
under ``chunked_a2a`` or ``chunked_a2a_linear``.  Left out: the
link-class split of the ledger (``dcn_fraction``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from torchrec_tpu_torch.parallel.comm import (
    ShardingEnv,
    all_to_all,
    record_wire_bytes,
)


def split_cols(x: torch.Tensor, num_chunks: int) -> List[torch.Tensor]:
    """The trailing (feature-column) dim cut into ``num_chunks`` equal
    chunks (views)."""
    D = x.shape[-1]
    if D % num_chunks:
        raise ValueError(f"{D} columns do not split into {num_chunks} "
                         "chunks")
    w = D // num_chunks
    return [x[..., i * w:(i + 1) * w] for i in range(num_chunks)]


def chunked_pooled_a2a(
    contrib: torch.Tensor,  # [N, B_local, D] this rank's block per dest
    env: ShardingEnv,
    num_chunks: int,
) -> torch.Tensor:
    """K column-chunked all-to-alls: ``[N * B_local, D]``, the blocks
    every rank sent this one in rank order, bit for bit one all-to-all of
    the whole payload."""
    outs = []
    for c in split_cols(contrib, num_chunks):
        record_wire_bytes("chunked_a2a", c.numel() * c.element_size(),
                          env.dcn_fraction)
        outs.append(all_to_all(c, env))
    return torch.cat([o.reshape((-1,) + tuple(o.shape[2:])) for o in outs],
                     dim=-1)


def _start_a2a(x: torch.Tensor, env: ShardingEnv):
    """An all-to-all of ``x`` started asynchronously: (the output, the
    work to wait on, None at one rank)."""
    x = x.contiguous()
    if env.group is None:
        return x.clone(), None
    out = torch.empty_like(x)
    return out, dist.all_to_all_single(out, x, group=env.group,
                                       async_op=True)


def chunked_a2a_linear(
    contrib: torch.Tensor,  # [N, B_local, D]
    w: torch.Tensor,  # [D, H] the first dense layer over the pooled concat
    env: ShardingEnv,
    num_chunks: int,
) -> torch.Tensor:
    """The output dist and the first dense layer overlapped: chunk ``k +
    1``'s all-to-all runs while chunk ``k``'s partial matmul accumulates.
    ``[N * B_local, H]``, equal to ``a2a(contrib) @ w`` up to the
    reassociated additions."""
    D = contrib.shape[-1]
    if w.shape[0] != D:
        raise ValueError(f"weight {tuple(w.shape)} for {D} columns")
    cw = D // num_chunks
    chunks = split_cols(contrib, num_chunks)
    pending = None
    acc = None
    for k in range(num_chunks + 1):
        nxt = None
        if k < num_chunks:
            record_wire_bytes("chunked_a2a_linear",
                              chunks[k].numel() * chunks[k].element_size(),
                              env.dcn_fraction)
            nxt = _start_a2a(chunks[k], env)
        if pending is not None:
            o, work = pending
            if work is not None:
                work.wait()
            part = o.reshape(-1, cw) @ w[(k - 1) * cw:k * cw]
            acc = part if acc is None else acc + part
        pending = nxt
    return acc
