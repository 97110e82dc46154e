"""BERT4Rec, masked-item prediction over interaction histories
(``torchrec_tpu/models/experimental/bert4rec.py``): ``HistoryArch``,
``TransformerBlock``, ``BERT4Rec`` and ``masked_item_loss``.

``TransformerBlock`` computes what the JAX block (flax
``MultiHeadDotProductAttention`` then a GELU feed-forward) computes, not
what ``nn.TransformerEncoderLayer`` does:

- the query, key and value projections are flax ``DenseGeneral`` kernels
  ``[D, H, Dh]`` (bias ``[H, Dh]``) and the output one ``[H, Dh, D]``;
  the port holds each as an ``nn.Linear`` over the flattened heads
  (``convert.py`` reshapes them);
- the query is scaled by ``1 / sqrt(Dh)`` before the product;
- a masked score is set to ``torch.finfo(float32).min``, not ``-inf``, so
  a row with every key masked (a session of length 0) gets uniform
  weights, not NaN;
- GELU is the tanh approximation (flax ``nn.gelu``'s default);
- LayerNorm's epsilon is flax's 1e-6;
- the block is post-LN: ``LN(x + MHA(x))``, then ``LN(x + W2 gelu(W1
  x))``.

The attention is plain torch ops in the order flax composes them (the
JAX package has no kernel here).  Dropout is left out (the JAX models run
it deterministic, rate 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.modules.embedding_modules import EmbeddingCollection
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.device import DeviceLike

# flax nn.LayerNorm's default epsilon
LAYER_NORM_EPS = 1e-6


def attention_mask_fill(scores: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """flax's masking: masked scores become the dtype's most negative
    finite value."""
    return torch.where(mask, scores,
                       torch.tensor(torch.finfo(scores.dtype).min,
                                    dtype=scores.dtype,
                                    device=scores.device))


class MultiHeadDotProductAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention(num_heads, qkv_features=D)``
    self-attention: ``[B, T, D]`` -> ``[B, T, D]``, keys masked by a
    ``[B, T]`` bool mask (True = attend)."""

    def __init__(self, model_dim: int, num_heads: int):
        super().__init__()
        if model_dim % num_heads:
            raise ValueError(f"{num_heads} heads do not divide {model_dim}")
        self.num_heads = num_heads
        self.query = nn.Linear(model_dim, model_dim)
        self.key = nn.Linear(model_dim, model_dim)
        self.value = nn.Linear(model_dim, model_dim)
        self.out = nn.Linear(model_dim, model_dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        H = self.num_heads
        Dh = D // H

        def heads(lin):
            return lin(x).reshape(B, T, H, Dh)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        q = q / torch.sqrt(torch.tensor(float(Dh), dtype=q.dtype))
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        s = attention_mask_fill(s, mask[:, None, None, :])
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v)
        return self.out(o.reshape(B, T, D))


class TransformerBlock(nn.Module):
    """The JAX package's post-LN block (module docstring):
    ``[B, T, D]`` with a ``[B, T]`` key mask -> ``[B, T, D]``."""

    def __init__(self, num_heads: int, hidden: int, ff_mult: int = 4):
        super().__init__()
        self.attention = MultiHeadDotProductAttention(hidden, num_heads)
        self.norm_0 = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.dense_0 = nn.Linear(hidden, ff_mult * hidden)
        self.dense_1 = nn.Linear(ff_mult * hidden, hidden)
        self.norm_1 = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = self.norm_0(x + self.attention(x, mask))
        f = self.dense_1(F.gelu(self.dense_0(x), approximate="tanh"))
        return self.norm_1(x + f)


class HistoryArch(nn.Module):
    """Item-id sequences -> ``([B, L, D]`` rows, ``[B, L]`` validity)
    through an ``EmbeddingCollection`` of one table ``t_item``."""

    def __init__(self, vocab_size: int, max_len: int, emb_dim: int,
                 feature_name: str = "item", device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_len = max_len
        self.feature_name = feature_name
        self.ec = EmbeddingCollection(
            [EmbeddingConfig(num_embeddings=vocab_size, embedding_dim=emb_dim,
                             name="t_item", feature_names=[feature_name])],
            device=device, generator=generator)

    def forward(self, history: KeyedJaggedTensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        jt = self.ec(history)[self.feature_name]
        dense = jt.to_padded_dense(self.max_len)
        pos = torch.arange(self.max_len, device=dense.device)[None, :]
        return dense, pos < jt.lengths()[:, None]


class BERT4Rec(nn.Module):
    """Masked-item prediction: the history's rows plus a learned position
    embedding, ``num_blocks`` transformer blocks, then logits over the
    vocabulary.  ``forward(history)`` runs the item collection;
    ``forward_from_embeddings(x, mask)`` is the dense side alone, the
    entry of the sharded runtime (``parallel/sequence_model_parallel.py``),
    where the collection is built on ``torch.device("meta")``."""

    def __init__(self, vocab_size: int, max_len: int, emb_dim: int = 64,
                 num_blocks: int = 2, num_heads: int = 2,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.max_len = max_len
        self.history = HistoryArch(vocab_size, max_len, emb_dim,
                                   device=device, generator=generator)
        self.position_emb = nn.Embedding(max_len, emb_dim)
        self.blocks = nn.ModuleList(TransformerBlock(num_heads, emb_dim)
                                    for _ in range(num_blocks))
        self.out = nn.Linear(emb_dim, vocab_size)

    def forward(self, history: KeyedJaggedTensor) -> torch.Tensor:
        """KJT of item histories -> ``[B, L, vocab]`` logits."""
        x, mask = self.history(history)
        return self.forward_from_embeddings(x, mask)

    def forward_from_embeddings(self, x: torch.Tensor,
                                mask: torch.Tensor) -> torch.Tensor:
        """``[B, L, D]`` item rows and their ``[B, L]`` mask -> ``[B, L,
        vocab]`` logits."""
        x = x + self.position_emb.weight[None]
        for blk in self.blocks:
            x = blk(x, mask)
        return self.out(x)


def masked_item_loss(logits: torch.Tensor, targets: torch.Tensor,
                     loss_mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of ``targets`` ``[B, L]`` over the masked positions
    (``loss_mask`` ``[B, L]``, 1 where a position is scored), averaged
    over at least one position."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets.to(torch.int64)[..., None])[..., 0]
    loss_mask = loss_mask.to(ll.dtype)
    denom = torch.clamp_min(loss_mask.sum(), 1.0)
    return -(ll * loss_mask).sum() / denom
