"""BERT4Rec training, the port of the JAX package's
``examples/bert4rec/main.py``: masked-item modelling over session
histories, the item table sharded row-wise over the ranks (one rank:
whole) and the transformer data-parallel, through
``SequenceModelParallel``.

Run on the card:
  python -m torchrec_tpu_torch.examples.bert4rec.main --steps 30

``--device cpu`` runs the kernels' plain versions on the CPU.  The world
is the process group's when the process has joined one
(``parallel/multiprocess.py``; each rank keeps its own of every step's
batches, drawn in rank order from one seeded stream, as the JAX example
stacks them over its mesh), else one rank.
"""

from __future__ import annotations

import argparse
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.datasets.random import _zipf_pmf
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.models.experimental.bert4rec import (
    BERT4Rec,
    masked_item_loss,
)
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.optim.adam import adam
from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.model_parallel import forward_from_embeddings
from torchrec_tpu_torch.parallel.sequence_model_parallel import (
    SequenceModelParallel,
)
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingType
from torchrec_tpu_torch.sparse import JaggedTensor, KeyedJaggedTensor
from torchrec_tpu_torch.utils.device import resolve_device


def make_session_batch(rng: np.random.RandomState, batch_size: int,
                       max_len: int, vocab: int, mask_prob: float = 0.3,
                       min_len: int = 2,
                       zipf_ids: Optional[float] = None) -> Batch:
    """One local batch of synthetic sessions, drawn from ``rng`` in the
    JAX example's order: lengths uniform on ``[min_len, max_len]``, item
    ids uniform over the vocabulary (Zipf(``zipf_ids``) over the id ranks
    when given), a random target item a position, and the cloze mask
    (probability ``mask_prob``) only inside each session's real length.
    The targets ride in ``dense_features`` and the mask in ``labels``
    (``[B, max_len]`` float32 each); the history is a KJT of key ``item``
    at capacity ``batch_size * max_len``."""
    cap = batch_size * max_len
    lengths = rng.randint(min_len, max_len + 1,
                          size=(batch_size,)).astype(np.int32)
    n = int(lengths.sum())
    if zipf_ids is None:
        values = rng.randint(0, vocab, size=(n,))
    else:
        values = rng.choice(vocab, size=(n,), p=_zipf_pmf(vocab, zipf_ids))
    kjt = KeyedJaggedTensor.from_lengths_packed(["item"], values, lengths,
                                                caps=cap)
    targets = rng.randint(0, vocab,
                          size=(batch_size, max_len)).astype(np.float32)
    valid = np.arange(max_len)[None, :] < lengths[:, None]
    mask = ((rng.rand(batch_size, max_len) < mask_prob)
            & valid).astype(np.float32)
    return Batch(torch.from_numpy(targets), kjt, torch.from_numpy(mask))


def make_loss_fn(max_len: int) -> Callable:
    """The masked-item loss ``loss_fn(model, dense_params, emb_values,
    batch)`` of ``SequenceModelParallel``: the ``item`` rows to the dense
    ``[B, max_len, D]`` sequence, the key mask from the lengths, the
    model's ``forward_from_embeddings``, ``masked_item_loss`` of the
    batch's targets over its cloze mask."""

    def loss_fn(model, dense_params, emb_values, b):
        lengths = b.sparse_features["item"].lengths()
        x = JaggedTensor(emb_values["item"], lengths).to_padded_dense(
            max_len)
        pos = torch.arange(max_len, device=x.device)[None, :]
        logits = forward_from_embeddings(model, dense_params, x,
                                         pos < lengths[:, None])
        return masked_item_loss(logits, b.dense_features, b.labels)

    return loss_fn


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=20_000)
    p.add_argument("--max_len", type=int, default=16)
    p.add_argument("--emb_dim", type=int, default=32)
    p.add_argument("--num_blocks", type=int, default=2)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--batch_size", type=int, default=8, help="per rank")
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda (raises without a card)")
    return p.parse_args(argv)


def _env(device: torch.device) -> ShardingEnv:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return ShardingEnv.from_process_group(
            torch.distributed.get_backend(), device=device)
    return ShardingEnv.single_device(device)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Train and print the masked-item loss every 10 steps; returns the
    run's pieces (``smp``, ``state``, ``losses``)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    env = _env(dev)
    n, r = env.world_size, env.rank
    B, L, V, D = args.batch_size, args.max_len, args.vocab, args.emb_dim
    model = BERT4Rec(vocab_size=V, max_len=L, emb_dim=D,
                     num_blocks=args.num_blocks, num_heads=args.num_heads,
                     device="meta")
    tables = (EmbeddingConfig(num_embeddings=V, embedding_dim=D,
                              name="t_item", feature_names=["item"]),)
    # the item table is the big tensor: its rows split over every rank
    plan = {"t_item": ParameterSharding(ShardingType.ROW_WISE,
                                        ranks=list(range(n)))}
    smp = SequenceModelParallel(
        model=model, tables=tables, env=env, plan=plan,
        batch_size_per_device=B, feature_caps={"item": B * L},
        loss_fn=make_loss_fn(L), dense_optimizer=adam(args.lr))
    state = smp.init(torch.Generator(device=dev).manual_seed(0))
    step = smp.make_train_step()
    rng = np.random.RandomState(0)
    losses = []
    for i in range(args.steps):
        batches = [make_session_batch(rng, B, L, V) for _ in range(n)]
        state, m = step(state, batches[r].to(dev))
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0 and r == 0:
            print(f"step {i + 1}: masked-item loss={losses[-1]:.4f}")
    if r == 0:
        print(f"done: the item table's rows live row-wise across {n} "
              "rank(s)")
    return {"smp": smp, "state": state, "losses": losses}


if __name__ == "__main__":
    main()
