from torchrec_tpu_torch.quant.embedding_modules import (
    QuantEmbeddingBagCollection,
)

__all__ = ["QuantEmbeddingBagCollection"]
