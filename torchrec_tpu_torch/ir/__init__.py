from torchrec_tpu_torch.ir.serializer import (
    deserialize_embedding_configs,
    deserialize_plan,
    serialize_embedding_configs,
    serialize_plan,
)

__all__ = [
    "deserialize_embedding_configs",
    "deserialize_plan",
    "serialize_embedding_configs",
    "serialize_plan",
]
