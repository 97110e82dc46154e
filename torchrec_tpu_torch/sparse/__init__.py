from torchrec_tpu_torch.sparse.jagged_tensor import (
    JaggedTensor,
    KeyedJaggedTensor,
    KeyedTensor,
    regroup_request_major,
)

__all__ = [
    "JaggedTensor",
    "KeyedJaggedTensor",
    "KeyedTensor",
    "regroup_request_major",
]
