from torchrec_tpu_torch.sparse.jagged_tensor import (
    JaggedTensor,
    KeyedJaggedTensor,
    KeyedTensor,
    bucket_ladder,
    bucketed_cap,
    regroup_request_major,
)

__all__ = [
    "JaggedTensor",
    "KeyedJaggedTensor",
    "KeyedTensor",
    "bucket_ladder",
    "bucketed_cap",
    "regroup_request_major",
]
