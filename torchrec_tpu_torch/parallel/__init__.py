"""The distributed runtime's surface, as the JAX package's
``torchrec_tpu/parallel/__init__.py`` re-exports it (the ported names):
``from torchrec_tpu_torch.parallel import DistributedModelParallel``."""

from torchrec_tpu_torch.parallel.comm import ShardingEnv
from torchrec_tpu_torch.parallel.model_parallel import (
    DistributedModelParallel,
    DMPCollection,
    stack_batches,
)
from torchrec_tpu_torch.parallel.production import TouchedRowTracker
from torchrec_tpu_torch.parallel.train_pipeline import (
    BucketedStepCache,
    BucketedTrainPipeline,
    BucketingConfig,
    DataLoadingThread,
    TrainPipelineBase,
    TrainPipelineSparseDist,
)
from torchrec_tpu_torch.parallel.types import (
    EmbeddingComputeKernel,
    EmbeddingModuleShardingPlan,
    ParameterSharding,
    ShardingStrategy,
    ShardingType,
)

__all__ = [
    "ShardingEnv",
    "DistributedModelParallel",
    "DMPCollection",
    "stack_batches",
    "TouchedRowTracker",
    "BucketedStepCache",
    "BucketedTrainPipeline",
    "BucketingConfig",
    "DataLoadingThread",
    "TrainPipelineBase",
    "TrainPipelineSparseDist",
    "EmbeddingComputeKernel",
    "EmbeddingModuleShardingPlan",
    "ParameterSharding",
    "ShardingStrategy",
    "ShardingType",
]
