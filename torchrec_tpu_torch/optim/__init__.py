from torchrec_tpu_torch.optim.adagrad import Adagrad, adagrad
from torchrec_tpu_torch.optim.warmup import (
    WarmupOptimizer,
    WarmupPolicy,
    WarmupStage,
    warmup_optimizer,
    warmup_schedule,
)

__all__ = ["Adagrad", "adagrad", "WarmupOptimizer", "WarmupPolicy",
           "WarmupStage", "warmup_optimizer", "warmup_schedule"]
