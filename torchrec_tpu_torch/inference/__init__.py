from torchrec_tpu_torch.inference.modules import (
    ServingModule,
    build_serving_fn,
    quantize_inference_model,
)
from torchrec_tpu_torch.inference.predict_factory import (
    load_packaged_model,
    package_model,
)
from torchrec_tpu_torch.inference.serving import (
    InferenceServer,
    PyBatchingQueue,
    QueueStopped,
)

__all__ = [
    "InferenceServer",
    "PyBatchingQueue",
    "QueueStopped",
    "ServingModule",
    "build_serving_fn",
    "load_packaged_model",
    "package_model",
    "quantize_inference_model",
]
