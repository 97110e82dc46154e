from torchrec_tpu_torch.inference.bucketed_serving import (
    BucketedInferenceServer,
    BucketedServingCache,
    HotRowServingCache,
    ServingBucketConfig,
)
from torchrec_tpu_torch.inference.freshness import (
    DeltaPublisher,
    DeltaSubscriber,
)
from torchrec_tpu_torch.inference.mesh import (
    AllReplicasDown,
    CircuitBreaker,
    ReplicaRouter,
)
from torchrec_tpu_torch.inference.modules import (
    ServingModule,
    build_serving_fn,
    quantize_inference_model,
)
from torchrec_tpu_torch.inference.predict_factory import (
    BatchingMetadata,
    PredictFactory,
    export_native,
    load_packaged_model,
    package_model,
)
from torchrec_tpu_torch.inference.serving import (
    HttpInferenceServer,
    InferenceServer,
    NativeInferenceServer,
    NetworkInferenceServer,
    PredictClient,
    PyBatchingQueue,
    QueueStopped,
    install_sigterm_drain,
)

__all__ = [
    "AllReplicasDown",
    "BatchingMetadata",
    "BucketedInferenceServer",
    "BucketedServingCache",
    "CircuitBreaker",
    "DeltaPublisher",
    "DeltaSubscriber",
    "HotRowServingCache",
    "HttpInferenceServer",
    "InferenceServer",
    "NativeInferenceServer",
    "NetworkInferenceServer",
    "PredictClient",
    "PredictFactory",
    "PyBatchingQueue",
    "QueueStopped",
    "ReplicaRouter",
    "ServingBucketConfig",
    "ServingModule",
    "build_serving_fn",
    "export_native",
    "install_sigterm_drain",
    "load_packaged_model",
    "package_model",
    "quantize_inference_model",
]
