"""gRPC Predictor front end (``torchrec_tpu/inference/grpc_server.py``).

The proto (``protos/predictor.proto``) is field-for-field the predictor
service's, so clients speaking that protocol work unchanged.  Message
classes come from plain ``protoc --python_out`` (checked in as
``predictor_pb2.py``) and the service is registered through gRPC's
generic-handler API (no codegen plugin).  The handler body forwards to
``InferenceServer.predict``, so gRPC requests coalesce into the same
batches as TCP/HTTP/in-process callers; over ``NativeInferenceServer``
the C++ executor loop answers them.

This module needs ``grpcio`` and ``protobuf``; ``inference/__init__.py``
does not import it, so the serving tier runs on a host that has neither.
"""

from __future__ import annotations

from concurrent import futures
from typing import Dict, Optional

import numpy as np

from torchrec_tpu_torch.inference.protos import predictor_pb2 as pb

_SERVICE = "predictor.Predictor"
_METHOD = f"/{_SERVICE}/Predict"


def request_from_arrays(
    dense: np.ndarray,
    ids_per_feature,
    weights_per_feature=None,
) -> "pb.PredictionRequest":
    """Build a PredictionRequest from one example's arrays (the packing
    predictor clients use: lengths int32 [T], values int64 jagged)."""
    dense = np.ascontiguousarray(dense, np.float32)
    T = len(ids_per_feature)
    lengths = np.asarray([len(x) for x in ids_per_feature], np.int32)
    values = (
        np.concatenate([np.asarray(x, np.int64) for x in ids_per_feature])
        if lengths.sum()
        else np.zeros((0,), np.int64)
    )
    sparse = pb.SparseFeatures(
        num_features=T,
        lengths=lengths.tobytes(),
        values=values.tobytes(),
    )
    if weights_per_feature is not None:
        w = (
            np.concatenate(
                [np.asarray(x, np.float32) for x in weights_per_feature]
            )
            if lengths.sum()
            else np.zeros((0,), np.float32)
        )
        sparse.weights = w.tobytes()
    return pb.PredictionRequest(
        batch_size=1,
        float_features=pb.FloatFeatures(
            num_features=dense.shape[0], values=dense.tobytes()
        ),
        id_list_features=sparse,
    )


class GrpcInferenceServer:
    """gRPC ``Predictor`` service over an ``InferenceServer``'s batching
    queue."""

    def __init__(self, inner, max_workers: int = 8):
        self.inner = inner
        self.port: Optional[int] = None
        self._server = None
        self._max_workers = max_workers

    def _predict(self, request: "pb.PredictionRequest", context):
        import grpc

        # the batching queue is a single-example protocol (the server
        # forms batches); reject multi-example requests loudly instead
        # of mis-parsing the [T x B] packing
        if request.batch_size not in (0, 1):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"batch_size={request.batch_size} unsupported: this "
                "endpoint takes single-example requests (the server "
                "batches dynamically); send one request per example",
            )
        sf = request.id_list_features
        if sf.weights:
            # the batching queue carries no per-id weight channel; a
            # silent unweighted answer would be wrong, so refuse
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "weighted id_list_features are not supported by this "
                "endpoint; use unweighted features or the in-process "
                "serving API",
            )
        # malformed payloads must surface as INVALID_ARGUMENT, not as a
        # server-side assertion mapped to UNKNOWN
        if (
            len(request.float_features.values) % 4
            or len(sf.lengths) % 4
            or len(sf.values) % 8
        ):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "byte payload length is not a multiple of the element "
                "size (float_features/lengths: 4, values: 8)",
            )
        dense = np.frombuffer(
            request.float_features.values, np.float32
        ).copy()
        lengths = np.frombuffer(sf.lengths, np.int32)
        values = np.frombuffer(sf.values, np.int64)
        if len(dense) != self.inner.num_dense:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"float_features has {len(dense)} values; this model "
                f"takes {self.inner.num_dense}",
            )
        if len(lengths) > len(self.inner.features):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"id_list_features has {len(lengths)} lengths; this "
                f"model takes at most {len(self.inner.features)} "
                "features",
            )
        if (lengths < 0).any():
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "id_list_features lengths must be non-negative",
            )
        if int(lengths.sum()) != len(values):
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"id_list_features lengths sum to {int(lengths.sum())} "
                f"but {len(values)} values were sent",
            )
        for f, n in enumerate(lengths):
            if n > self.inner.caps[f]:
                context.abort(
                    grpc.StatusCode.INVALID_ARGUMENT,
                    f"feature {self.inner.features[f]}: {int(n)} ids "
                    f"exceed the serving capacity {self.inner.caps[f]}",
                )
        ids, pos = [], 0
        for n in lengths:
            ids.append(values[pos : pos + n])
            pos += n
        # pad missing trailing features with empties (proto3 default)
        while len(ids) < len(self.inner.features):
            ids.append(np.zeros((0,), np.int64))
        score = self.inner.predict(dense, ids)
        return pb.PredictionResponse(
            predictions={"default": pb.FloatVec(data=[score])}
        )

    def serve(self, port: int = 0, num_executors: int = 1) -> int:
        import grpc

        handler = grpc.method_handlers_generic_handler(
            _SERVICE,
            {
                "Predict": grpc.unary_unary_rpc_method_handler(
                    self._predict,
                    request_deserializer=pb.PredictionRequest.FromString,
                    response_serializer=(
                        pb.PredictionResponse.SerializeToString
                    ),
                )
            },
        )
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=self._max_workers)
        )
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"127.0.0.1:{port}")
        if not self.port:
            raise OSError(f"could not bind grpc port {port}")
        self.inner.start(num_executors)
        self._server.start()
        return self.port

    def stop(self, grace: float = 1.0) -> None:
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        self.inner.stop()


class GrpcPredictClient:
    """Client for the Predictor service (generated-stub-free: the method
    path + message classes are the whole contract)."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        import grpc

        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._call = self._channel.unary_unary(
            _METHOD,
            request_serializer=pb.PredictionRequest.SerializeToString,
            response_deserializer=pb.PredictionResponse.FromString,
        )

    def predict(
        self, dense: np.ndarray, ids_per_feature, timeout: float = 10.0
    ) -> Dict[str, np.ndarray]:
        resp = self._call(
            request_from_arrays(dense, ids_per_feature), timeout=timeout
        )
        return {
            k: np.asarray(v.data, np.float32)
            for k, v in resp.predictions.items()
        }

    def close(self) -> None:
        self._channel.close()
