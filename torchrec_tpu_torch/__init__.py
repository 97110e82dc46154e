"""torchrec_tpu_torch — the PyTorch/CUDA port of ``torchrec_tpu``.

The sub-packages keep the JAX package's layout and module names, so each
module's counterpart is found at the same path under ``torchrec_tpu/``.
This slice ports quantized DLRM serving: the int8/int4/int2 embedding
collection with its hand-written CUDA lookup kernels (``ops/tbe.py``,
``csrc/tbe_quant.cu``), the DLRM dense side, artifact packaging and the
dynamic-batching ``InferenceServer``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; with no CUDA device they raise instead of carrying on
on the CPU.  The dense layers are float32 throughout: importing the
package turns TF32 off for CUDA matmuls and cuDNN, so a product on the
card rounds like the float32 reference.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
