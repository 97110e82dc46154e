"""torchrec_tpu_torch — the PyTorch/CUDA port of ``torchrec_tpu``.

The sub-packages keep the JAX package's layout and module names, so each
module's counterpart is found at the same path under ``torchrec_tpu/``.
It holds quantized DLRM serving (``quant/``, ``inference/``), the
unsharded authoring path (``modules/embedding_modules.py``, the DLRM
family and ``DLRMTrain`` in ``models/dlrm.py``), the training step of
``DLRM`` and ``DLRM_DCN`` on one device or across ranks
(``parallel/model_parallel.py``) on a plan of the sharding planner
(``parallel/planner/``), the
bucketed training pipeline (``parallel/train_pipeline.py``), the metrics
(``metrics/``) and the DLRM application (``examples/dlrm/dlrm_main.py``),
with a hand-written CUDA kernel for
every Pallas kernel of the JAX package (``csrc/``, wrapped by
``ops/tbe.py`` and ``ops/tbe_backward.py``).

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
