"""Input guardrails (``torchrec_tpu/robustness``): survive corrupt
upstream data.

* the traced tier (:mod:`.sanitize`): invalid ids remapped to the null
  row inside the step, per-key counts on the device; the same bits on
  clean input;
* the host tier (:mod:`.policy`): :class:`InputGuardrails` with STRICT,
  SANITIZE and QUARANTINE policies over the KJT's schema, id ranges and
  the finiteness of dense features and labels;
* :class:`QuarantineStore` (:mod:`.quarantine`): rejected batches kept on
  disk for triage.
"""

from torchrec_tpu_torch.robustness.policy import (
    Diagnosis,
    GuardedIterator,
    GuardrailPolicy,
    GuardrailsConfig,
    InputGuardrailError,
    InputGuardrails,
)
from torchrec_tpu_torch.robustness.quarantine import QuarantineStore
from torchrec_tpu_torch.robustness.sanitize import sanitize_kjt

__all__ = [
    "Diagnosis",
    "GuardedIterator",
    "GuardrailPolicy",
    "GuardrailsConfig",
    "InputGuardrailError",
    "InputGuardrails",
    "QuarantineStore",
    "sanitize_kjt",
]
