"""Named spans (the ``span`` of ``torchrec_tpu/obs/spans.py``).

A span is a ``torch.profiler.record_function`` range: close to free when
no profiler runs, and a named range on the host timeline (with the CUDA
kernels it launched beneath it) when one does."""

from __future__ import annotations

import torch


def span(name: str):
    """Context manager marking ``name`` on the profiler timeline."""
    return torch.profiler.record_function(name)
