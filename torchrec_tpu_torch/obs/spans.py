"""Named spans (the ``span`` of ``torchrec_tpu/obs/spans.py``).

A span is a ``torch.profiler.record_function`` range: close to free when
no profiler runs, and a named range on the host timeline (with the CUDA
kernels it launched beneath it) when one does.  The pipeline marks
``pipeline/bucketize`` (occupancy, signature and repack of a batch) and
``pipeline/step_dispatch`` (the train step's host time)."""

from __future__ import annotations

import torch


def span(name: str, **attrs):
    """Context manager marking ``name`` on the profiler timeline;
    ``attrs`` ride along as the range's argument string."""
    args = ", ".join(f"{k}={v}" for k, v in attrs.items()) or None
    return torch.profiler.record_function(name, args)
