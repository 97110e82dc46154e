"""Counter-key namespace (the subset of ``torchrec_tpu/utils/profiling.py``
that serving uses)."""

from __future__ import annotations


def counter_key(prefix: str, table: str, counter: str) -> str:
    """THE per-table counter namespace: ``<prefix>/<table>/<counter>``."""
    return f"{prefix}/{table}/{counter}"
