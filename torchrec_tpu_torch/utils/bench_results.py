"""A store of benchmark results with their hardware provenance
(``torchrec_tpu/utils/bench_results.py``): each on-card result appended
as one JSON line with its time, device, git revision and config hash.

The default file is the port's own, ``torchrec_tpu_torch/BENCH_RESULTS.jsonl``
(git-ignored), never the repository root's JAX-package store.  The store
is a record to read back: no path of the port reports a stored result in
place of a live one.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import time
from typing import Any, Dict, Optional

RESULTS_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "BENCH_RESULTS.jsonl")


def _git_rev() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, timeout=10, cwd=os.path.dirname(RESULTS_FILE),
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def config_hash(config: Dict[str, Any]) -> str:
    """A stable short hash of a benchmark's config dict (keys sorted)."""
    return hashlib.sha256(json.dumps(config, sort_keys=True, default=str)
                          .encode()).hexdigest()[:12]


def record_hardware_result(
    result: Dict[str, Any],
    device: str,
    config: Optional[Dict[str, Any]] = None,
    path: str = RESULTS_FILE,
) -> Dict[str, Any]:
    """Append one on-card result (a JSON object) to the store; returns
    the record with its provenance."""
    rec = dict(result)
    rec["measured_at"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    rec["device"] = device
    rec["git_rev"] = _git_rev()
    if config is not None:
        rec["config_hash"] = config_hash(config)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    return rec


def latest_hardware_result(
    metric: str,
    config: Optional[Dict[str, Any]] = None,
    path: str = RESULTS_FILE,
) -> Optional[Dict[str, Any]]:
    """The newest stored record of ``metric``.  With ``config``, only a
    record of the same ``config_hash`` qualifies (a record without one
    never does): a number from another size is no evidence for this
    one."""
    if not os.path.exists(path):
        return None
    want_hash = config_hash(config) if config is not None else None
    best = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("metric") != metric:
                continue
            if want_hash is not None and rec.get("config_hash") != want_hash:
                continue
            best = rec  # the file is in append order: the last wins
    return best
