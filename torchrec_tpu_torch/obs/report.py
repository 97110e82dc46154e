"""``python -m torchrec_tpu_torch.obs report`` (``torchrec_tpu/obs/report.py``,
line for line): a run's artifacts turned into per-stage latency tables,
overlap ratios, wire bytes and placement-features rows.

Inputs (all optional; ``--dir`` supplies the conventional file names):

* ``events.jsonl``: the run's EventLog stream, whose ``event == "span"``
  records carry the stage timings (``SpanTracer.flush_jsonl`` or a
  streaming event log);
* ``metrics.jsonl``: ``MetricsRegistry.dump_jsonl`` rows, the LAST one
  the run's final cumulative state;
* ``trace.json``: the Chrome trace (validated here, rendered in
  Perfetto).

Outputs: per-stage count / total / p50 / p99 (host wall time); the
prefetch overlap ratio (1 - blocked wait / staged work, the definition
of ``TieredStats.prefetch_overlap_ratio``, over the same intervals, so
the two agree on a run); the data-load overlap (the share of
step-dispatch time not spent blocked pulling batches); per-step wire
bytes from the ledgers; and with ``--placement-features`` one JSON row a
table pairing hotness, occupancy, hit rate and wire evidence.  Reads
JSON and numpy only: no card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, TextIO

import numpy as np

__all__ = [
    "PLACEMENT_FEATURES_SCHEMA_VERSION",
    "flagship_summary",
    "health_summary",
    "load_events",
    "load_metrics",
    "main",
    "overlap_from_spans",
    "placement_features",
    "report",
    "stage_stats",
    "wire_link_split",
]

#: Version stamped on every placement-features row: bump when the row
#: shape changes, so a dataset collected across runs stays
#: self-describing.  v2 added the stamp itself and the
#: ``plan_assumptions`` fingerprint reference (the JAX package's value).
PLACEMENT_FEATURES_SCHEMA_VERSION = 2

PREFETCH_STAGE = "tiered/prefetch_stage"
PREFETCH_WAIT = "tiered/prefetch_wait"
HOST_LOAD = "pipeline/host_load"
STEP_DISPATCH = "pipeline/step_dispatch"


def load_events(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL event stream; skips unparseable lines (a crash can
    truncate the final line — the readable prefix is still a report)."""
    out: List[Dict[str, Any]] = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            try:
                out.append(json.loads(ln))
            except json.JSONDecodeError:
                continue
    return out


def span_records(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The span records of an event stream (``event == "span"``)."""
    return [e for e in events if e.get("event") == "span" and "dur_s" in e]


def load_metrics(path: str) -> List[Dict[str, Any]]:
    """All ``dump_jsonl`` rows, oldest first."""
    return [r for r in load_events(path) if "metrics" in r]


def stage_stats(spans: Sequence[Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Per-stage aggregates: count, total seconds, p50/p99 ms."""
    by_name: Dict[str, List[float]] = {}
    for s in spans:
        by_name.setdefault(s["name"], []).append(float(s["dur_s"]))
    out: Dict[str, Dict[str, float]] = {}
    for name in sorted(by_name):
        durs = np.asarray(by_name[name], np.float64)
        out[name] = {
            "count": int(durs.size),
            "total_s": float(durs.sum()),
            "p50_ms": float(np.percentile(durs, 50) * 1e3),
            "p99_ms": float(np.percentile(durs, 99) * 1e3),
        }
    return out


def overlap_from_spans(
    spans: Sequence[Dict[str, Any]],
) -> Dict[str, Optional[float]]:
    """Overlap ratios recomputed from stage timings alone.

    ``prefetch_overlap_ratio``: 1 - wait/stage over the tiered
    prefetcher's staging spans — the span-derived twin of
    ``TieredStats.prefetch_overlap_ratio`` (same definition, measured
    at the same call sites, so the two agree to timing noise).
    ``data_load_overlap_ratio``: fraction of step-dispatch wall time
    NOT spent blocked in ``pipeline/host_load`` — how completely the
    background loader hid batch construction."""
    stats = stage_stats(spans)
    out: Dict[str, Optional[float]] = {
        "prefetch_overlap_ratio": None,
        "data_load_overlap_ratio": None,
    }

    def exact_total(name: str) -> float:
        # prefer the precisely-measured interval the instrumentation
        # attached (attrs.seconds — the float TieredStats recorded) over
        # the span's own duration, which adds span-entry overhead that
        # skews ratios of sub-millisecond stages
        return sum(
            float(s.get("attrs", {}).get("seconds", s["dur_s"]))
            for s in spans
            if s["name"] == name
        )

    stage_total = exact_total(PREFETCH_STAGE)
    if stage_total > 0:
        out["prefetch_overlap_ratio"] = min(
            1.0, max(0.0, 1.0 - exact_total(PREFETCH_WAIT) / stage_total)
        )
    step = stats.get(STEP_DISPATCH)
    if step and (step["total_s"] > 0 or stats.get(HOST_LOAD)):
        load = stats.get(HOST_LOAD, {"total_s": 0.0})
        denom = step["total_s"] + load["total_s"]
        if denom > 0:
            out["data_load_overlap_ratio"] = step["total_s"] / denom
    return out


def wire_bytes(metrics_row: Dict[str, Any]) -> Dict[str, float]:
    """Per-step wire-byte gauges from a metrics dump row (the
    qcomm ledgers a pipeline's ``scalar_metrics`` lands under
    ``wire/<tag>/bytes_per_step``).  The reserved ``wire/link:ici`` /
    ``wire/link:dcn`` tags carry the per-link-class split of the same
    bytes (qcomm.record_wire_bytes) — they duplicate the per-tag
    entries, never add to them."""
    flat = metrics_row.get("metrics", {})
    return {
        k: float(v)
        for k, v in sorted(flat.items())
        if isinstance(v, (int, float))
        and (k.startswith("wire/") or k == "obs/wire_bytes_per_step")
    }


def wire_link_split(
    wire: Dict[str, float],
) -> Dict[str, Optional[float]]:
    """ICI/DCN per-step byte totals from a wire-bytes dict (None when
    the run predates link-class accounting)."""
    ici = next(
        (v for k, v in wire.items() if k.startswith("wire/link:ici")), None
    )
    dcn = next(
        (v for k, v in wire.items() if k.startswith("wire/link:dcn")), None
    )
    return {"ici_bytes_per_step": ici, "dcn_bytes_per_step": dcn}


# counters only the per-table/per-feature exporters emit (TieredStats,
# MPZCH modules, PaddingStats per-key, KJT occupancy, sanitize) — their
# presence is what MAKES a middle segment a table; structural families
# (obs internals, serving reasons, wire tags, bucketing aggregates) can
# never spell one of these, so no blacklist of namespaces to maintain
TABLE_EVIDENCE_COUNTERS = frozenset(
    {
        "lookup_count", "hit_count", "insert_count", "eviction_count",
        "collision_count", "occupancy", "occupancy_rate", "hit_rate",
        "mean_occupancy", "id_violations", "fetch_rows", "writeback_rows",
    }
)


def placement_features(
    metrics_row: Dict[str, Any], step: Optional[int] = None
) -> List[Dict[str, Any]]:
    """One row per table from the 3-segment keys of a metrics dump:
    every ``<prefix>/<table>/<counter>`` lands as ``<prefix>_<counter>``
    on the table's row — per-table hotness (lookups/hits), occupancy,
    wire bytes, and hit rates side by side, the feature vector the
    traffic-adaptive planner trains on.  A middle segment counts as a
    table only when some key gives positive hotness evidence for it
    (``TABLE_EVIDENCE_COUNTERS``), so structural 3-segment families
    never pollute the dataset.  Run-level wire link-class totals
    (``wire_link_ici/dcn_bytes_per_step``) ride on every row as context
    features — a table's best placement depends on how DCN-bound the
    run already is."""
    flat = metrics_row.get("metrics", {})
    split = [
        (k.split("/"), v)
        for k, v in flat.items()
        if isinstance(v, (int, float))
    ]
    tables = {
        parts[1]
        for parts, _v in split
        if len(parts) == 3 and parts[2] in TABLE_EVIDENCE_COUNTERS
    }
    by_table: Dict[str, Dict[str, Any]] = {}
    for parts, v in split:
        if len(parts) != 3 or parts[1] not in tables:
            continue
        prefix, table, counter = parts
        by_table.setdefault(table, {})[f"{prefix}_{counter}"] = float(v)
    link = wire_link_split(wire_bytes(metrics_row))
    # the dump row's plan-assumptions fingerprint (the train loop's
    # attach_health stamps it): every feature row references the exact
    # plan-time belief set it was collected under
    assumptions_ref = metrics_row.get("plan_assumptions")
    rows = []
    for table in sorted(by_table):
        row: Dict[str, Any] = {
            "table": table,
            "schema_version": PLACEMENT_FEATURES_SCHEMA_VERSION,
        }
        if assumptions_ref is not None:
            row["plan_assumptions"] = assumptions_ref
        if step is not None:
            row["step"] = step
        row.update(sorted(by_table[table].items()))
        for k, v in link.items():
            if v is not None:
                row[f"wire_link_{k}"] = v
        rows.append(row)
    return rows


_HEALTH_SIGNAL_RE = re.compile(
    r"^health/(?P<table>[^/]+)/(?P<signal>.+)_"
    r"(?P<field>drift|live|expected|alarm)$"
)


def health_summary(metric_rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``--health`` section's data: per-(table, signal) drift state
    from the LAST metrics dump row (``health/<table>/<signal>_*``
    gauges the HealthMonitor exports), total alarm onsets across the
    run (max of the monotonic ``health/monitor/alert_count``), and the
    elastic recovery-time histograms (``elastic/hist/*`` p50/p99 —
    the MTTR *trend*, not one-off bench numbers)."""
    out: Dict[str, Any] = {
        "tables": {}, "alerts": 0.0, "checks": 0.0, "recovery": {},
    }
    if not metric_rows:
        return out
    last = metric_rows[-1].get("metrics", {})
    for k, v in last.items():
        if not isinstance(v, (int, float)):
            continue
        m = _HEALTH_SIGNAL_RE.match(k)
        if m:
            table, signal, field = m.group("table", "signal", "field")
            out["tables"].setdefault(table, {}).setdefault(signal, {})[
                field
            ] = float(v)
        elif k.startswith("elastic/hist/"):
            fam, _, stat = k.rpartition("/")
            if stat in ("p50", "p99", "count"):
                out["recovery"].setdefault(
                    fam[len("elastic/hist/"):], {}
                )[stat] = float(v)
    for row in metric_rows:
        m = row.get("metrics", {})
        a = m.get("health/monitor/alert_count")
        if isinstance(a, (int, float)):
            out["alerts"] = max(out["alerts"], float(a))
        c = m.get("health/monitor/check_count")
        if isinstance(c, (int, float)):
            out["checks"] = max(out["checks"], float(c))
    ref = metric_rows[-1].get("plan_assumptions")
    if ref is not None:
        out["plan_assumptions"] = ref
    return out


def _print_health(summary: Dict[str, Any], out: TextIO) -> None:
    print("## health", file=out)
    print(
        f"checks = {summary['checks']:.0f}  "
        f"alerts = {summary['alerts']:.0f}"
        + (
            f"  plan_assumptions = {summary['plan_assumptions']}"
            if "plan_assumptions" in summary
            else ""
        ),
        file=out,
    )
    for table in sorted(summary["tables"]):
        for signal, f in sorted(summary["tables"][table].items()):
            state = "ALARM" if f.get("alarm") else "ok"
            print(
                f"{table}/{signal}: {state}  "
                f"drift = {f.get('drift', float('nan')):.3f}  "
                f"live = {f.get('live', float('nan')):.4f}  "
                f"expected = {f.get('expected', float('nan')):.4f}",
                file=out,
            )
    if summary["recovery"]:
        print("## recovery trends (elastic/hist)", file=out)
        for fam, stats in sorted(summary["recovery"].items()):
            print(
                f"{fam}: count = {stats.get('count', 0):.0f}  "
                f"p50 = {stats.get('p50', float('nan')):.1f}ms  "
                f"p99 = {stats.get('p99', float('nan')):.1f}ms",
                file=out,
            )


# per-replica gauges the mesh prober exports (everything else under
# mesh/ with three segments is a flattened histogram, not a replica)
_MESH_REPLICA_FIELDS = (
    "healthy", "queue_depth", "ejected", "failure_count",
)


def mesh_summary(metric_rows: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``--mesh`` section's data from the LAST metrics dump row:
    per-replica health/queue-depth/ejection gauges (the
    ``mesh/<replica>/*`` families the router's prober exports), the
    router's retry/hedge/failover/fallback counters, and per-table
    delta-stream freshness (``freshness/<table>/staleness_steps`` plus
    rollback counters)."""
    out: Dict[str, Any] = {
        "replicas": {}, "router": {}, "freshness": {}, "stream": {},
    }
    if not metric_rows:
        return out
    last = metric_rows[-1].get("metrics", {})
    for k, v in last.items():
        if not isinstance(v, (int, float)):
            continue
        parts = k.split("/")
        if k.startswith("mesh/") and len(parts) == 3 and parts[2] in (
            _MESH_REPLICA_FIELDS
        ):
            out["replicas"].setdefault(parts[1], {})[parts[2]] = float(v)
        elif k.startswith("mesh/"):
            out["router"]["/".join(parts[1:])] = float(v)
        elif k.startswith("freshness/") and len(parts) == 3:
            out["freshness"].setdefault(parts[1], {})[parts[2]] = float(v)
        elif k.startswith("freshness/"):
            # stream-global counters (rollback/torn/generation/...) —
            # the chaos drill's headline evidence, kept out of the
            # router bucket so the freshness section renders them
            out["stream"]["/".join(parts[1:])] = float(v)
    return out


def _print_mesh(summary: Dict[str, Any], out: TextIO) -> None:
    print("## serving mesh", file=out)
    for name in sorted(summary["replicas"]):
        f = summary["replicas"][name]
        state = "UP" if f.get("healthy") else "DOWN"
        if f.get("ejected"):
            state += "/EJECTED"
        print(
            f"{name}: {state}  depth = {f.get('queue_depth', 0):.0f}  "
            f"failures = {f.get('failure_count', 0):.0f}",
            file=out,
        )
    if summary["router"]:
        keys = (
            "request_count", "retry_count", "hedge_count",
            "hedge_win_count", "failover_count", "ejected_count",
            "reinstated_count", "degraded_fallback_count",
            "request_latency_ms/p50", "request_latency_ms/p99",
        )
        row = "  ".join(
            f"{k} = {summary['router'][k]:.1f}"
            for k in keys
            if k in summary["router"]
        )
        if row:
            print(row, file=out)
    if summary["freshness"] or summary.get("stream"):
        print("## freshness (delta stream)", file=out)
        for table in sorted(summary["freshness"]):
            f = summary["freshness"][table]
            print(
                f"{table}: staleness = "
                f"{f.get('staleness_steps', float('nan')):.0f} steps  "
                f"applied_rows = {f.get('applied_rows', 0):.0f}  "
                f"rollbacks = {f.get('rollback_count', 0):.0f}",
                file=out,
            )
        stream = summary.get("stream", {})
        row = "  ".join(
            f"{k} = {stream[k]:.0f}"
            for k in (
                "applied_generation_count", "rollback_count",
                "torn_publish_count", "apply_error_count",
                "generation", "applied_step",
            )
            if k in stream
        )
        if row:
            print(row, file=out)


def flagship_summary(
    metric_rows: Sequence[Dict[str, Any]], assumptions: Any
) -> Dict[str, Any]:
    """The ``--assumptions`` section's data: the composed run's
    per-step wire bytes split by link class (the LAST metrics dump
    row's ``wire/link:ici`` / ``wire/link:dcn`` ledgers) next to the
    per-link expectations stamped in the plan's ``PlanAssumptions``
    (``wire_bytes_per_step``), with observed/expected ratios — so
    drift of the COMPOSED number is visible in the same health path
    the per-subsystem gauges use.  ``assumptions`` is a loaded
    ``obs.PlanAssumptions``."""
    out: Dict[str, Any] = {
        "links": {},
        "fingerprint": assumptions.fingerprint(),
        "world_size": assumptions.world_size,
        "hierarchical": bool(assumptions.hierarchical),
    }
    observed: Dict[str, Optional[float]] = {"ici": None, "dcn": None}
    if metric_rows:
        link = wire_link_split(wire_bytes(metric_rows[-1]))
        observed["ici"] = link["ici_bytes_per_step"]
        observed["dcn"] = link["dcn_bytes_per_step"]
    for name in ("ici", "dcn"):
        expected = assumptions.wire_bytes_per_step.get(name)
        obs_v = observed[name]
        ratio = None
        if expected and obs_v is not None:
            ratio = float(obs_v) / float(expected)
        out["links"][name] = {
            "expected_bytes_per_step": (
                float(expected) if expected is not None else None
            ),
            "observed_bytes_per_step": obs_v,
            "ratio": ratio,
        }
    return out


def _print_flagship(summary: Dict[str, Any], out: TextIO) -> None:
    print("## flagship (composed vs plan assumptions)", file=out)
    print(
        f"plan_assumptions = {summary['fingerprint']}  "
        f"world_size = {summary['world_size']}  "
        f"hierarchical = {summary['hierarchical']}",
        file=out,
    )
    for name, f in sorted(summary["links"].items()):
        exp, obs_v, ratio = (
            f["expected_bytes_per_step"],
            f["observed_bytes_per_step"],
            f["ratio"],
        )
        print(
            f"link:{name}: expected = "
            f"{'n/a' if exp is None else f'{exp:.1f}'}  observed = "
            f"{'n/a' if obs_v is None else f'{obs_v:.1f}'}  ratio = "
            f"{'n/a' if ratio is None else f'{ratio:.4f}'}",
            file=out,
        )


def validate_chrome_trace(path: str) -> int:
    """Schema-check a Chrome trace-event JSON file; returns the number
    of complete ("X") events, raising ``ValueError`` on malformed
    structure (the checks the tests apply)."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("trace has no traceEvents list")
    n = 0
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"malformed trace event: {ev!r}")
        if ev["ph"] == "X":
            for field in ("name", "ts", "dur", "pid", "tid"):
                if field not in ev:
                    raise ValueError(f"X event missing {field}: {ev!r}")
            if not isinstance(ev["ts"], (int, float)) or not isinstance(
                ev["dur"], (int, float)
            ):
                raise ValueError(f"non-numeric ts/dur: {ev!r}")
            n += 1
    return n


def report(
    events_path: Optional[str] = None,
    metrics_path: Optional[str] = None,
    trace_path: Optional[str] = None,
    placement_out: Optional[str] = None,
    out: Optional[TextIO] = None,
    health: bool = False,
    mesh: bool = False,
    assumptions_path: Optional[str] = None,
) -> Dict[str, Any]:
    """Assemble and print the run report; returns the structured data
    (what the tests and ``chip_smoke.py``'s checks consume)."""
    out = out if out is not None else sys.stdout
    result: Dict[str, Any] = {}
    if events_path and os.path.exists(events_path):
        spans = span_records(load_events(events_path))
        result["stages"] = stage_stats(spans)
        result["overlap"] = overlap_from_spans(spans)
        print(f"## stages ({len(spans)} spans)", file=out)
        width = max((len(n) for n in result["stages"]), default=10)
        print(
            f"{'stage':<{width}}  {'count':>7}  {'total_s':>9}  "
            f"{'p50_ms':>9}  {'p99_ms':>9}",
            file=out,
        )
        for name, s in result["stages"].items():
            print(
                f"{name:<{width}}  {s['count']:>7}  {s['total_s']:>9.3f}  "
                f"{s['p50_ms']:>9.3f}  {s['p99_ms']:>9.3f}",
                file=out,
            )
        print("## overlap", file=out)
        for k, v in result["overlap"].items():
            print(f"{k} = {'n/a' if v is None else f'{v:.4f}'}", file=out)
    rows = []
    if metrics_path and os.path.exists(metrics_path):
        dumps = load_metrics(metrics_path)
        if dumps:
            last = dumps[-1]
            result["wire_bytes"] = wire_bytes(last)
            if result["wire_bytes"]:
                print("## wire bytes / step", file=out)
                for k, v in result["wire_bytes"].items():
                    print(f"{k} = {v:.1f}", file=out)
                link = wire_link_split(result["wire_bytes"])
                if any(v is not None for v in link.values()):
                    result["wire_link_split"] = link
                    print("## wire link split / step", file=out)
                    for k, v in link.items():
                        print(
                            f"{k} = {'n/a' if v is None else f'{v:.1f}'}",
                            file=out,
                        )
            rows = placement_features(last, step=last.get("step"))
            result["placement_features"] = rows
            if health:
                result["health"] = health_summary(dumps)
                _print_health(result["health"], out)
            if mesh:
                result["mesh"] = mesh_summary(dumps)
                _print_mesh(result["mesh"], out)
            if assumptions_path and os.path.exists(assumptions_path):
                from torchrec_tpu_torch.obs.assumptions import PlanAssumptions

                result["flagship"] = flagship_summary(
                    dumps, PlanAssumptions.load(assumptions_path)
                )
                _print_flagship(result["flagship"], out)
    if trace_path and os.path.exists(trace_path):
        result["trace_events"] = validate_chrome_trace(trace_path)
        print(
            f"## trace: {result['trace_events']} events ({trace_path})",
            file=out,
        )
    if placement_out and rows:
        with open(placement_out, "w", encoding="utf-8") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(
            f"## placement features: {len(rows)} rows -> {placement_out}",
            file=out,
        )
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry (``python -m torchrec_tpu_torch.obs report ...``)."""
    ap = argparse.ArgumentParser(
        prog="python -m torchrec_tpu_torch.obs",
        description="telemetry report over a run's artifacts",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="per-stage p50/p99, overlap, wire bytes")
    rp.add_argument("--dir", help="artifact dir (events.jsonl, metrics.jsonl, trace.json)")
    rp.add_argument("--events", help="span/event JSONL path")
    rp.add_argument("--metrics", help="metrics dump JSONL path")
    rp.add_argument("--trace", help="chrome trace JSON path")
    rp.add_argument(
        "--placement-features",
        help="write per-table placement-feature rows (JSONL) here",
    )
    rp.add_argument(
        "--health",
        action="store_true",
        help="print drift/alarm state and recovery-time trends from "
        "the health/* and elastic/hist/* metric families",
    )
    rp.add_argument(
        "--mesh",
        action="store_true",
        help="print serving-mesh replica health, router retry/hedge/"
        "ejection counters, and delta-stream freshness from the "
        "mesh/* and freshness/* metric families",
    )
    rp.add_argument(
        "--assumptions",
        help="PlanAssumptions JSON path: print the flagship section "
        "(composed per-step wire bytes by link class vs the stamped "
        "per-link expectations)",
    )
    args = ap.parse_args(argv)
    events, metrics, trace = args.events, args.metrics, args.trace
    if args.dir:
        events = events or os.path.join(args.dir, "events.jsonl")
        metrics = metrics or os.path.join(args.dir, "metrics.jsonl")
        trace = trace or os.path.join(args.dir, "trace.json")
    if not any(
        p and os.path.exists(p) for p in (events, metrics, trace)
    ):
        print("no artifacts found (pass --dir or explicit paths)",
              file=sys.stderr)
        return 2
    report(
        events, metrics, trace, args.placement_features,
        health=args.health, mesh=args.mesh,
        assumptions_path=args.assumptions,
    )
    return 0
