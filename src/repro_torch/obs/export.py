"""Exporters: byte-deterministic JSONL logs and Chrome-trace timelines.

JSONL is the canonical artifact (one event record per line, sorted keys,
compact separators, no wall-clock stamps) — two decision-identical runs
produce byte-identical files, which is what the differential tests pin.
The Chrome-trace converter renders the same records as a Perfetto /
``chrome://tracing`` loadable timeline: one track per replica with
provisioning/serving/grace spans, a policy track with instant decision
markers, and counter tracks from the window samples.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

from repro_torch.obs.events import SCHEMA_VERSION, Event

# the trace's process name, the reference's own, so that both packages
# write the same bytes for the same run
_PROCESS_NAME = "repro.obs run"

__all__ = [
    "dumps_jsonl",
    "write_jsonl",
    "read_jsonl",
    "chrome_trace",
    "write_chrome_trace",
    "summarize",
    "diff_summaries",
]

Recordish = Union[Event, Mapping[str, Any]]


def _as_records(events: Iterable[Recordish]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for e in events:
        out.append(e.to_record() if isinstance(e, Event) else dict(e))
    return out


def dumps_jsonl(events: Iterable[Recordish]) -> str:
    """Serialize events to JSONL text (deterministic bytes)."""
    lines = [
        json.dumps(r, sort_keys=True, separators=(",", ":"))
        for r in _as_records(events)
    ]
    return "\n".join(lines) + ("\n" if lines else "")


def write_jsonl(events: Iterable[Recordish], path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(dumps_jsonl(events))
    return path


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    records: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


# ----------------------------------------------------------------------
# Chrome trace events (Perfetto-loadable)

def _us(t: float) -> float:
    return round(t * 1e6, 3)


def chrome_trace(
    events: Iterable[Recordish],
    spans: Optional[Iterable[Mapping[str, Any]]] = None,
    token_windows: Optional[Iterable[Mapping[str, Any]]] = None,
) -> Dict[str, Any]:
    """Records -> a Chrome-trace-event JSON object.

    Load the written file in https://ui.perfetto.dev (or
    ``chrome://tracing``): replicas appear as one timeline row each
    (provisioning -> serving -> grace spans), policy decisions and
    preemption warnings as instant markers, queue depth and fleet $/h
    as counter tracks.

    ``spans`` takes schema-v1 request-span records
    (``SpanCollector.records()``): each sampled request renders as an
    outer slice with its segments nested inside, grouped per replica
    (run ordinal) in a second "requests (sampled)" process.
    ``token_windows`` takes ``TokenStats.windows`` entries and adds
    goodput / windowed-SLO-attainment counter tracks.
    """
    records = _as_records(events)
    trace: List[Dict[str, Any]] = [
        {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
         "args": {"name": _PROCESS_NAME}},
        {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
         "args": {"name": "policy"}},
    ]
    # one thread per replica, tid assigned in order of first appearance
    tids: Dict[int, int] = {}

    def tid_of(instance_id: int) -> int:
        tid = tids.get(instance_id)
        if tid is None:
            tid = tids[instance_id] = len(tids) + 1
            trace.append({
                "ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                "args": {"name": f"replica {instance_id}"},
            })
        return tid

    # span assembly state per replica
    open_span: Dict[int, Dict[str, Any]] = {}
    horizon = 0.0
    for r in records:
        horizon = max(horizon, float(r.get("t", 0.0)))
    for r in records:
        kind = r.get("event")
        t = float(r.get("t", 0.0))
        if kind == "decision":
            trace.append({
                "ph": "i", "pid": 0, "tid": 0, "s": "t",
                "ts": _us(t), "name": r.get("action", "decision"),
                "args": {
                    k: r[k] for k in ("zone", "instance_id", "reason")
                    if k in r
                },
            })
        elif kind == "lifecycle":
            iid = int(r.get("instance_id", -1))
            tid = tid_of(iid)
            phase = r.get("phase")
            if phase == "provision":
                open_span[iid] = {
                    "t0": t, "name": "provisioning",
                    "args": {
                        k: r[k]
                        for k in ("zone", "kind", "hourly_price")
                        if k in r
                    },
                }
            elif phase == "ready":
                span = open_span.pop(iid, None)
                if span is not None:
                    trace.append({
                        "ph": "X", "pid": 0, "tid": tid,
                        "ts": _us(span["t0"]),
                        "dur": _us(t - span["t0"]),
                        "name": span["name"], "args": span["args"],
                    })
                open_span[iid] = {"t0": t, "name": "serving", "args": {}}
            elif phase in ("draining", "migrating"):
                trace.append({
                    "ph": "i", "pid": 0, "tid": tid, "s": "t",
                    "ts": _us(t), "name": phase, "args": {},
                })
            elif phase == "dead":
                span = open_span.pop(iid, None)
                if span is not None:
                    trace.append({
                        "ph": "X", "pid": 0, "tid": tid,
                        "ts": _us(span["t0"]),
                        "dur": _us(t - span["t0"]),
                        "name": span["name"], "args": span["args"],
                    })
                trace.append({
                    "ph": "i", "pid": 0, "tid": tid, "s": "t",
                    "ts": _us(t),
                    "name": f"dead ({r.get('cause', 'unknown')})",
                    "args": {},
                })
        elif kind == "warning":
            iid = r.get("instance_id")
            tid = tid_of(int(iid)) if iid is not None else 0
            trace.append({
                "ph": "i", "pid": 0, "tid": tid, "s": "t",
                "ts": _us(t), "name": "preemption warning",
                "args": {"zone": r.get("zone")},
            })
        elif kind == "launch_failure":
            trace.append({
                "ph": "i", "pid": 0, "tid": 0, "s": "t",
                "ts": _us(t), "name": "launch failure",
                "args": {"zone": r.get("zone"), "kind": r.get("kind")},
            })
        elif kind == "migration_plan":
            iid = int(r.get("instance_id", -1))
            trace.append({
                "ph": "i", "pid": 0, "tid": tid_of(iid), "s": "t",
                "ts": _us(t), "name": "migration plan",
                "args": {
                    k: r[k]
                    for k in ("n_drained", "n_migrated", "n_killed",
                              "migrated_kv_tokens", "transfer_s")
                    if k in r
                },
            })
        elif kind == "window":
            for counter, field in (
                ("queue depth", "queue_depth"),
                ("fleet $/h", "cost_per_h"),
                ("ready replicas", "n_ready"),
            ):
                if field in r:
                    trace.append({
                        "ph": "C", "pid": 0, "ts": _us(t),
                        "name": counter,
                        "args": {counter: r[field]},
                    })
    # close spans still open at the horizon (replicas alive at run end)
    for iid in sorted(open_span):
        span = open_span[iid]
        trace.append({
            "ph": "X", "pid": 0, "tid": tid_of(iid),
            "ts": _us(span["t0"]),
            "dur": _us(max(horizon - span["t0"], 0.0)),
            "name": span["name"], "args": span["args"],
        })
    if spans is not None:
        trace.extend(_span_slices(list(spans)))
    if token_windows is not None:
        for w in token_windows:
            if w.get("post_horizon"):
                continue      # drain bucket: no defined rate
            t0 = float(w["t0_s"])
            trace.append({
                "ph": "C", "pid": 0, "ts": _us(t0),
                "name": "goodput req/s",
                "args": {"goodput req/s": w["goodput_rps"]},
            })
            done = int(w.get("n_completed", 0))
            trace.append({
                "ph": "C", "pid": 0, "ts": _us(t0),
                "name": "window SLO attainment",
                "args": {"window SLO attainment": (
                    round(int(w.get("n_slo_ok", 0)) / done, 6)
                    if done else 0.0
                )},
            })
    return {
        "traceEvents": trace,
        "displayTimeUnit": "ms",
        "otherData": {"schema": SCHEMA_VERSION},
    }


#: pid of the request-span process (keeps replica lifecycle rows clean)
_SPAN_PID = 1


def _span_slices(spans: List[Mapping[str, Any]]) -> List[Dict[str, Any]]:
    """Request-span records -> nested per-replica Perfetto slices."""
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": _SPAN_PID, "tid": 0, "name": "process_name",
         "args": {"name": "requests (sampled)"}},
    ]
    named: set = set()
    for rec in spans:
        segs = list(rec.get("segments") or [])
        if not segs:
            continue
        # the request rides the track of the first replica that served
        # it (migration hops stay visible as `transfer` child slices)
        rep = next(
            (int(s["replica"]) for s in segs if "replica" in s), -1
        )
        tid = rep + 1          # -1 (never dispatched) -> tid 0
        if tid not in named:
            named.add(tid)
            out.append({
                "ph": "M", "pid": _SPAN_PID, "tid": tid,
                "name": "thread_name",
                "args": {"name": (f"replica #{rep}" if rep >= 0
                                  else "undispatched")},
            })
        t0 = float(rec["arrival_s"])
        t1 = max(float(s["t1_s"]) for s in segs)
        args = {
            k: rec[k]
            for k in ("outcome", "attempts", "rtt_s", "e2e_s",
                      "first_token_s")
            if k in rec
        }
        out.append({
            "ph": "X", "pid": _SPAN_PID, "tid": tid,
            "ts": _us(t0), "dur": _us(max(t1 - t0, 0.0)),
            "name": f"req #{rec['ordinal']}", "args": args,
        })
        for s in segs:
            sargs = {
                k: v for k, v in s.items()
                if k not in ("name", "t0_s", "t1_s")
            }
            out.append({
                "ph": "X", "pid": _SPAN_PID, "tid": tid,
                "ts": _us(float(s["t0_s"])),
                "dur": _us(max(float(s["t1_s"]) - float(s["t0_s"]),
                               0.0)),
                "name": s["name"], "args": sargs,
            })
    return out


def write_chrome_trace(
    events: Iterable[Recordish],
    path: str,
    spans: Optional[Iterable[Mapping[str, Any]]] = None,
    token_windows: Optional[Iterable[Mapping[str, Any]]] = None,
) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            chrome_trace(events, spans=spans,
                         token_windows=token_windows),
            f, sort_keys=True, separators=(",", ":"),
        )
    return path


# ----------------------------------------------------------------------
# summaries

def summarize(events: Iterable[Recordish]) -> Dict[str, Any]:
    """Aggregate a record stream into a one-screen run summary."""
    records = _as_records(events)
    counts: Dict[str, int] = {}
    decisions: Dict[str, int] = {}
    lifecycle: Dict[str, int] = {}
    zones: Dict[str, int] = {}
    horizon = 0.0
    last_window: Optional[Dict[str, Any]] = None
    for r in records:
        kind = str(r.get("event"))
        counts[kind] = counts.get(kind, 0) + 1
        horizon = max(horizon, float(r.get("t", 0.0)))
        if kind == "decision":
            a = str(r.get("action"))
            decisions[a] = decisions.get(a, 0) + 1
            if r.get("zone") and a.startswith("launch"):
                z = str(r["zone"])
                zones[z] = zones.get(z, 0) + 1
        elif kind == "lifecycle":
            p = str(r.get("phase"))
            lifecycle[p] = lifecycle.get(p, 0) + 1
        elif kind == "window":
            last_window = r
    out: Dict[str, Any] = {
        "schema": SCHEMA_VERSION,
        "n_events": len(records),
        "horizon_s": horizon,
        "event_counts": {k: counts[k] for k in sorted(counts)},
        "decisions": {k: decisions[k] for k in sorted(decisions)},
        "lifecycle": {k: lifecycle[k] for k in sorted(lifecycle)},
        "launches_by_zone": {k: zones[k] for k in sorted(zones)},
    }
    if last_window is not None:
        out["final_window"] = {
            k: v for k, v in last_window.items()
            if k not in ("schema", "event")
        }
    return out


def diff_summaries(
    a: Iterable[Recordish], b: Iterable[Recordish]
) -> Dict[str, Any]:
    """Field-wise deltas between two run summaries (b − a)."""
    sa, sb = summarize(a), summarize(b)

    def delta(key: str) -> Dict[str, Any]:
        da, db = sa.get(key, {}), sb.get(key, {})
        keys = sorted(set(da) | set(db))
        return {
            k: {"a": da.get(k, 0), "b": db.get(k, 0),
                "delta": db.get(k, 0) - da.get(k, 0)}
            for k in keys
            if da.get(k, 0) != db.get(k, 0)
        }

    return {
        "schema": SCHEMA_VERSION,
        "n_events": {"a": sa["n_events"], "b": sb["n_events"],
                     "delta": sb["n_events"] - sa["n_events"]},
        "event_counts": delta("event_counts"),
        "decisions": delta("decisions"),
        "lifecycle": delta("lifecycle"),
        "launches_by_zone": delta("launches_by_zone"),
        "identical": sa == sb,
    }
