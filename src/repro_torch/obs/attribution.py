"""Decision attribution: charge dollars and SLO damage to decisions.

SkyServe's wins come from control-plane *decisions*; an aggregate cost
number cannot say which decision earned or wasted it.  This module
replays an event log and produces the ledger:

* **Cost** — every ``provision`` lifecycle event opens a billing span
  (hourly price × lifetime to its ``dead`` event, or to the run horizon
  for replicas alive at the end), and the span is charged to the launch
  decision that produced the replica (launch decisions record the
  ``instance_id`` they created).  Spans no decision claims (e.g. logs
  truncated mid-run) fall into ``"unattributed"``.
* **Failures** — failed-request deltas between consecutive window
  samples are charged to the most recent preemption / launch-failure
  inside a lookback window, else to ``steady_state``; without window
  samples (detail < full) only the totals row is emitted.

The report is pure arithmetic over records — it works identically on
live events and on a JSONL file read back.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Optional, Union

from repro_torch.obs.events import SCHEMA_VERSION, Event

__all__ = ["attribution_report"]

Recordish = Union[Event, Mapping[str, Any]]

#: a failure is blamed on a disruption at most this many seconds older
FAILURE_LOOKBACK_S = 600.0


def _records(events: Iterable[Recordish]) -> List[Dict[str, Any]]:
    out = []
    for e in events:
        out.append(e.to_record() if isinstance(e, Event) else dict(e))
    return out


#: span segments a request spends *waiting* in (vs being served)
_WAIT_SEGS = ("queue", "rqueue", "admit", "transfer")


def _span_section(spans: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Aggregate request-span records into a where-time-goes ledger."""
    n = 0
    outcomes: Dict[str, int] = {}
    seg_s: Dict[str, float] = {}
    waits: List[float] = []
    retried = migrated = 0
    for rec in spans:
        n += 1
        oc = str(rec.get("outcome", "unresolved"))
        outcomes[oc] = outcomes.get(oc, 0) + 1
        if int(rec.get("attempts", 1)) > 1:
            retried += 1
        wait = 0.0
        hop = False
        for s in rec.get("segments") or []:
            dur = max(float(s["t1_s"]) - float(s["t0_s"]), 0.0)
            name = str(s["name"])
            seg_s[name] = seg_s.get(name, 0.0) + dur
            if name in _WAIT_SEGS:
                wait += dur
            hop = hop or name == "transfer"
        migrated += hop
        waits.append(wait)
    waits.sort()
    p95 = waits[min(int(0.95 * len(waits)), len(waits) - 1)] \
        if waits else None
    return {
        "n_spans": n,
        "outcomes": {k: outcomes[k] for k in sorted(outcomes)},
        "n_retried": retried,
        "n_migrated": migrated,
        "seconds_by_segment": {
            k: round(seg_s[k], 6) for k in sorted(seg_s)
        },
        "wait_mean_s": (
            round(sum(waits) / len(waits), 6) if waits else None
        ),
        "wait_p95_s": round(p95, 6) if p95 is not None else None,
    }


def attribution_report(
    events: Iterable[Recordish],
    *,
    horizon_s: Optional[float] = None,
    top: int = 10,
    spans: Optional[Iterable[Mapping[str, Any]]] = None,
) -> Dict[str, Any]:
    """Render the decision-attribution ledger for one event stream.

    Pass ``spans`` (schema-v1 request-span records) to extend the
    ledger with a ``request_spans`` section: per-outcome counts,
    seconds charged to each span segment (where sampled requests spend
    their time), and queueing-wait aggregates.
    """
    span_records = list(spans) if spans is not None else None
    records = _records(events)
    if horizon_s is None:
        horizon_s = max(
            (float(r.get("t", 0.0)) for r in records), default=0.0
        )

    # --- index decisions by the instance they launched ----------------
    launch_by_iid: Dict[int, Dict[str, Any]] = {}
    decisions: List[Dict[str, Any]] = []
    for r in records:
        if r.get("event") != "decision":
            continue
        d = {
            "t": float(r.get("t", 0.0)),
            "action": r.get("action"),
            "zone": r.get("zone"),
            "instance_id": r.get("instance_id"),
            "reason": r.get("reason"),
            "cost_usd": 0.0,
            "replica_lifetime_s": 0.0,
        }
        decisions.append(d)
        if d["instance_id"] is not None and str(
            d["action"] or ""
        ).startswith("launch"):
            launch_by_iid[int(d["instance_id"])] = d

    # --- billing spans from lifecycle events --------------------------
    provision: Dict[int, Dict[str, Any]] = {}
    spans: List[Dict[str, Any]] = []
    for r in records:
        if r.get("event") != "lifecycle":
            continue
        iid = int(r.get("instance_id", -1))
        phase = r.get("phase")
        if phase == "provision":
            provision[iid] = r
        elif phase == "dead":
            p = provision.pop(iid, None)
            if p is not None:
                spans.append({
                    "instance_id": iid,
                    "t0": float(p.get("t", 0.0)),
                    "t1": float(r.get("t", 0.0)),
                    "hourly_price": float(p.get("hourly_price", 0.0)),
                    "kind": p.get("kind"),
                    "zone": p.get("zone"),
                })
    for iid, p in sorted(provision.items()):     # alive at run end
        spans.append({
            "instance_id": iid,
            "t0": float(p.get("t", 0.0)),
            "t1": float(horizon_s),
            "hourly_price": float(p.get("hourly_price", 0.0)),
            "kind": p.get("kind"),
            "zone": p.get("zone"),
        })

    # --- charge spans to decisions ------------------------------------
    unattributed = 0.0
    by_action: Dict[str, Dict[str, float]] = {}
    for s in spans:
        lifetime = max(s["t1"] - s["t0"], 0.0)
        cost = s["hourly_price"] * lifetime / 3600.0
        d = launch_by_iid.get(s["instance_id"])
        if d is None:
            unattributed += cost
            bucket = "unattributed"
        else:
            d["cost_usd"] += cost
            d["replica_lifetime_s"] += lifetime
            bucket = str(d["action"])
        agg = by_action.setdefault(
            bucket, {"cost_usd": 0.0, "n_replicas": 0}
        )
        agg["cost_usd"] += cost
        agg["n_replicas"] += 1

    # --- failure attribution from window samples ----------------------
    disruptions: List[Dict[str, Any]] = [
        r for r in records
        if r.get("event") == "launch_failure"
        or (r.get("event") == "lifecycle"
            and r.get("phase") == "dead"
            and r.get("cause") == "preemption")
    ]
    failures = {"preemption": 0, "launch_failure": 0, "steady_state": 0}
    windows = [r for r in records if r.get("event") == "window"]
    prev_failed = 0
    for w in windows:
        t = float(w.get("t", 0.0))
        n_failed = int(w.get("n_failed", 0))
        delta = n_failed - prev_failed
        prev_failed = n_failed
        if delta <= 0:
            continue
        blame = "steady_state"
        best_t = None
        for d in disruptions:
            td = float(d.get("t", 0.0))
            if td <= t and t - td <= FAILURE_LOOKBACK_S:
                if best_t is None or td >= best_t:
                    best_t = td
                    blame = (
                        "launch_failure"
                        if d.get("event") == "launch_failure"
                        else "preemption"
                    )
        failures[blame] += delta

    total_failed = int(windows[-1].get("n_failed", 0)) if windows else None

    decisions.sort(key=lambda d: (-d["cost_usd"], d["t"]))
    total_cost = sum(s["hourly_price"] * max(s["t1"] - s["t0"], 0.0)
                     for s in spans) / 3600.0
    return {
        "schema": SCHEMA_VERSION,
        "horizon_s": float(horizon_s),
        "total_cost_usd": round(total_cost, 6),
        "unattributed_cost_usd": round(unattributed, 6),
        "n_decisions": len(decisions),
        "n_replicas": len(spans),
        "cost_by_action": {
            k: {
                "cost_usd": round(v["cost_usd"], 6),
                "n_replicas": int(v["n_replicas"]),
            }
            for k, v in sorted(by_action.items())
        },
        "top_decisions": [
            {
                "t": d["t"],
                "action": d["action"],
                "zone": d["zone"],
                "instance_id": d["instance_id"],
                "cost_usd": round(d["cost_usd"], 6),
                "replica_lifetime_s": round(d["replica_lifetime_s"], 6),
                "reason": d["reason"],
            }
            for d in decisions[: max(top, 0)]
        ],
        "failed_requests": {
            "total": total_failed,
            "by_cause": failures if windows else None,
            "note": (
                "per-cause attribution needs window samples "
                "(observability detail: full)"
                if not windows else None
            ),
        },
        **(
            {"request_spans": _span_section(span_records)}
            if span_records is not None else {}
        ),
    }
