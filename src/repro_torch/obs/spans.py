"""Per-request data-plane spans (deterministic, run-ordinal keyed).

A *span* is the full life of one sampled request — queue wait, dispatch
(LB choice), replica queue / continuous-batch admission, prefill chunks,
decode, migration hops (drain / transfer / resume, linked to the
migration plan event), preemption retries and the final
completion / timeout / rejection — recorded as one schema-v1 JSON
record with contiguous, time-ordered segments.

Design constraints (mirrors ``repro_torch.obs.events``):

* **byte-identical across engines** — the legacy ``ServingSimulator``
  and the ``VectorizedServingEngine`` tap the collector with the same
  float values at the same simulated instants, and records serialize
  sorted by ordinal, so the JSONL streams match byte for byte
  regardless of internal iteration order;
* **deterministic sampling without an RNG** — whether a request is
  traced depends only on its run ordinal (position in the stable
  arrival-time sort of the request tape) and the configured rate, via a
  Knuth multiplicative hash.  No RNG state, no seed plumbing, and every
  engine (including the card engine's phase-B reconstruction) agrees on the
  sampled set by construction;
* **cheap when off** — engines bind ``want_l`` / ``want_ids`` locally
  and skip all collector calls for unsampled ordinals, so the default
  1% rate stays inside the observability overhead budget.

Per-request call-sequence contract (what byte-identity actually
requires): for any single ordinal, both engines issue the same
collector calls with the same arguments in the same order.  Cross
-request interleaving is free to differ — records are keyed and sorted
by ordinal.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.events import SCHEMA_VERSION

__all__ = ["span_sampled", "SpanCollector"]

#: Knuth multiplicative hash constant (2^32 / phi)
_HASH_MULT = 2654435761
_HASH_ADD = 12345
_HASH_MOD = 1 << 32


def span_sampled(ordinal: int, rate: float) -> bool:
    """Deterministic, seedless per-ordinal sampling decision."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = (ordinal * _HASH_MULT + _HASH_ADD) & 0xFFFFFFFF
    return h < int(rate * _HASH_MOD)


class _Trace:
    __slots__ = (
        "arrival",
        "rtt",
        "attempts",
        "outcome",
        "finish",
        "e2e",
        "first",
        "segs",
        "open",
    )

    def __init__(self, arrival: float) -> None:
        self.arrival = float(arrival)
        self.rtt: Optional[float] = None
        self.attempts = 1
        self.outcome: Optional[str] = None
        self.finish: Optional[float] = None
        self.e2e: Optional[float] = None
        self.first: Optional[float] = None
        self.segs: List[dict] = []
        self.open: Optional[dict] = None


class SpanCollector:
    """Collects per-request span traces for the sampled ordinal set.

    ``requests`` is the raw request tape; ordinals are positions in the
    stable sort by ``arrival_s`` — exactly the tape order both serving
    engines compile, so the vector engine's tape index *is* the
    ordinal and the legacy engine maps ``request.id`` through
    ``want_ids``.
    """

    def __init__(self, rate: float, requests: Sequence) -> None:
        self.rate = float(rate)
        reqs = sorted(requests, key=lambda r: r.arrival_s)
        self.n = len(reqs)
        #: per-ordinal sampled flag (vector engine: ordinal == index)
        self.want_l: List[bool] = [
            span_sampled(o, self.rate) for o in range(self.n)
        ]
        #: request id -> ordinal, sampled requests only (legacy engine)
        self.want_ids: Dict[int, int] = {
            r.id: o for o, r in enumerate(reqs) if self.want_l[o]
        }
        self._traces: Dict[int, _Trace] = {}

    # -- internals ----------------------------------------------------
    def _get(self, o: int, arrival: float) -> _Trace:
        tr = self._traces.get(o)
        if tr is None:
            tr = self._traces[o] = _Trace(arrival)
            tr.open = {"name": "queue", "t0_s": tr.arrival}
        return tr

    @staticmethod
    def _close(tr: _Trace, t: float, cut: Optional[str] = None) -> None:
        seg = tr.open
        if seg is None:
            return
        seg["t1_s"] = float(t)
        if cut is not None:
            seg["cut"] = cut
        tr.segs.append(seg)
        tr.open = None

    @staticmethod
    def _open(tr: _Trace, name: str, t: float, **kw) -> None:
        seg = {"name": name, "t0_s": float(t)}
        for k, v in kw.items():
            if v is not None:
                seg[k] = v
        tr.open = seg

    # -- request-model + shared taps ----------------------------------
    def dispatch(
        self, o: int, t: float, replica: int, rtt_s: float,
        arrival: float, token: bool = False,
    ) -> None:
        """LB routed the request to ``replica`` (dense run ordinal)."""
        tr = self._get(o, arrival)
        if tr.outcome is not None:
            return
        self._close(tr, t)
        tr.rtt = float(rtt_s)
        self._open(
            tr, "admit" if token else "rqueue", t, replica=int(replica)
        )

    def start(self, o: int, t: float) -> None:
        """Request left the replica queue and began service."""
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        rep = (tr.open or {}).get("replica")
        self._close(tr, t)
        self._open(tr, "service", t, replica=rep)

    def finish(self, o: int, t: float, outcome: str, e2e: float) -> None:
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        self._close(tr, t)
        tr.outcome = outcome
        tr.finish = float(t)
        tr.e2e = float(e2e)

    def expire(self, o: int, t: float, arrival: float) -> None:
        """Request timed out in the pending or replica queue."""
        tr = self._get(o, arrival)
        if tr.outcome is not None:     # e.g. already rejected
            return
        self._close(tr, t, cut="timeout")
        tr.outcome = "timeout"
        tr.finish = float(t)

    def reject(self, o: int, t: float) -> None:
        """KV-budget admission rejected the request outright."""
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        self._close(tr, t, cut="reject")
        tr.outcome = "rejected"
        tr.finish = float(t)

    def preempt(self, o: int, t: float) -> None:
        """Replica died; the request re-pends (KV/progress lost)."""
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        self._close(tr, t, cut="preempt")
        tr.attempts += 1
        self._open(tr, "queue", t)

    # -- token-model taps (continuous batching) -----------------------
    def token_join(self, o: int, t: float, prefilling: bool) -> None:
        """Sequence admitted into a running batch."""
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        rep = (tr.open or {}).get("replica")
        self._close(tr, t)
        if prefilling:
            self._open(
                tr, "prefill", t, replica=rep, chunks=0, tokens=0
            )
        else:
            self._open(tr, "decode", t, replica=rep)

    def token_chunk(self, o: int, tokens: int) -> None:
        """One chunked-prefill slice processed for this sequence."""
        tr = self._traces.get(o)
        if tr is None or tr.open is None or tr.outcome is not None:
            return
        seg = tr.open
        seg["chunks"] = seg.get("chunks", 0) + 1
        seg["tokens"] = seg.get("tokens", 0) + int(tokens)

    def token_prefill_done(self, o: int, t: float) -> None:
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        rep = (tr.open or {}).get("replica")
        self._close(tr, t)
        self._open(tr, "decode", t, replica=rep)

    def finish_token(
        self, o: int, first_s: float, finish_s: float,
        overhead_s: float, outcome: str, e2e: float,
    ) -> None:
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        end = finish_s - overhead_s
        rep = (tr.open or {}).get("replica")
        self._close(tr, end)
        if overhead_s > 0.0:
            self._open(tr, "overhead", end, replica=rep)
            self._close(tr, finish_s)
        tr.outcome = outcome
        tr.finish = float(finish_s)
        tr.e2e = float(e2e)
        if math.isfinite(first_s):
            tr.first = float(first_s)

    def migrate(
        self, o: int, t: float, to_replica: int,
        transfer_s: float, plan_t: float,
    ) -> None:
        """Preemption warning: KV state starts transferring."""
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        self._close(tr, t, cut="migrate")
        self._open(
            tr, "transfer", t,
            to=int(to_replica),
            transfer_s=float(transfer_s),
            plan_t_s=float(plan_t),
        )

    def migrate_arrive(self, o: int, t: float, replica: int) -> None:
        """Transfer complete; sequence waits to rejoin a batch."""
        tr = self._traces.get(o)
        if tr is None or tr.outcome is not None:
            return
        self._close(tr, t)
        self._open(tr, "admit", t, replica=int(replica))

    # -- finalization + export ----------------------------------------
    def finalize(self, horizon_s: float) -> None:
        """Close traces still open at the end-of-run drain."""
        for tr in self._traces.values():
            if tr.outcome is not None:
                continue
            if tr.open is not None:
                t1 = max(float(horizon_s), tr.open["t0_s"])
                self._close(tr, t1, cut="drain")
            tr.outcome = "unresolved"

    def records(self) -> List[dict]:
        """Schema-v1 span records, sorted by ordinal."""
        out = []
        for o in sorted(self._traces):
            tr = self._traces[o]
            rec = {
                "schema": SCHEMA_VERSION,
                "event": "span",
                "ordinal": o,
                "arrival_s": tr.arrival,
                "attempts": tr.attempts,
                "outcome": tr.outcome or "unresolved",
                "segments": list(tr.segs),
            }
            if tr.rtt is not None:
                rec["rtt_s"] = tr.rtt
            if tr.finish is not None:
                rec["finish_s"] = tr.finish
            if tr.e2e is not None:
                rec["e2e_s"] = tr.e2e
            if tr.first is not None:
                rec["first_token_s"] = tr.first
            out.append(rec)
        return out
