"""``ContinuousBatch``, iteration-level (Orca-style) scheduling of one
replica: the port's own copy of ``repro.serving.token.batch``.

* Requests join and leave at iteration boundaries.  They wait in a FIFO
  admission queue until the KV cache has room for their whole footprint
  (``prompt + output`` tokens, reserved up front, so no sequence is evicted
  in flight) and the batch is under ``max_batch``.
* Chunked prefill: an iteration prefills at most ``prefill_chunk_tokens``
  prompt tokens, shared FIFO across the prefilling sequences.
* An iteration costs ``iter_overhead + weight_read_s + kv_read_s_per_token
  * K``, ``K`` the batch's resident KV tokens: the weights are read once
  for the batch, the KV once per sequence.
* A preemption loses all KV state: ``kill()`` drops every sequence and
  reports the tokens that must be prefilled and decoded again elsewhere.
* A migrated sequence (``enqueue_migrated``) joins with the progress its
  KV carried over the wire.

Pure-decode stretches advance in closed form (an iteration's time is
affine in its index, so ``n`` iterations take a quadratic, solved, not
summed); the per-sequence state is parallel NumPy arrays.  Every float
operation is the reference's, in its order, so both serving engines give
the reference's times to the bit.

Clock: ``advance(t)`` runs the whole iterations that end at or before
``t``; a request enqueued at ``e`` never joins an iteration that starts
before ``e``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.token.config import TokenEngineConfig

__all__ = ["ContinuousBatch", "KillReport", "TokenCompletion"]


@dataclasses.dataclass(frozen=True)
class TokenCompletion:
    """One finished request and its timeline.  ``first_token_s`` and
    ``finish_s`` include the per-request ``overhead_s``, so the end-to-end
    time is ``finish_s - arrival_s + rtt``."""

    key: int
    arrival_s: float
    enqueued_s: float
    first_token_s: float
    finish_s: float
    prompt_tokens: int
    output_tokens: int


@dataclasses.dataclass(frozen=True)
class KillReport:
    """What a preemption destroyed."""

    keys: Tuple[int, ...]           # every request to retry client-side
    n_batch: int                    # sequences that lost KV state
    n_queued: int                   # admission-queue entries (no KV yet)
    lost_prefill_tokens: int        # prompt tokens to prefill again
    lost_decode_tokens: int         # output tokens to decode again


_EMPTY_I = np.empty(0, dtype=np.int64)
_EMPTY_F = np.empty(0, dtype=np.float64)


class ContinuousBatch:
    """The iteration-level scheduler state of one replica."""

    __slots__ = (
        "cfg", "now", "queue", "reserved_tokens", "completed",
        "_keys", "_prompt", "_out", "_pref", "_dec",
        "_arrival", "_enq", "_first", "_mig", "tap", "_tord",
    )

    def __init__(self, cfg: TokenEngineConfig, tap=None) -> None:
        self.cfg = cfg
        # the span tap (a SpanCollector) and the key -> ordinal map of the
        # sampled requests resident here; None when tracing is off, so
        # every hot-path guard is one falsy check
        self.tap = tap
        self._tord: Optional[Dict[int, int]] = {} if tap is not None else None
        self.now = 0.0
        # (key, prompt, out, arrival_s, enqueued_s, rtt_s): rtt_s, the
        # client's round trip to this replica, is part of the queue-expiry
        # deadline, as it is of a completed response's
        self.queue: Deque[Tuple[int, int, int, float, float, float]] = deque()
        self.reserved_tokens = 0        # sum(prompt + out) over the batch
        self.completed = 0
        self._keys = _EMPTY_I
        self._prompt = _EMPTY_I
        self._out = _EMPTY_I
        self._pref = _EMPTY_I           # prompt tokens prefilled so far
        self._dec = _EMPTY_I            # output tokens produced so far
        self._arrival = _EMPTY_F
        self._enq = _EMPTY_F
        self._first = _EMPTY_F          # first-token time (engine clock)
        # migrated-in progress awaiting admission: key -> (pref, dec,
        # first); None until a sequence migrates in
        self._mig: Optional[Dict[int, Tuple[int, int, float]]] = None

    # -- introspection --------------------------------------------------
    @property
    def n_active(self) -> int:
        return len(self._keys)

    @property
    def n_queued(self) -> int:
        return len(self.queue)

    @property
    def load(self) -> int:
        return len(self._keys) + len(self.queue)

    @property
    def kv_tokens(self) -> int:
        """Resident KV tokens now (prefilled + decoded)."""
        return int(self._pref.sum() + self._dec.sum())

    @property
    def committed_tokens(self) -> int:
        """KV tokens spoken for: the batch's reservations and what the
        admission queue will claim (a migration target's used budget)."""
        return self.reserved_tokens + sum(p + o for _, p, o, _, _, _
                                          in self.queue)

    def iter_states(self) -> List[
            Tuple[int, int, int, int, int, float, float, float]]:
        """The batch's sequences for the migration planner: ``(key, prompt,
        out, prefilled, decoded, arrival_s, enqueued_s, first_s)`` each
        (``first_s`` nan before the first token)."""
        return [
            (int(self._keys[j]), int(self._prompt[j]), int(self._out[j]),
             int(self._pref[j]), int(self._dec[j]),
             float(self._arrival[j]), float(self._enq[j]),
             float(self._first[j]))
            for j in range(len(self._keys))
        ]

    def backlog_hint_s(self) -> float:
        """Rough seconds of work ahead of a new arrival."""
        cfg = self.cfg
        rem_dec = int((self._out - self._dec).sum())
        rem_pref = int((self._prompt - self._pref).sum())
        q_pref = sum(p for _, p, _, _, _, _ in self.queue)
        q_dec = sum(o for _, _, o, _, _, _ in self.queue)
        b = max(self.n_active, 1)
        # the batch's decode tokens overlap (one iteration serves it all);
        # the queue's work runs after them
        return (rem_dec * cfg.weight_read_s / b
                + (rem_pref + q_pref) * cfg.prefill_s_per_token
                + q_dec * cfg.weight_read_s)

    def track(self, key: int, ordinal: int) -> None:
        """Register a sampled request: the batch's events for ``key`` tap
        the span at ``ordinal`` until the key retires or is evicted."""
        if self._tord is not None:
            self._tord[int(key)] = int(ordinal)

    # -- request path ---------------------------------------------------
    def enqueue(self, key: int, prompt_tokens: int, output_tokens: int,
                arrival_s: float, enqueued_s: float,
                rtt_s: float = 0.0) -> bool:
        """Queue a request for admission; False when it can never fit the
        KV budget (the caller fails it)."""
        p = max(1, int(prompt_tokens))
        o = max(1, int(output_tokens))
        if p + o > self.cfg.kv_budget_tokens:
            return False
        self.queue.append(
            (key, p, o, float(arrival_s), float(enqueued_s), float(rtt_s)))
        return True

    def enqueue_migrated(
        self, key: int, prompt_tokens: int, output_tokens: int,
        arrival_s: float, enqueued_s: float,
        prefilled: int, decoded: int, first_s: float,
        rtt_s: float = 0.0,
    ) -> bool:
        """Queue a migrated-in sequence: its ``prefilled + decoded`` KV
        tokens survived the move, so admission resumes its progress;
        ``enqueued_s`` is when the transfer completes and ``first_s`` keeps
        a first token already emitted."""
        p = max(1, int(prompt_tokens))
        o = max(1, int(output_tokens))
        if p + o > self.cfg.kv_budget_tokens:
            return False
        if self._mig is None:
            self._mig = {}
        self._mig[int(key)] = (int(prefilled), int(decoded), float(first_s))
        self.queue.append((int(key), p, o, float(arrival_s),
                           float(enqueued_s), float(rtt_s)))
        return True

    def expire_queue(self, t: float, timeout_s: float) -> List[int]:
        """Drop the queue entries whose client gave up (``t - arrival +
        rtt > timeout``, the deadline of a completed response); returns
        their keys."""
        if not self.queue:
            return []
        expired: List[int] = []
        kept: Deque[Tuple[int, int, int, float, float, float]] = deque()
        for entry in self.queue:
            if t - entry[3] + entry[5] > timeout_s:
                expired.append(entry[0])
            else:
                kept.append(entry)
        if expired:
            self.queue = kept
            if self._mig:
                for k in expired:
                    self._mig.pop(k, None)
            if self._tord:
                for k in expired:
                    self._tord.pop(k, None)
        return expired

    def remove(self, keys: Sequence[int]) -> None:
        """Drop sequences from the batch without completing or counting
        them (they drained or migrated; the migration runtime accounts
        them) and free their KV reservation."""
        if len(self._keys) == 0 or not keys:
            return
        kset = {int(k) for k in keys}
        if self._tord:
            for k in kset:
                self._tord.pop(k, None)
        mask = np.fromiter((int(k) in kset for k in self._keys), dtype=bool,
                           count=len(self._keys))
        if not mask.any():
            return
        idx = np.nonzero(mask)[0]
        self.reserved_tokens -= int((self._prompt[idx] + self._out[idx]).sum())
        self._keep(~mask)

    def kill(self) -> KillReport:
        """Preemption: all KV state is lost; every request retries."""
        keys = tuple(int(k) for k in self._keys) + tuple(
            e[0] for e in self.queue)
        lost_p = int(self._pref.sum())
        lost_d = int(self._dec.sum())
        if self._mig:
            # migrated-in sequences awaiting admission carried KV over the
            # wire; killing the target loses it too
            for mp, md, _ in self._mig.values():
                lost_p += mp
                lost_d += md
        report = KillReport(keys=keys, n_batch=len(self._keys),
                            n_queued=len(self.queue),
                            lost_prefill_tokens=lost_p,
                            lost_decode_tokens=lost_d)
        self.queue.clear()
        self._mig = None
        if self._tord:
            self._tord.clear()
        self.reserved_tokens = 0
        self._keys = _EMPTY_I
        self._prompt = _EMPTY_I
        self._out = _EMPTY_I
        self._pref = _EMPTY_I
        self._dec = _EMPTY_I
        self._arrival = _EMPTY_F
        self._enq = _EMPTY_F
        self._first = _EMPTY_F
        return report

    # -- scheduling core ------------------------------------------------
    def _keep(self, keep: np.ndarray) -> None:
        self._keys = self._keys[keep]
        self._prompt = self._prompt[keep]
        self._out = self._out[keep]
        self._pref = self._pref[keep]
        self._dec = self._dec[keep]
        self._arrival = self._arrival[keep]
        self._enq = self._enq[keep]
        self._first = self._first[keep]

    def _admit(self) -> None:
        """Join waiting requests at the current iteration boundary."""
        cfg = self.cfg
        q = self.queue
        while q:
            key, p, o, arr, enq, _ = q[0]
            if len(self._keys) >= cfg.max_batch:
                break
            if self.reserved_tokens + p + o > cfg.kv_budget_tokens:
                break                   # FIFO: no overtaking
            if len(self._keys) == 0:
                # an idle engine's clock jumps to the work's enqueue time
                if enq > self.now:
                    self.now = enq
            elif enq > self.now:
                break                   # joins at a boundary >= enqueue
            q.popleft()
            self.reserved_tokens += p + o
            mig = self._mig.pop(key, None) if self._mig else None
            self._keys = np.append(self._keys, key)
            self._prompt = np.append(self._prompt, p)
            self._out = np.append(self._out, o)
            if mig is None:
                self._pref = np.append(self._pref, 0)
                self._dec = np.append(self._dec, 0)
                self._first = np.append(self._first, np.nan)
            else:
                # migrated in: its KV survived the move
                self._pref = np.append(self._pref, mig[0])
                self._dec = np.append(self._dec, mig[1])
                self._first = np.append(self._first, mig[2])
            self._arrival = np.append(self._arrival, arr)
            self._enq = np.append(self._enq, enq)
            if self._tord:
                o = self._tord.get(key)
                if o is not None:
                    pref0 = p if mig is None else p - mig[0]
                    self.tap.token_join(o, self.now, prefilling=pref0 > 0)

    def _retire(self, mask: np.ndarray, end: float,
                done: List[TokenCompletion]) -> None:
        cfg = self.cfg
        idx = np.nonzero(mask)[0]
        if self._tord:
            for j in idx:
                self._tord.pop(int(self._keys[j]), None)
        for j in idx:
            done.append(TokenCompletion(
                key=int(self._keys[j]),
                arrival_s=float(self._arrival[j]),
                enqueued_s=float(self._enq[j]),
                first_token_s=float(self._first[j]) + cfg.overhead_s,
                finish_s=end + cfg.overhead_s,
                prompt_tokens=int(self._prompt[j]),
                output_tokens=int(self._out[j]),
            ))
        self.completed += len(idx)
        self.reserved_tokens -= int((self._prompt[idx] + self._out[idx]).sum())
        self._keep(~mask)

    @staticmethod
    def _max_iters(avail: float, lin: float, quad: float) -> int:
        """The largest n >= 0 with ``lin n + quad n (n - 1) <= avail``."""
        if avail <= 0 or lin <= 0:
            return 0
        if quad <= 0:
            return int(avail // lin)
        # quad n^2 + (lin - quad) n <= avail
        b = lin - quad
        n = int((-b + math.sqrt(b * b + 4.0 * quad * avail)) / (2.0 * quad))
        while n > 0 and lin * n + quad * n * (n - 1) > avail:
            n -= 1
        while lin * (n + 1) + quad * (n + 1) * n <= avail:
            n += 1
        return n

    def advance(self, t: float) -> List[TokenCompletion]:
        """Run every iteration that ends at or before ``t``."""
        cfg = self.cfg
        w = cfg.weight_read_s
        oh = cfg.iter_overhead_s
        r = cfg.kv_read_s_per_token
        pf = cfg.prefill_s_per_token
        done: List[TokenCompletion] = []
        while True:
            self._admit()
            b = len(self._keys)
            if b == 0:
                break
            need = self._prompt - self._pref
            if need.any():
                # mixed iteration: chunked prefill, and a decode step
                budget = cfg.prefill_chunk_tokens
                take = np.zeros(b, dtype=np.int64)
                for j in np.nonzero(need)[0]:
                    c = min(int(need[j]), budget)
                    take[j] = c
                    budget -= c
                    if budget <= 0:
                        break
                decoding = need == 0
                n_dec = int(decoding.sum())
                dt = oh + int(take.sum()) * pf
                if n_dec:
                    k_dec = int((self._pref[decoding]
                                 + self._dec[decoding]).sum())
                    dt += w + r * k_dec
                end = self.now + dt
                if end > t:
                    break
                self.now = end
                self._pref += take
                if self._tord:
                    tap = self.tap
                    for j in np.nonzero(take)[0]:
                        o = self._tord.get(int(self._keys[j]))
                        if o is None:
                            continue
                        tap.token_chunk(o, int(take[j]))
                        if self._pref[j] == self._prompt[j]:
                            tap.token_prefill_done(o, end)
                if n_dec:
                    self._dec[decoding] += 1
                    newly = decoding & (self._dec == 1)
                    self._first[newly] = end
                    finished = decoding & (self._dec == self._out)
                    if finished.any():
                        self._retire(finished, end, done)
                continue
            # pure decode: a block of iterations in closed form
            rem = self._out - self._dec
            n_leave = int(rem.min())
            k0 = int((self._pref + self._dec).sum())
            lin = oh + w + r * k0           # the first iteration's cost
            quad = r * b / 2.0              # KV growth per iteration pair
            # an admissible waiting request joins at the first boundary
            # past its enqueue time: the block stops there
            t_eff = t
            join_wait = False
            if self.queue and b < cfg.max_batch:
                key, p, o, arr, enq, _ = self.queue[0]
                if (self.reserved_tokens + p + o <= cfg.kv_budget_tokens
                        and enq < t):
                    cap = max(self.now, min(t, enq))
                    if cap < t_eff:
                        t_eff = cap
                        join_wait = True
            n = self._max_iters(t_eff - self.now, lin, quad)
            if n > n_leave:
                n = n_leave
            if n <= 0:
                if join_wait and self.now + lin <= t:
                    n = 1               # one iteration crosses the join
                else:
                    break
            first_end = self.now + lin
            end = self.now + lin * n + quad * n * (n - 1)
            newly = self._dec == 0
            self._dec += n
            if newly.any():
                self._first[newly] = first_end
            self.now = end
            if n == n_leave:
                self._retire(self._dec == self._out, end, done)
                continue
            if join_wait:
                continue                # the clock may admit the waiter
            break                       # capped at t
        return done
