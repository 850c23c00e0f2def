"""The open-loop client: sends each request when it is due, dispatches it to
the program's replicas and steps them, through the measured window.

Dispatch is the program's own rule (``repro_torch.serving.live.serve_fleet``):
a request goes to the live replica with the fewest requests in flight, and
one that was in flight on a preempted replica is sent again, from scratch,
ahead of the others (client-side retry).  A request that finds no free
cache slot waits in the client's queue.  Each pass of the loop admits what
is due, dispatches, then calls ``step()`` on every live replica that has a
request in flight (one greedy token for each).

The preemption: at half the window (the mix's ``preempt_at``), at the first
pass where replica 0 holds a request, replica 0 is killed
(``LiveReplica.kill``), the tokens of its in-flight attempts are discarded
and those requests are sent again; the standby replica joins the dispatch
at the same moment, so the number of serving slots stays the same.

In a traced run the loop serves on past the window's close, through the
profiler's start-up and its stretch (``trace.Tracer``), with the arrivals
due after the window; the window's records end at its close.

A token reaches the client when the call that made it returns: the first
at the end of ``submit`` (the prefill), the others at the end of the
``step()`` that made them.  Every time is the host's ``perf_counter``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

clock = time.perf_counter


@dataclasses.dataclass
class Attempt:
    rid: int
    replica: str
    prompt_len: int
    submit_start: float
    times: List[float]                 # when each token reached the client
    tokens: List[int]                  # the program's list of the tokens
    want: int                          # the tokens the request asks for
    retry: bool = False                # an earlier attempt was discarded
    discarded: bool = False


@dataclasses.dataclass
class Round:
    """One ``step()`` of one replica: one replay per request in flight."""
    replica: str
    start: float
    end: float
    valid: List[int]                   # slots each replay attends
    decode_idx: tuple                  # its entries of the replica's decode_s


@dataclasses.dataclass
class Prefill:
    replica: str
    start: float
    end: float
    prompt_len: int
    prefill_idx: int                   # its entry of the replica's prefill_s


@dataclasses.dataclass
class Window:
    start: float
    close: float                       # when the window closed
    seconds: float
    kill_at: Optional[float]
    attempts: List[Attempt]
    final: Dict[int, Attempt]          # request id -> its last attempt
    submit_start: Dict[int, float]     # request id -> first submit's start
    rounds: List[Round]
    prefills: List[Prefill]
    due: Dict[int, float]              # request id -> due time (window arrivals)


def admit(rep, req, prompt, attempts: List[Attempt], prefills: List[Prefill],
          span=contextlib.nullcontext, retry: bool = False) -> Attempt:
    """``submit`` a request to replica ``rep`` and record its attempt."""
    t0 = clock()
    with span("pb.prefill"):
        rep.submit(req.rid, prompt, req.out_tokens - 1)
    t1 = clock()
    mine = rep.inflight[-1]
    att = Attempt(req.rid, rep.name, int(prompt.shape[0]), t0, [t1], mine.out,
                  req.out_tokens, retry=retry)
    attempts.append(att)
    prefills.append(Prefill(rep.name, t0, t1, att.prompt_len,
                            len(rep.prefill_s) - 1))
    return att


def step(rep, final: Dict[int, Attempt], rounds: List[Round],
         span=contextlib.nullcontext) -> None:
    """One ``step()`` of ``rep``; each in-flight attempt gets its token's
    time."""
    before = [final[r.req_id] for r in rep.inflight]
    valid = [a.prompt_len + len(a.tokens) for a in before]
    i0 = len(rep.decode_s)
    t0 = clock()
    with span("pb.decode"):
        rep.step()
    t1 = clock()
    for a in before:
        a.times.append(t1)
    rounds.append(Round(rep.name, t0, t1, valid, (i0, len(rep.decode_s))))


def run_window(serving, standby, reqs, prompts, seconds: float,
               preempt_at: float, tracer=None,
               backlog: Optional[List[Attempt]] = None) -> Window:
    """Serve the window: ``reqs`` are every request (the backlog's, already
    admitted in set-up as the attempts ``backlog``, and the arrivals, due
    ``due_s`` after the window opens) and ``prompts`` their tokens on the
    device.  With a ``tracer`` the loop goes on after the window until the
    traced stretch has ended, serving the arrivals due after the window;
    each of those is moved later by the time a ``tick`` took (the
    profiler's start-up)."""
    span = tracer.span if tracer is not None else contextlib.nullcontext
    attempts: List[Attempt] = list(backlog or [])
    prefills: List[Prefill] = []
    final = {a.rid: a for a in attempts}
    by_id = {r.rid: r for r in reqs}
    submit_start: Dict[int, float] = {}
    rounds: List[Round] = []
    live = list(serving)
    queue: collections.deque = collections.deque()
    arrivals = sorted((r for r in reqs if not r.backlog), key=lambda r: r.due_s)
    t0 = clock()
    due = {r.rid: t0 + r.due_s for r in arrivals}
    end, kill_from = t0 + seconds, t0 + preempt_at * seconds
    kill_at: Optional[float] = None
    close: Optional[float] = None
    i = 0
    while True:
        now = clock()
        if now >= end:
            if close is None:
                close = now
            if tracer is None or tracer.ended:
                break
            tracer.tick()
            stall = clock() - now
            for r in arrivals[i:]:
                if r.due_s >= seconds:
                    due[r.rid] += stall
            now = clock()
        while i < len(arrivals) and due[arrivals[i].rid] <= now:
            queue.append(arrivals[i].rid)
            i += 1
        if kill_at is None and now >= kill_from and serving[0].inflight:
            with span("pb.preempt"):
                failed = serving[0].kill()
            kill_at = clock()
            for rid in failed:
                final[rid].discarded = True
            queue.extendleft(reversed(failed))
            live = [r for r in live if r.alive] + [standby]
        with span("pb.dispatch"):
            ready = [r for r in live if r.free]
        while queue and ready:
            target = min(ready, key=lambda r: len(r.inflight))
            rid = queue.popleft()
            submit_start.setdefault(rid, clock())
            retry = rid in final
            final[rid] = admit(target, by_id[rid], prompts[rid], attempts,
                               prefills, span, retry=retry)
            ready = [r for r in live if r.free]
        busy = False
        for rep in live:
            if rep.inflight:
                step(rep, final, rounds, span)
                busy = True
        if not busy and not queue:
            nxt = [end if close is None else now + 0.05] + (
                [due[arrivals[i].rid]] if i < len(arrivals) else [])
            with span("pb.wait"):
                time.sleep(max(0.0, min(min(nxt) - clock(), 0.05)))
    in_window = {r.rid: due[r.rid] for r in arrivals if r.due_s < seconds}
    return Window(t0, close, seconds, kill_at, attempts, final, submit_start,
                  rounds, prefills, in_window)
