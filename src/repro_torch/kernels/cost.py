"""The work each hand-written kernel does: its operations and the bytes it
must move, in one place.

``chip_smoke.py``'s bound column (the least time the card could take for a
call: operations over the peak for their type, bytes over the memory
rate, whichever is larger) and the wrappers' ``meta`` routes
(``kernels.ops``, which add a call's work to the dry run's counter) read
these formulas and no others.  Bytes count each input read once and each
output written once, in the dtypes the kernel reads and writes.

Where the work depends on the data (the valid slots of a decode cache, the
occupied rows of an expert buffer, the requests a scenario lane resolves),
the caller passes what this run's data needs; a ``meta`` call has no data
and counts the most the shapes allow (every slot valid, every row
occupied, every output written).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Work:
    """One call's operations, on the units ``unit`` names ("bf16" tensor
    cores, "fp32" or "fp64" CUDA cores), and bytes moved."""

    flops: float
    bytes: float
    unit: str = "bf16"


def attention_pairs(Sq: int, Skv: int, causal: bool, window: Optional[int],
                    prefix: int) -> int:
    """Unmasked (query, key) pairs of ``flash_attention``'s mask: query i
    sees key j where (not causal, or j <= i, or j < prefix) and (no window,
    or i - j < window); counted per query row in closed form."""
    q = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.zeros(Sq, dtype=np.int64)
    if window is not None:
        lo = np.maximum(lo, q - window + 1)
    main = np.clip(hi - lo + 1, 0, None)
    extra = 0
    if causal and prefix:
        # keys j < prefix past the causal limit (j > i); i - j < 0 < window
        first = np.maximum(q + 1, 0)
        last = min(prefix, Skv) - 1
        extra = np.clip(last - first + 1, 0, None)
    return int((main + extra).sum())


def flash_attention_work(B: int, H: int, Kv: int, Sq: int, Skv: int, D: int,
                         itemsize: int, *, causal: bool,
                         window: Optional[int] = None,
                         prefix: int = 0) -> Work:
    """Two products of D per head and unmasked pair (QK^T and PV, 2 x 2
    operations); q and the output (B, Sq, H, D), k and v (B, Skv, Kv, D)."""
    pairs = attention_pairs(Sq, Skv, causal, window, prefix)
    return Work(4.0 * B * H * D * pairs,
                float(itemsize) * (2 * B * Sq * H * D + 2 * B * Skv * Kv * D))


def flash_decode_work(B: int, H: int, Kv: int, S: int, D: int, itemsize: int,
                      n_valid: Optional[int] = None, lse: bool = False) -> Work:
    """One query token per head against ``n_valid`` valid slots (all S when
    not given): q and the output, the (B, S) one-byte mask, and the K and V
    rows of the valid slots.  With ``lse`` (a slot shard's partial) the
    output is written in fp32 and each row's log-sum-exp beside it."""
    n = S if n_valid is None else n_valid
    out_bytes = (4.0 * B * H * (D + 1) if lse
                 else float(itemsize) * B * H * D)
    return Work(4.0 * B * H * D * n,
                float(itemsize) * B * H * D + out_bytes + B * S
                + float(itemsize) * 2 * B * n * Kv * D)


def selective_scan_work(B: int, Q: int, C: int, N: int,
                        in_itemsize: int = 4) -> Work:
    """One fused multiply-add per element and step on the fp32 units; a and
    b read once, h0 read (fp32), every h_t written (fp32)."""
    elems = float(B) * C * N
    return Work(2.0 * Q * elems,
                2.0 * in_itemsize * Q * elems + 4.0 * elems + 4.0 * Q * elems,
                unit="fp32")


def moe_gmm_work(E: int, C: int, D: int, F: int, itemsize: int,
                 n_rows: Optional[int] = None,
                 n_occupied: Optional[int] = None) -> Work:
    """y[e] = x[e] @ w[e] over the occupied rows (all E x C when not
    given): the occupied experts' weights, the occupied rows of x, and all
    of y."""
    rows = E * C if n_rows is None else n_rows
    occ = E if n_occupied is None else n_occupied
    return Work(2.0 * rows * D * F,
                float(itemsize) * (occ * D * F + rows * D + E * C * F))


def scenario_scan_bytes(scheds, got: dict, key) -> float:
    """The bytes the data plane must move for this run's data, in the dtypes
    the kernel reads and writes (float64 times, int32 codes, slots and grid
    indices, uint8 ready flags), each lane at its own sizes, not the
    group's padding.  Read once: the tape up to the arrivals (``arr`` of
    every arrived request and the one that stops the arrivals, ``svc`` of
    the requests that were started and are still counted, ``rcode`` of
    those and the ones still queued), the lane's rtt, ready flags, kill
    events and timeout, and the grid once.  Written once: ``status``,
    ``e2e`` and, with trace_on, the span timelines and slot of every
    resolved request, and the per-lane counters.  The wrapper's memsets of
    the unresolved entries are separate launches and are not counted."""
    total = 16.0 * key.G                       # ts float64, gs / wins int32
    per_req = 1 + 8 + (4 * 8 if key.trace_on else 0)
    for i, c in enumerate(scheds):
        n_res = int((got["status"][i] > 0).sum())
        n_run, n_q = int(got["run_n"][i].sum()), int(got["q_cnt"][i].sum())
        total += 8 * min(int(got["a_ptr"][i]) + 1, key.N)      # arr
        total += 8 * (n_res + n_run) + 4 * (n_res + n_run + n_q)  # svc, rcode
        total += (8 * c.n_slots * c.n_regions + key.W * c.n_slots
                  + 8 * c.n_events + 8)        # rtt, ready, kills, timeout
        total += per_req * n_res + 17 + 16 * key.R  # outputs
    return total


def scenario_scan_work(L: int, N: int, R: int, NREG: int, W: int, E: int,
                       G: int, trace_on: bool) -> Work:
    """A ``meta`` call's most: every request of every lane arrives, runs and
    resolves (two float64 times read, an int32 code, 7 float64 operations),
    every input read once in the kernel's dtypes and every output written
    once."""
    per_req = 8 + 8 + 4 + 1 + 8 + (4 * 8 if trace_on else 0)
    nbytes = (16.0 * G + L * (per_req * N + 8 * R * NREG + W * R + 8 * E + 8
                              + 17 + 16 * R))
    return Work(7.0 * L * N, nbytes, unit="fp64")


# ---------------------------------------------------------------------------
# The counter a meta call adds its work to (``launch.op_count.OpCounter``
# pushes itself here while it is active)
# ---------------------------------------------------------------------------

_active: List[Any] = []


def record(kernel: str, work: Work) -> None:
    """Add one meta call's ``work`` to the innermost active counter, if any."""
    if _active:
        _active[-1].add_kernel(kernel, work)


__all__ = ["Work", "attention_pairs", "flash_attention_work",
           "flash_decode_work", "moe_gmm_work", "record",
           "scenario_scan_bytes", "scenario_scan_work", "selective_scan_work"]
