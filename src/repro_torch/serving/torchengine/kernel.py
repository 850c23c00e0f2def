"""Phase B's launch: one shape group of lanes through ``scenario_scan``.

``KernelKey`` is the reference's static signature
(``repro.serving.jaxengine.kernel.KernelKey``) less its ``ATYP``, the p99
arrivals a sub-step that sizes the reference's masked scans: the CUDA
kernel and its plain version loop while work remains and have no such
scans.  ``AMAX`` stays an overflow cause, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops

__all__ = ["KernelKey", "run_group"]

LANE_KEYS = ("arr", "svc", "rcode", "rtt", "ready", "kill_slot", "kill_g",
             "timeout")


@dataclasses.dataclass(frozen=True)
class KernelKey:
    """Static shape/flag signature of one shape group."""

    G: int          # grid points
    W: int          # control windows
    N: int          # padded tape length
    R: int          # padded replica slots
    Q: int          # queue pool capacity per slot
    C: int          # concurrency
    NREG: int       # padded client-region count
    E: int          # padded kill events
    AMAX: int       # max arrivals in any sub-step (exact, host-computed)
    lb_rr: bool     # round-robin (else least-loaded)
    expire_on: bool  # timeout_s > 0: run the queue-expiry sweep
    trace_on: bool = False  # carry span timelines (dispatch/start/finish)


def run_group(
    key: KernelKey,
    lanes: Dict[str, np.ndarray],
    ts: np.ndarray,
    gs: np.ndarray,
    wins: np.ndarray,
    device: Union[str, torch.device, None] = None,
) -> Dict[str, np.ndarray]:
    """Run one shape group: ``lanes`` holds the stacked per-cell arrays
    (leading axis = cell), the grid arrays are shared.  Returns host numpy
    outputs keyed like the reference's lane outputs.

    The default device is CUDA, where the group is one launch of the
    kernel; ``device="cpu"`` runs its plain version.  A lane the kernel
    cannot take raises."""
    dev = resolve_device(device)
    args = [torch.from_numpy(np.ascontiguousarray(lanes[k])).to(dev)
            for k in LANE_KEYS]
    grid = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (ts, gs, wins)]
    out = ops.scenario_scan(*args, *grid, Q=key.Q, C=key.C, amax=key.AMAX,
                            lb_rr=key.lb_rr, expire_on=key.expire_on,
                            trace_on=key.trace_on)
    return {k: v.cpu().numpy() for k, v in out.items()}
