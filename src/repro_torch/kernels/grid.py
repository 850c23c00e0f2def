"""What the kernels that size their own grids or merge their blocks in one
launch (``flash_decode``, the small-capacity ``moe_gmm``) need from the
device beside their inputs: its SM count, and arrival counters.

Each block of a group takes a ticket from the group's counter once its
partial result is written; the block that draws the last ticket merges the
partials in a fixed order and sets the counter back to 0.  The counters are
therefore zeros between launches and are kept, not allocated per call: one
int32 buffer per kernel, device and stream, so launches on two streams never
share a counter.  Nothing here runs at import.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch

_counters: Dict[Tuple[str, int, int], torch.Tensor] = {}


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def arrival_counters(kernel: str, device: torch.device, stream: int,
                     n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for ``kernel``'s launches on
    ``stream`` of ``device``; a larger buffer is made (as new zeros) when a
    launch needs more."""
    key = (kernel, device.index or 0, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf
