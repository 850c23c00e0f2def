"""Serve step: the decode steps' model FLOPs over their wall time times the bf16 peak, in %."""

from portbench.core.readers import decode_mfu as read  # noqa: F401
