"""Replica prefill: the prefills' model FLOPs over their wall time times the bf16 peak, in %."""

from portbench.core.readers import prefill_mfu as read  # noqa: F401
