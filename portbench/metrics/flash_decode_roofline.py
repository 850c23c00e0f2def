"""Kernels: flash_decode's share of its roofline in the traced decode steps, in %."""

from portbench.core.readers import flash_decode_roofline as read  # noqa: F401
