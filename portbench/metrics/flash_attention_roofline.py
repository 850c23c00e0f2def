"""Kernels: flash_attention's share of its roofline in the traced prefills, in %."""

from portbench.core.readers import flash_attention_roofline as read  # noqa: F401
