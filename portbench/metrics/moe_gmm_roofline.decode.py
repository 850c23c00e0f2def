"""Kernels: moe_gmm's share of its roofline in the traced decode steps, in %."""

from portbench.core.readers import moe_gmm_decode_roofline as read  # noqa: F401
