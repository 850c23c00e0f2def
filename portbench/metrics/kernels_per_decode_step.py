"""Kernel dispatch: device operations in the traced decode spans per decode step."""

from portbench.core.readers import kernels_per_decode_step as read  # noqa: F401
