"""Device: the share of the traced stretch with no operation on the card, in %."""

from portbench.core.readers import device_idle as read  # noqa: F401
