"""Client and dispatch: the share of the window's tokens that a preemption discarded, in %."""

from portbench.core.readers import wasted_token_share as read  # noqa: F401
