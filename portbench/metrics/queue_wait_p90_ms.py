"""Client and dispatch: the 90th percentile of the time from a request's due time to its first submit, in ms."""

from portbench.core.readers import queue_wait_p90_ms as read  # noqa: F401
