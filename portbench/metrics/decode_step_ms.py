"""Serve step: the program's mean time of a decode step (LiveReplica.decode_s), in ms."""

from portbench.core.readers import decode_step_ms as read  # noqa: F401
