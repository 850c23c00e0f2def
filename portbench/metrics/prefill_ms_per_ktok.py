"""Replica prefill: the program's prefill seconds (LiveReplica.prefill_s) over the prompts' tokens, in ms per 1,000 tokens."""

from portbench.core.readers import prefill_ms_per_ktok as read  # noqa: F401
