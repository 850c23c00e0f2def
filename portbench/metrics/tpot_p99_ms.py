"""Serve step: the 99th percentile of every gap between consecutive tokens
in the window, in ms (a gap is one round of replays, longer where a prefill
falls between two rounds)."""

from portbench.core.readers import token_gap_ms


def read(ctx):
    return token_gap_ms(ctx, 99)
