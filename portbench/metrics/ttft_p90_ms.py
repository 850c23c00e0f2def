"""Client and dispatch: the 90th percentile, over every request due in the
window, of the time from its due time to its first token, in ms (the tail
beside the code cell's end-to-end median)."""

from portbench.core import endtoend


def read(ctx):
    ttft = endtoend.ttfts(ctx.win)
    return 1e3 * endtoend.percentile(ttft, 90) if ttft else None
