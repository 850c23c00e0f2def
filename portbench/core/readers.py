"""The per-layer readers' arithmetic, one function a quantity; each file
of ``metrics/`` names the function its metric reads.  A reader returns
None where the run holds nothing to read."""

import numpy as np


def queue_wait_p90_ms(ctx):
    """Client and dispatch: the 90th percentile, over every request due in the
window, of the time from its due time to the start of its first
``submit`` (to the window's close for one not sent by then), in ms."""
    win = ctx.win
    waits = [min(win.submit_start.get(rid, win.close), win.close) - due
             for rid, due in win.due.items()]
    return 1e3 * float(np.percentile(waits, 90)) if waits else None


def wasted_token_share(ctx):
    """Client and dispatch: the share of the tokens generated in the window that
belong to attempts a preemption discarded, in %."""
    win = ctx.win
    made = wasted = 0
    for a in win.attempts:
        n = sum(1 for t in a.times if win.start <= t <= win.close)
        made += n
        wasted += n if a.discarded else 0
    return 100.0 * wasted / made if made else None


def prefill_ms_per_ktok(ctx):
    """Replica prefill: the program's own prefill times (``LiveReplica.prefill_s``)
of the window's prefills, summed, over their prompt tokens, in ms per 1,000
tokens."""
    pf = ctx.window_prefills()
    tokens = sum(p.prompt_len for p in pf)
    if not tokens:
        return None
    return 1e6 * sum(ctx.prefill_s(p) for p in pf) / tokens


def prefill_mfu(ctx):
    """Replica prefill: the model FLOPs of the window's prefills (the frozen
formulas of ``core/cost.py``) over their summed wall time (the program's
``LiveReplica.prefill_s``) times the card's bf16 peak, in %."""
    pf = ctx.window_prefills()
    secs = sum(ctx.prefill_s(p) for p in pf)
    if not secs:
        return None
    flops = sum(ctx.cost.prefill_flops(ctx.shape, p.prompt_len) for p in pf)
    return 100.0 * flops / (secs * ctx.cost.PEAK_BF16_FLOPS)


def decode_step_ms(ctx):
    """Serve step: the program's own time of a decode step (``LiveReplica.decode_s``,
one captured-graph replay and its token read back), the mean over every
replay of the window, in ms."""
    secs = [s for r in ctx.window_rounds() for s in ctx.decode_s(r)]
    return 1e3 * sum(secs) / len(secs) if secs else None


def decode_mfu(ctx):
    """Serve step: the model FLOPs of the window's decode steps (each token
against its valid cache, the frozen formulas of ``core/cost.py``) over
their summed wall time (``LiveReplica.decode_s``) times the card's bf16
peak, in %."""
    rounds = ctx.window_rounds()
    secs = sum(s for r in rounds for s in ctx.decode_s(r))
    if not secs:
        return None
    flops = sum(ctx.cost.decode_flops(ctx.shape, n) for r in rounds for n in r.valid)
    return 100.0 * flops / (secs * ctx.cost.PEAK_BF16_FLOPS)


def kernels_per_decode_step(ctx):
    """Kernel dispatch: device operations that ran inside the harness's decode
spans of the traced stretch, per decode step (replay) in them."""
    rounds = ctx.traced_rounds()
    if not rounds:
        return None
    n = sum(1 for k in ctx.trace.kernels if k.span == "pb.decode")
    return n / sum(len(r.valid) for r in rounds)


def flash_decode_roofline(ctx):
    """Kernels: flash_decode's share of its roofline in the traced stretch's
decode steps: the summed least time of its calls (one per layer and step,
each against the step's valid cache slots, the frozen formulas of
``core/cost.py``) over the summed time of its kernels, in %."""
    rounds = ctx.traced_rounds()
    spent = ctx.kernel_seconds("pb.decode", "flash_decode")
    if not rounds or not spent:
        return None
    m, c = ctx.shape, ctx.cost
    bound = sum(m.layers * c.flash_decode_work(
        1, m.heads, m.kv_heads, ctx.cache_slots, m.head_dim, 2, n).bound_s()
        for r in rounds for n in r.valid)
    return 100.0 * bound / spent


def moe_gmm_decode_roofline(ctx):
    """Kernels: moe_gmm's share of its roofline in the traced stretch's decode
steps.  A decode step routes one token to k experts, so each of its three
calls a layer (x @ wi, x @ wg, h @ wo) reads exactly those k experts'
weights, k rows of x and the whole (E, 1, F) output (the frozen formulas
of ``core/cost.py``); their summed least time over the summed time of the
grouped-matmul kernels in the decode spans, in %."""
    m, c = ctx.shape, ctx.cost
    rounds = ctx.traced_rounds()
    spent = ctx.kernel_seconds("pb.decode", "gmm_")
    if not m.experts or not rounds or not spent:
        return None
    up = c.moe_gmm_work(m.experts, 1, m.d_model, m.expert_ff, 2, m.top_k, m.top_k)
    down = c.moe_gmm_work(m.experts, 1, m.expert_ff, m.d_model, 2, m.top_k, m.top_k)
    per_step = m.layers * (2 * up.bound_s() + down.bound_s())
    return 100.0 * per_step * sum(len(r.valid) for r in rounds) / spent


def flash_attention_roofline(ctx):
    """Kernels: flash_attention's share of its roofline in the traced stretch's
prefills: the summed least time of its calls (one per layer and prefill,
causal over the prompt, the frozen formulas of ``core/cost.py``) over the
summed time of its kernels in the prefill spans, in %."""
    pf = ctx.traced_prefills()
    spent = ctx.kernel_seconds("pb.prefill", "flash_attention")
    if not pf or not spent:
        return None
    m, c = ctx.shape, ctx.cost
    bound = sum(m.layers * c.flash_attention_work(
        1, m.heads, m.kv_heads, p.prompt_len, p.prompt_len, m.head_dim, 2,
        causal=True).bound_s() for p in pf)
    return 100.0 * bound / spent


def device_idle(ctx):
    """Device: the share of the traced stretch in which no operation ran on the
card, in %."""
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t is not None else None


def token_gap_ms(ctx, q: float):
    """The q-th percentile of every gap between consecutive tokens of
    every attempt, both inside the window, in ms."""
    from portbench.core import endtoend

    gaps = endtoend.token_gaps(ctx.win)
    return 1e3 * endtoend.percentile(gaps, q) if gaps else None
