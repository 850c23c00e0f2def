"""The comparison that decides ``correct``.

Once the window has closed, a sample of the window's attempts, drawn from
the seed, is compared with the plain reference: the attempt with the most
tokens, one that was sent again after the preemption (re-prefilled into a
cache slot that held an earlier request), and others, each over its first
tokens (``choose_sample``).  An attempt still in flight counts with the
tokens it had served.  The reference runs once over each
prompt followed by its served tokens; at each position that chose a served
token, the gap is how far that token's logit lies below the reference's
best.  The first served token comes from the prefill's logits (attention
through ``flash_attention`` into the cache), the others from the captured
decode step (``flash_decode``, and the MoE layer through ``moe_gmm`` or the
dense MLP), so the widest gap covers both paths.

The control puts the reference in the program's place at float8 (``quant=
"fp8"``) and reads, at the same positions, the gap of the token it puts
first; ``readings.py`` reads it, the benchmark's own runs do not.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.core import spec
from portbench.reference.common import no_tf32


def choose_sample(win, seed: int, check: dict) -> List[tuple]:
    """(attempt, tokens compared) of the sample, among the attempts sent
    by the window's close: the attempt with the most
    tokens over its first ``longest``, one sent again after the preemption,
    then others in the seed's order up to ``requests`` attempts, each over
    its first ``head`` tokens (a served answer's first tokens are where its
    context is its own; a random model's answers fall into repeats)."""
    cands = [a for a in win.attempts if not a.discarded and len(a.tokens) >= 2
             and a.submit_start <= win.close]
    if not cands:
        return []
    rng = np.random.default_rng([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                                 0xC4EC])
    first = max(cands, key=lambda a: (len(a.tokens), -a.rid))
    chosen = [(first, check["longest"])]
    retried = [a for a in cands if a.retry and a is not first]
    if retried and not first.retry:
        chosen.append((retried[int(rng.integers(len(retried)))], check["head"]))
    rest = [a for a in cands if all(a is not c for c, _ in chosen)]
    for j in rng.permutation(len(rest))[:max(0, check["requests"] - len(chosen))]:
        chosen.append((rest[int(j)], check["head"]))
    return [(a, min(n, len(a.tokens))) for a, n in chosen]


def _stats(gap: torch.Tensor) -> Dict[str, float]:
    """The gaps of all compared positions: the widest, the mean, the 99th
    percentile and the share of positions whose token is not the
    reference's first choice."""
    return {"max_logit_gap": float(gap.max()), "mean_logit_gap": float(gap.mean()),
            "p99_logit_gap": float(torch.quantile(gap.double(), 0.99)),
            "flip_share": float((gap > 0).double().mean())}


def gaps(cfg: dict, W: Dict[str, torch.Tensor], sample, prompts,
         control: bool = False) -> Dict[str, float]:
    """The gaps of the sample's served tokens (and, with ``control``, of
    the float8 reference's first choices, under ``control_`` names)."""
    no_tf32()
    ref = spec.reference(cfg["reference"])
    dev = W["embed"].device
    seqs = [torch.cat([prompts[a.rid].to(dev),
                       torch.tensor(a.tokens[:n - 1], dtype=torch.long, device=dev)])
            for a, n in sample]
    lens = [a.prompt_len for a, _ in sample]
    logits = ref.logits(cfg, W, seqs, lens)
    served = torch.cat([torch.tensor(a.tokens[:n], dtype=torch.long)
                        for a, n in sample]).to(dev)
    lg = torch.cat(logits)
    best = lg.max(-1).values
    ok = (served >= 0) & (served < cfg["vocab_size"])
    gap = torch.where(ok, best - lg.gather(1, served.clamp(0, lg.shape[1] - 1)[:, None])[:, 0],
                      torch.full_like(best, float("inf")))
    out = {"positions": int(served.numel()), **_stats(gap)}
    if control:
        pick = torch.cat(ref.logits(cfg, W, seqs, lens, quant="fp8")).argmax(-1)
        out.update({f"control_{k}": v for k, v in
                    _stats(best - lg.gather(1, pick[:, None])[:, 0]).items()})
    return out


def verdict(found: Dict[str, float], sample, limits: dict,
            failed: int) -> Dict[str, dict]:
    """Each number compared, with its limit: the cell's ``compare`` numbers
    at most their limits, enough positions, a retried attempt among them,
    no request failed."""
    checks = {k: {"value": found[k], "max": v} for k, v in limits["compare"].items()}
    checks.update(
        positions={"value": found["positions"], "min": limits["min_positions"]},
        retried={"value": sum(1 for a, _ in sample if a.retry), "min": 1},
        failed={"value": failed, "max": 0})
    return checks


def passed(checks: Dict[str, dict]) -> bool:
    return all(("max" not in c or c["value"] <= c["max"])
               and ("min" not in c or c["value"] >= c["min"])
               for c in checks.values())


def lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {name} {c['value']} "
            + (f"<= {c['max']}" if "max" in c else f">= {c['min']}")
            for name, c in checks.items()]
