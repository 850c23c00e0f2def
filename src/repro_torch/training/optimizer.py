"""AdamW, written out by hand, and the ZeRO-1 logical axes (counterpart of
``repro.training.optimizer``).

The math is the reference's: the gradients are clipped by their global
norm, the learning rate follows a linear warmup and a cosine decay to
``min_lr_ratio``, both moments are bias-corrected, the weight decay is
decoupled and added to the step's ``delta``, ``m`` and ``v`` are fp32
whatever the parameter's dtype, and the update is computed in fp32 and cast
back to the parameter's dtype.  ``torch.optim.AdamW`` keeps its state in
the parameter's dtype, so for bf16 parameters it is another function.

Parameters, gradients and the moments are flat dicts keyed by parameter
name (``model.named_parameters()``'s names).  The schedule, the norm and
the clipping scale stay 0-d tensors on the parameters' device, so a step
reads nothing back to the host.

``adamw_update_`` updates parameters and state in place (the train step's
form, the counterpart of the reference's donated buffers);
``adamw_update`` is the reference's functional form, the same arithmetic on
copies.

ZeRO-1 (``zero1_logical``): the optimizer state of a parameter shards its
first dimension that no tensor-parallel rule shards and that the data axis
divides.  The port has no mesh yet (``repro.distributed.sharding`` waits
for a later slice); the rule is ported as the pure function it is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """opt_state = {"m", "v": fp32 zeros per parameter, "step": () int32}
    on the parameters' device."""
    if not params:
        raise ValueError("no parameters")
    device = next(iter(params.values())).device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, fp32, at ``step``
    (a tensor; the result lies on its device)."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    total = None
    for x in tensors:
        sq = x.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        raise ValueError("global_norm of no tensors")
    return torch.sqrt(total)


def _check_keys(params, grads, opt_state) -> None:
    keys = set(params)
    for name, tree in (("grads", grads), ("m", opt_state["m"]),
                       ("v", opt_state["v"])):
        if set(tree) != keys:
            raise KeyError(f"{name} keys differ from the parameters': "
                           f"{sorted(set(tree) ^ keys)[:4]}")


@torch.no_grad()
def adamw_update_(
    cfg: AdamWConfig,
    grads: Mapping[str, torch.Tensor],
    opt_state: Dict[str, Any],
    params: Mapping[str, torch.Tensor],
) -> Dict[str, Any]:
    """One AdamW step in place: each parameter, ``m``, ``v`` and ``step``
    of ``opt_state`` are overwritten.  Returns ``opt_state``."""
    _check_keys(params, grads, opt_state)
    step = opt_state["step"] + 1
    gn = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    sf = step.float()
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    m_all, v_all = opt_state["m"], opt_state["v"]
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = m_all[name], v_all[name]
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g.square())
        del g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32.sub_(lr * delta))      # cast back to the param's dtype
    opt_state["step"].copy_(step)
    return opt_state


def adamw_update(
    cfg: AdamWConfig,
    grads: Mapping[str, torch.Tensor],
    opt_state: Mapping[str, Any],
    params: Mapping[str, torch.Tensor],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """The reference's functional form: (new_params, new_opt_state), the
    inputs left as they were."""
    new_params = {k: p.detach().clone() for k, p in params.items()}
    new_opt = {k: ({n: t.clone() for n, t in v.items()}
                   if isinstance(v, Mapping) else v.clone())
               for k, v in opt_state.items()}
    adamw_update_(cfg, grads, new_opt, new_params)
    return new_params, new_opt


# ---------------------------------------------------------------------------
# ZeRO-1 logical axes
# ---------------------------------------------------------------------------

TP_AXES = frozenset({"heads", "kv_heads", "mlp", "vocab", "experts",
                     "ssm_inner"})


def zero1_logical(logical: Sequence[Optional[str]],
                  shape: Sequence[int],
                  data_size: int) -> Tuple[Optional[str], ...]:
    """Optimizer-state logical axes for a parameter: the first dimension
    that no TP rule shards ('heads', 'kv_heads', 'mlp', 'vocab', 'experts',
    'ssm_inner') and that the data-axis size divides gets the 'zero' axis."""
    out = list(logical)
    for i, (name, dim) in enumerate(zip(logical, shape)):
        if name in TP_AXES:
            continue
        if dim % max(data_size, 1) == 0 and dim >= data_size > 1:
            out[i] = "zero"
            break
    return tuple(out)


def zero1_logical_tree(logical_tree: Mapping[str, Any],
                       shape_tree: Mapping[str, Any],
                       data_size: int) -> Dict[str, Any]:
    """``zero1_logical`` over a nested dict of logical-axis tuples, the
    shapes from the matching nested dict (tensors, or anything with a
    ``shape``, or shape tuples)."""
    out: Dict[str, Any] = {}
    for key, logical in logical_tree.items():
        ab = shape_tree[key]
        if isinstance(logical, Mapping):
            out[key] = zero1_logical_tree(logical, ab, data_size)
        else:
            shape = tuple(getattr(ab, "shape", ab))
            out[key] = zero1_logical(logical, shape, data_size)
    return out


__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "global_norm", "lr_schedule", "zero1_logical", "zero1_logical_tree"]
