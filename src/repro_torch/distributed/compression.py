"""int8 error-feedback gradient compression (counterpart of
``repro.distributed.compression``).

Each gradient tensor is quantised to int8 with one symmetric scale per
tensor (round half to even, clipped to +-127) and dequantised; the
quantisation error is carried to the next step and added to that step's
gradient before it is quantised, so the error stays bounded over training
instead of growing with the step count.  On a single card nothing crosses
a link: the train step quantises and dequantises in place of the
reference's cross-pod all-reduce of the int8 form, so the optimizer sees
the same gradients.

Trees are flat dicts keyed by parameter name.  The reference's tree stacks
each per-layer parameter on a leading layer axis, so its "per tensor"
scale is one scale per stacked leaf, over every layer's copy: the port,
whose layers hold their own tensors, groups them back (``stacked_group``:
``layers.3.attn.wq`` is in the group ``layers.*.attn.wq``) and gives each
group one scale, so the two quantise alike.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

_LAYER_INDEX = re.compile(r"(?<=\.)\d+(?=\.)")


def stacked_group(name: str) -> str:
    """The reference leaf a port parameter is a layer's slice of: every
    layer index in the name becomes ``*`` (``blocks.1.2.mixer.D`` ->
    ``blocks.*.*.mixer.D``); a parameter of no stack is its own group."""
    return _LAYER_INDEX.sub("*", name)


def int8_scale(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """The symmetric int8 scale of ``xs`` taken as one tensor: max |x| /
    127 (at least 1e-12 / 127), fp32 ()."""
    amax = torch.stack([x.float().abs().max() for x in xs]).max()
    return torch.clamp(amax, min=1e-12) / 127.0


def quantize_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation, round half to even: (q int8, scale fp32
    ()), the scale ``x``'s own unless given."""
    xf = x.float()
    if scale is None:
        scale = int8_scale([xf])
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _ef_group(gs: List[torch.Tensor], errs: List[Optional[torch.Tensor]]
              ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Error-feedback quantisation of tensors that share one scale."""
    gfs = [g.float() if e is None else g.float() + e for g, e in zip(gs, errs)]
    scale = int8_scale(gfs)
    out = []
    for g, gf in zip(gs, gfs):
        g_hat = dequantize_int8(quantize_int8(gf, scale)[0], scale)
        out.append((g_hat.to(g.dtype), gf - g_hat))
    return out


def ef_quantize(
    g: torch.Tensor, err: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback quantisation of one gradient: (g_hat, new_err) with
    g_hat = dequant(quant(g + err)) in g's dtype and new_err = (g + err) -
    g_hat in fp32."""
    return _ef_group([g], [err])[0]


def ef_quantize_tree(
    grads: Mapping[str, torch.Tensor],
    err_tree: Optional[Mapping[str, torch.Tensor]],
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Error-feedback quantisation of every gradient, the carried errors by
    name (None: no error carried yet), one scale per ``stacked_group`` (the
    reference's stacked leaf)."""
    groups: Dict[str, List[str]] = {}
    for name in grads:
        groups.setdefault(stacked_group(name), []).append(name)
    g_hat: Dict[str, torch.Tensor] = {}
    new_err: Dict[str, torch.Tensor] = {}
    for names in groups.values():
        errs = [None if err_tree is None else err_tree[n] for n in names]
        for n, (gh, e) in zip(names, _ef_group([grads[n] for n in names], errs)):
            g_hat[n], new_err[n] = gh, e
    return g_hat, new_err


def compression_ratio(nbytes_fp32: int) -> float:
    """Bytes of int8 plus its scale over the fp32 bytes (the 4x headline)."""
    return (nbytes_fp32 // 4 + 4) / max(nbytes_fp32, 1)


__all__ = ["compression_ratio", "dequantize_int8", "ef_quantize",
           "ef_quantize_tree", "int8_scale", "quantize_int8", "stacked_group"]
