"""The train step: loss and gradients, microbatched gradient accumulation,
optional int8 error-feedback gradient compression, AdamW (counterpart of
``repro.training.train_loop``).

``make_train_step`` returns ``train_step(opt_state, batch) -> metrics``.
It updates the model's parameters and ``opt_state`` in place under
``no_grad``, the PyTorch counterpart of the reference's pure step with its
parameters and optimizer state donated.  The arithmetic is the
reference's:

* ``microbatches`` > 1 splits the batch along axis 0; each microbatch's
  gradients are added into an accumulator of fp32 (``grad_accum=
  "f32_sharded"``) or bf16 (``"bf16_local"``; on one card the two differ
  only in the accumulator's dtype: there is no shard to reduce into), and
  the loss and the gradients are their means over the microbatches, the
  gradients in fp32.  With one microbatch the gradients stay in the
  parameters' dtype, as the reference's ``value_and_grad`` leaves them.
* ``compress_grads`` passes the gradients through the int8 error-feedback
  quantiser, the carried error kept in ``opt_state["ef_error"]``.
* The metrics are the mean ``loss``, ``grad_norm`` (of the gradients after
  compression, the ones the optimizer sees) and the optimizer's ``step``,
  as 0-d tensors on the model's device: nothing waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping

import torch

from repro_torch.distributed.compression import ef_quantize_tree
from repro_torch.training.optimizer import (
    AdamWConfig,
    adamw_update_,
    global_norm,
)

GRAD_ACCUM = {"f32_sharded": torch.float32, "bf16_local": torch.bfloat16}


def make_loss_fn(model, *, dtype: torch.dtype = torch.bfloat16) -> Callable:
    """loss_fn(batch) -> the model's loss on ``batch`` ({"tokens", "labels"}
    (B, S), and "frames" for an encoder-decoder or "patches" for a
    prefix-LM), activations in ``dtype`` (the reference's loss defaults to
    bf16)."""
    def loss_fn(batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
        if model.cfg.is_encdec:
            return model.loss(batch["frames"], batch["tokens"],
                              batch["labels"], dtype=dtype)
        return model.loss(batch["tokens"], batch["labels"],
                          prefix_embed=batch.get("patches"), dtype=dtype)
    return loss_fn


def make_train_step(
    model,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    compress_grads: bool = False,
    grad_accum: str = "f32_sharded",
    dtype: torch.dtype = torch.bfloat16,
) -> Callable[[Dict[str, Any], Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """train_step(opt_state, batch) -> metrics, for ``model``'s parameters
    that require grad (``model.requires_grad_(True)``), keyed by their
    names as ``opt_state``'s ``m`` and ``v`` (``adamw_init``)."""
    if grad_accum not in GRAD_ACCUM:
        raise ValueError(f"unknown grad_accum {grad_accum!r}; have "
                         f"{sorted(GRAD_ACCUM)}")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    params = {k: p for k, p in model.named_parameters() if p.requires_grad}
    if not params:
        raise ValueError("the model has no trainable parameter: call "
                         "model.requires_grad_(True)")
    names, tensors = list(params), list(params.values())
    loss_fn = make_loss_fn(model, dtype=dtype)
    acc_dtype = GRAD_ACCUM[grad_accum]

    def value_and_grad(batch):
        loss = loss_fn(batch)
        grads = torch.autograd.grad(loss, tensors)
        return loss.detach(), grads

    def compute_grads(batch):
        if microbatches == 1:
            loss, grads = value_and_grad(batch)
            return loss, dict(zip(names, grads))
        for k, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {k} of {x.shape[0]} not divisible "
                                 f"by microbatches {microbatches}")
        parts = {k: x.chunk(microbatches) for k, x in batch.items()}
        loss_sum = torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        # zeros_like: on a mesh each accumulator takes its parameter's
        # placements
        acc = [torch.zeros_like(p, dtype=acc_dtype) for p in tensors]
        for i in range(microbatches):
            loss, grads = value_and_grad({k: v[i] for k, v in parts.items()})
            loss_sum = loss_sum + loss
            for a, g in zip(acc, grads):
                a.add_(g.to(acc_dtype))
            del grads
        inv = 1.0 / microbatches
        return loss_sum * inv, {n: a.float() * inv for n, a in zip(names, acc)}

    def train_step(opt_state: Dict[str, Any],
                   batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, grads = compute_grads(batch)
        if compress_grads:
            grads, opt_state["ef_error"] = ef_quantize_tree(
                grads, opt_state.get("ef_error"))
        adamw_update_(opt_cfg, grads, opt_state, params)
        return {"loss": loss, "grad_norm": global_norm(grads.values()),
                "step": opt_state["step"].clone()}

    return train_step


__all__ = ["make_loss_fn", "make_train_step"]
