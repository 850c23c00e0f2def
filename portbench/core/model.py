"""The weights the benchmark makes, and the program built on them.

The benchmark draws every weight itself from ``--seed``, on the device and
in the type it is served in, one call per kind of weight with all layers
stacked (``make_weights``).  The program's model is built without weights
(on ``meta``) and handed views of those tensors (``build_program``); the
plain reference reads the same tensors by the names below.  Nothing the
program derives from them is read back.

Names and layouts (L layers, d model width, H / Kv heads of width D, F the
MLP or expert width, E experts, Vp the vocabulary padded as the program
pads it)::

    embed (Vp, d)   unembed (d, Vp), untied only   final_norm (d,)
    ln1, ln2 (L, d)
    wq (L, d, H, D)   wk, wv (L, d, Kv, D)   wo (L, H, D, d)
    bq (L, H, D)   bk, bv (L, Kv, D)            QKV bias only
    q_norm, k_norm (L, D)                       QK-norm only
    mlp_wi, mlp_wg (L, d, F)   mlp_wo (L, F, d)  dense MLP: wo(silu(x wg) * x wi)
    router (L, d, E)   moe_wi, moe_wg (L, E, d, F)   moe_wo (L, E, F, d)
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def padded_vocab(cfg: dict) -> int:
    m = cfg["program"]["vocab_pad_multiple"]
    return -(-cfg["vocab_size"] // m) * m


def dims(cfg: dict) -> dict:
    H = cfg["num_attention_heads"]
    return dict(L=cfg["num_hidden_layers"], d=cfg["hidden_size"], H=H,
                Kv=cfg["num_key_value_heads"],
                D=cfg.get("head_dim", cfg["hidden_size"] // H),
                E=cfg.get("num_experts", 0),
                F=cfg.get("moe_intermediate_size") if cfg.get("num_experts")
                else cfg["intermediate_size"],
                V=cfg["vocab_size"], Vp=padded_vocab(cfg))


def weight_specs(cfg: dict) -> Dict[str, Tuple[tuple, float, float]]:
    """name -> (shape, mean, std) of every weight the benchmark draws."""
    n = dims(cfg)
    L, d, H, Kv, D, E, F, Vp = (n[k] for k in ("L", "d", "H", "Kv", "D", "E",
                                               "F", "Vp"))
    gain = (1.0, 0.1)

    def proj(fan_in):
        return (0.0, 1.0 / math.sqrt(fan_in))

    specs = {"embed": ((Vp, d), 0.0, 0.02), "final_norm": ((d,),) + gain,
             "ln1": ((L, d),) + gain, "ln2": ((L, d),) + gain,
             "wq": ((L, d, H, D),) + proj(d), "wk": ((L, d, Kv, D),) + proj(d),
             "wv": ((L, d, Kv, D),) + proj(d), "wo": ((L, H, D, d),) + proj(H * D)}
    if not cfg["tie_word_embeddings"]:
        specs["unembed"] = ((d, Vp),) + proj(d)
    if cfg["program"].get("qkv_bias"):
        specs.update(bq=((L, H, D), 0.0, 0.5), bk=((L, Kv, D), 0.0, 0.5),
                     bv=((L, Kv, D), 0.0, 0.5))
    if cfg["program"].get("qk_norm"):
        specs.update(q_norm=((L, D),) + gain, k_norm=((L, D),) + gain)
    if E:
        specs.update(router=((L, d, E),) + proj(d),
                     moe_wi=((L, E, d, F),) + proj(d),
                     moe_wg=((L, E, d, F),) + proj(d),
                     moe_wo=((L, E, F, d),) + proj(F))
    else:
        specs.update(mlp_wi=((L, d, F),) + proj(d), mlp_wg=((L, d, F),) + proj(d),
                     mlp_wo=((L, F, d),) + proj(F))
    return specs


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (seed * 0x9E3779B97F4A7C15 + 0x5EED) % 2**63)


def make_weights(cfg: dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """Every weight drawn from ``seed`` on ``device`` in ``dtype``, one
    normal draw per kind of weight."""
    W = {k: torch.empty(shape, dtype=dtype, device=device)
         for k, (shape, _, _) in weight_specs(cfg).items()}
    redraw_weights(cfg, W, seed)
    return W


def redraw_weights(cfg: dict, W: Dict[str, torch.Tensor], seed: int) -> None:
    """Draw ``W`` anew from ``seed`` in place: the same tensors, so a graph
    captured on them replays with the new weights."""
    gen = _generator(seed, next(iter(W.values())).device)
    for k, (_, mean, std) in weight_specs(cfg).items():
        W[k].normal_(mean, std, generator=gen)


def program_config(cfg: dict):
    """The port's ``ModelConfig`` for a benchmark configuration file."""
    from repro_torch.models.config import ModelConfig

    n, prog = dims(cfg), cfg["program"]
    extra = {}
    if n["E"]:
        extra = dict(num_experts=n["E"], experts_per_token=cfg["num_experts_per_tok"],
                     moe_d_ff=n["F"], capacity_factor=prog["capacity_factor"])
    return ModelConfig(
        name=cfg["name"], family=prog["family"], num_layers=n["L"],
        d_model=n["d"], num_heads=n["H"], num_kv_heads=n["Kv"], head_dim=n["D"],
        d_ff=n["F"], vocab_size=n["V"], rope_theta=cfg["rope_theta"],
        qkv_bias=bool(prog.get("qkv_bias")), qk_norm=bool(prog.get("qk_norm")),
        tie_embeddings=cfg["tie_word_embeddings"], norm_eps=cfg["rms_norm_eps"],
        act=cfg["hidden_act"], vocab_pad_multiple=prog["vocab_pad_multiple"],
        **extra)


_LAYER_KEYS = {
    "ln1": "ln1", "ln2": "ln2", "wq": "attn.wq", "wk": "attn.wk",
    "wv": "attn.wv", "wo": "attn.wo", "bq": "attn.bq", "bk": "attn.bk",
    "bv": "attn.bv", "q_norm": "attn.q_norm", "k_norm": "attn.k_norm",
    "mlp_wi": "mlp.wi", "mlp_wg": "mlp.wg", "mlp_wo": "mlp.wo",
    "router": "moe.router", "moe_wi": "moe.wi", "moe_wg": "moe.wg",
    "moe_wo": "moe.wo",
}


def build_program(cfg: dict, W: Dict[str, torch.Tensor]):
    """The program's model (``repro_torch``'s ``TransformerLM``, its kernel
    path) holding views of ``W``: built on ``meta``, then every parameter
    assigned."""
    from repro_torch.models.registry import build_model

    model = build_model(program_config(cfg), impl="kernel", device="meta",
                        dtype=W["embed"].dtype)
    sd = {k: W[k] for k in ("embed", "final_norm", "unembed") if k in W}
    for i in range(cfg["num_hidden_layers"]):
        for k, name in _LAYER_KEYS.items():
            if k in W:
                sd[f"layers.{i}.{name}"] = W[k][i]
    model.load_state_dict(sd, strict=True, assign=True)
    return model
