"""Shared layers (port of ``repro/models/layers.py``): RMSNorm, the
SwiGLU FFN, the token embedding and the LM head."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import FFN_SWIGLU, ModelConfig
from repro_torch.models.param import ParamSpec

# Logical axis names (kept from the reference so the specs compare equal).
EMBED = "embed"
MLP = "mlp"
HEADS = "heads"
KV_HEADS = "kv_heads"
QKV = "qkv"
VOCAB = "vocab"
LAYERS = "layers"


def rmsnorm_specs(d: int) -> dict:
    return {"scale": ParamSpec((d,), (EMBED,), init="ones")}


def rmsnorm(params, x, eps: float):
    """fp32 statistics, output in the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def ffn_specs(cfg: ModelConfig, kind: str, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    if kind != FFN_SWIGLU:
        raise NotImplementedError(
            f"FFN {kind!r} is not ported yet (ROADMAP queue 1 "
            "item 8: other model families)")
    return {
        "w_gate": ParamSpec((d, f), (EMBED, MLP)),
        "w_up": ParamSpec((d, f), (EMBED, MLP)),
        "w_down": ParamSpec((f, d), (MLP, EMBED)),
    }


def ffn(params, x, kind: str = FFN_SWIGLU, linear=torch.matmul):
    """SwiGLU; ``linear`` computes its three matrix products."""
    if kind != FFN_SWIGLU:
        raise NotImplementedError(
            f"FFN {kind!r} is not ported yet (ROADMAP queue 1 "
            "item 8: other model families)")
    g = linear(x, params["w_gate"])
    u = linear(x, params["w_up"])
    return linear(F.silu(g) * u, params["w_down"])


def embed_specs(cfg: ModelConfig) -> dict:
    return {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), (VOCAB, EMBED),
                             init="embed")}


def embed(params, tokens, dtype):
    return params["tok"][tokens.long()].to(dtype)


def head_specs(cfg: ModelConfig) -> dict:
    if cfg.tie_embeddings:
        return {}
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_size), (EMBED, VOCAB))}


def lm_head(params, embed_params, x, tie: bool, linear=torch.matmul):
    """``linear`` computes the product (a tied head's weight is the
    transposed embedding, which ``linear_rows`` does not take on the
    card)."""
    if tie:
        return linear(x, embed_params["tok"].to(x.dtype).T)
    return linear(x, params["w"].to(x.dtype))
