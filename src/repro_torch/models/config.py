"""Model configuration (port of ``repro/models/config.py``).

A copy of the JAX package's dataclass, field for field, so a config
built here compares equal field-by-field with the reference; the only
difference is that ``act_dtype``/``weight_dtype`` return torch dtypes.

One frozen dataclass describes every architecture family of the
reference (dense / MoE / MLA / hybrid / SSM / VLM / audio); layer
heterogeneity is a repeating *block pattern* of stacked homogeneous
parameter groups.  The port runs the dense attention families so far.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# Mixer kinds usable inside a block pattern.
ATTN = "attn"          # GQA self attention (RoPE)
ATTN_SW = "attn_sw"    # sliding-window self attention
MLA = "mla"            # DeepSeek multi-head latent attention
MAMBA = "mamba"        # Mamba-1 selective SSM
RWKV6 = "rwkv6"        # RWKV-6 (Finch) time mix
CROSS = "cross"        # cross attention (VLM image / enc-dec memory)

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}

# FFN kinds.
FFN_SWIGLU = "swiglu"
FFN_GELU = "gelu"      # starcoder2 / whisper style
FFN_MOE = "moe"


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One layer inside a repeating superblock."""
    mixer: str = ATTN
    ffn: str = FFN_SWIGLU
    cross: bool = False   # additional cross-attn sub-layer (enc-dec decoder)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | hybrid | ssm | vlm | audio
    citation: str = ""

    # Core dims.
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 1024

    # Layer pattern: ``pattern`` repeated ``num_layers // len(pattern)`` times,
    # with ``prologue`` dense layers before it (DeepSeek's first-k-dense).
    pattern: Tuple[BlockDef, ...] = (BlockDef(),)
    prologue: Tuple[BlockDef, ...] = ()

    # Attention.
    rope_theta: float = 10000.0
    window: int = 0               # 0 = full attention; >0 = sliding window
    attn_logit_softcap: float = 0.0

    # MoE.
    num_experts: int = 0
    experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0             # per-expert hidden dim (falls back to d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # MLA (DeepSeek-V3).
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # Mamba.
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0        # 0 -> ceil(d_model / 16)

    # RWKV6.
    rwkv_head_dim: int = 64

    # VLM (cross-attention to image patch embeddings).
    num_image_tokens: int = 0

    # Audio enc-dec (whisper): encoder layers with bidirectional attention;
    # decoder = ``num_layers`` causal layers with cross attention.
    encoder_layers: int = 0
    decoder_len: int = 256        # teacher-forced decoder length in training

    # Multi-token prediction (DeepSeek MTP) — optional extra head depth.
    mtp_depth: int = 0

    # Numerics / training.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # EAGLE-3 capture layers (low/mid/high); -1 → auto from num_layers.
    capture_layers: Tuple[int, int, int] = (-1, -1, -1)

    # The next three fields are kept for field parity with the reference
    # config and are not read by the port: its kernel choice follows the
    # device of the tensors (Hopper kernels on CUDA, plain torch on CPU).
    use_pallas: bool = False
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    # RWKV / linear-attention chunk length.
    chunk_len: int = 64

    def __post_init__(self):
        body = self.num_layers - len(self.prologue)
        if self.pattern and body % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: body layers {body} not divisible by pattern "
                f"{len(self.pattern)}")

    # ---- derived ----
    @property
    def act_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    @property
    def weight_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.param_dtype]

    @property
    def num_pattern_repeats(self) -> int:
        return (self.num_layers - len(self.prologue)) // len(self.pattern)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def moe_hidden(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def captures(self) -> Tuple[int, int, int]:
        """Indices of the low/mid/high hidden-state capture layers (EAGLE-3)."""
        lo, mid, hi = self.capture_layers
        n = self.num_layers
        if lo < 0:
            lo = min(2, n - 1)
        if mid < 0:
            mid = n // 2
        if hi < 0:
            hi = max(n - 3, 0)
        return (lo, mid, hi)

    @property
    def layer_kinds(self) -> Tuple[BlockDef, ...]:
        """Flattened per-layer block defs, prologue first."""
        return self.prologue + self.pattern * self.num_pattern_repeats

    def param_count(self) -> int:
        """Approximate parameter count (reported in benchmarks/docs)."""
        from repro_torch.models import transformer  # local import, avoids cycle
        from repro_torch.models.param import count_params
        return count_params(transformer.param_specs(self))

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts in use)."""
        total = self.param_count()
        if not self.num_experts:
            return total
        # Remove inactive expert weights.
        kinds = self.layer_kinds
        n_moe = sum(1 for b in kinds if b.ffn == FFN_MOE)
        per_expert = 3 * self.d_model * self.moe_hidden
        inactive = n_moe * (self.num_experts - self.experts_per_tok) * per_expert
        return total - inactive


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (≤2 layers, d≤512, ≤4 experts)."""
    changes = dict(
        num_layers=max(len(cfg.prologue) + len(cfg.pattern), 2)
        if (cfg.prologue or len(cfg.pattern) > 1) else 2,
        d_model=min(cfg.d_model, 128),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        head_dim=min(cfg.head_dim, 32),
        d_ff=min(cfg.d_ff, 256),
        vocab_size=min(cfg.vocab_size, 512),
        num_image_tokens=min(cfg.num_image_tokens, 16) if cfg.num_image_tokens else 0,
        encoder_layers=min(cfg.encoder_layers, 2) if cfg.encoder_layers else 0,
        decoder_len=min(cfg.decoder_len, 32),
        chunk_len=16,
        attn_block_q=64,
        attn_block_kv=64,
        dtype="float32",
    )
    if cfg.num_experts:
        changes.update(num_experts=4, experts_per_tok=min(cfg.experts_per_tok, 2),
                       moe_d_ff=min(cfg.moe_hidden, 128))
    if cfg.q_lora_rank or cfg.kv_lora_rank:
        changes.update(q_lora_rank=64, kv_lora_rank=64, qk_nope_head_dim=32,
                       qk_rope_head_dim=16, v_head_dim=32)
    if cfg.window:
        changes["window"] = min(cfg.window, 64)
    # Shrink prologue to at most 1 layer to keep tiny models tiny.
    if cfg.prologue:
        changes["prologue"] = cfg.prologue[:1]
        changes["num_layers"] = 1 + len(cfg.pattern)
    # mamba dims scale with d_model automatically via properties.
    kvh = changes["num_kv_heads"]
    nh = changes["num_heads"]
    if nh % kvh:
        changes["num_kv_heads"] = 1
    changes.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
