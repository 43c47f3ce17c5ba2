"""deepseek-v3-671b [moe] — 61L d_model=7168 128H (GQA kv=128) d_ff=2048
vocab=129280, MoE 256e top-8 — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]

A copy of the JAX package's config, field for field.  MLA dims follow
the DeepSeek-V3 report: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope
64, v 128.  The first 3 layers are the dense prologue (SwiGLU, d_ff
18432, the report's); the MoE body's per-expert hidden is ``moe_d_ff``
2048.  ``mtp_depth=1`` is carried as a field: nothing in the reference
or the port reads it (ROADMAP, Reference state).
"""
from repro_torch.models.config import (FFN_MOE, FFN_SWIGLU, MLA, BlockDef,
                                       ModelConfig, reduced)

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    citation="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,              # dense prologue FFN
    vocab_size=129280,
    prologue=(BlockDef(MLA, FFN_SWIGLU),) * 3,
    pattern=(BlockDef(MLA, FFN_MOE),),
    num_experts=256,
    experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,           # assigned per-expert hidden
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10000.0,
    mtp_depth=1,
)

REDUCED = reduced(CONFIG)
