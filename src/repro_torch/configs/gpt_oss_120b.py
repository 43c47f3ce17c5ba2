"""gpt-oss-120b — the TIDE paper's primary target model (OpenAI, 2025,
arXiv:2508.10925): 36L d_model=2880 64H (GQA kv=8, head_dim 64), MoE 128
experts top-4, alternating sliding-window (128) / full attention layers,
vocab ~201k.  Used by the paper-faithful benchmarks (Figs. 5–9, Tables 1–5).

A copy of the JAX package's config, field for field.  Its pattern is two
full-attention ``ATTN`` blocks with ``window`` 0: the sliding-window
layers named above are not in the config, in the reference as here.
"""
from repro_torch.models.config import (ATTN, FFN_MOE, BlockDef,
                                 ModelConfig, reduced)

CONFIG = ModelConfig(
    name="gpt-oss-120b",
    family="moe",
    citation="arXiv:2508.10925",
    num_layers=36,
    d_model=2880,
    num_heads=64,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2880,
    vocab_size=201088,
    pattern=(BlockDef(ATTN, FFN_MOE), BlockDef(ATTN, FFN_MOE)),
    num_experts=128,
    experts_per_tok=4,
    moe_d_ff=2880,
    rope_theta=150000.0,
)

REDUCED = reduced(CONFIG, num_layers=2,
                  pattern=(BlockDef(ATTN, FFN_MOE),))
