"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from repro_torch.models.config import FFN_MOE, BlockDef, ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    pattern=(BlockDef("attn", FFN_MOE),),
    num_experts=40,
    experts_per_tok=8,
    moe_d_ff=512,
    rope_theta=10000.0,
)

REDUCED = reduced(CONFIG)
