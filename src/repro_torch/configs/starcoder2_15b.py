"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173]"""
from repro_torch.models.config import ATTN, FFN_GELU, BlockDef, ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    citation="arXiv:2402.19173",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    pattern=(BlockDef(ATTN, FFN_GELU),),
    rope_theta=100000.0,
)

REDUCED = reduced(CONFIG)
