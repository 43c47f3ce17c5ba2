"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE.  [arXiv:2402.19173]"""
from repro_torch.models.config import ATTN, FFN_GELU, BlockDef, ModelConfig, reduced

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    citation="arXiv:2402.19173",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    pattern=(BlockDef(ATTN, FFN_GELU),),
    rope_theta=100000.0,
)

REDUCED = reduced(CONFIG, num_heads=4, num_kv_heads=2)
