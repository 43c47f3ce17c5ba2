"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA.  [hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ATTN, FFN_SWIGLU, BlockDef, ModelConfig, reduced

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    citation="hf:THUDM/glm-4-9b",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    pattern=(BlockDef(ATTN, FFN_SWIGLU),),
    rope_theta=10000.0,
)

REDUCED = reduced(CONFIG)
