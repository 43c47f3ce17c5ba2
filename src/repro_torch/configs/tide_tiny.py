"""tide-tiny — a ~6M-parameter dense target model that runs end-to-end on
CPU.  Used by examples/ and the live TIDE engine tests/benchmarks (the
paper's Fig. 5/6/9 dynamics are reproduced at this scale)."""
from repro_torch.models.config import ATTN, FFN_SWIGLU, BlockDef, ModelConfig, reduced

CONFIG = ModelConfig(
    name="tide-tiny",
    family="dense",
    citation="(live-demo model, this repo)",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    pattern=(BlockDef(ATTN, FFN_SWIGLU),),
    dtype="float32",
    chunk_len=16,
    attn_block_q=64,
    attn_block_kv=128,
)

REDUCED = reduced(CONFIG)
