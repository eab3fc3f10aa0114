"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    pattern=(BlockDef(attn="global", ffn="moe"),),
    n_experts=32,
    moe_top_k=8,
    norm="rmsnorm",
    act="silu",
    ffn_gated=True,
    pos="rope",
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)
