"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936 — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    pattern=(BlockDef(attn="global", ffn="dense"),),
    norm="rmsnorm",
    act="silu",
    ffn_gated=True,
    pos="rope",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
)
