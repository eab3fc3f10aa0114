"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000 — RG-LRU + local attention, 1 attn : 2 recurrent (Griffin).
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    pattern=(BlockDef(attn="rglru", ffn="dense"),
             BlockDef(attn="rglru", ffn="dense"),
             BlockDef(attn="local", ffn="dense")),
    window=2048,
    lru_width=4096,
    conv_kernel=4,
    norm="rmsnorm",
    act="gelu",
    ffn_gated=True,
    pos="rope",
    tie_embeddings=True,
    source="[arXiv:2402.19427; unverified]",
)
