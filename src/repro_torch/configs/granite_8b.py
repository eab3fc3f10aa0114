"""granite-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152 — llama-arch, code. [arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    pattern=(BlockDef(attn="global", ffn="dense"),),
    norm="rmsnorm",
    act="silu",
    ffn_gated=True,
    pos="rope",
    rope_theta=10_000_000.0,
    source="[arXiv:2405.04324; hf]",
)
