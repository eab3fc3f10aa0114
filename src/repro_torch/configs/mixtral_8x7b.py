"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    pattern=(BlockDef(attn="local", ffn="moe"),),
    window=4096,
    n_experts=8,
    moe_top_k=2,
    norm="rmsnorm",
    act="silu",
    ffn_gated=True,
    pos="rope",
    rope_theta=1_000_000.0,
    source="[arXiv:2401.04088; hf]",
)
