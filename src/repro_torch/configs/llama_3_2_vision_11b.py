"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attn image layers every 5th layer. The vision tower is
a STUB per the brief: input_specs() provides precomputed patch embeddings
(batch, n_patches, d_model) consumed as cross-attention KV.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    pattern=(BlockDef(attn="global", ffn="dense"),
             BlockDef(attn="global", ffn="dense"),
             BlockDef(attn="global", ffn="dense"),
             BlockDef(attn="global", ffn="dense"),
             BlockDef(attn="global", ffn="dense", cross_attn=True)),
    norm="rmsnorm",
    act="silu",
    ffn_gated=True,
    pos="rope",
    rope_theta=500_000.0,
    frontend="vision_patches",
    n_frontend_tokens=1024,
    source="[hf:meta-llama/Llama-3.2-11B-Vision; unverified]",
)
