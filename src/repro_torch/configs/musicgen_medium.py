"""musicgen-medium [audio]: 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens. The EnCodec/codebook frontend
is a STUB per the brief: input_specs() provides precomputed frame embeddings
(batch, seq, d_model) summed into the token stream. [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ArchConfig, BlockDef

CONFIG = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pattern=(BlockDef(attn="global", ffn="dense"),),
    norm="layernorm",
    act="gelu",
    ffn_gated=False,
    pos="learned",
    frontend="audio_frames",
    n_frontend_tokens=0,  # frame embeddings are per-token (added), not extra tokens
    source="[arXiv:2306.05284; hf]",
)
