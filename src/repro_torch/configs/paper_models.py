"""The paper's own model families as configs.

The paper evaluates DeiT-T/SReT-T/Swin-T (vision) and BERT-base (language).
For the paper-table benchmarks we reproduce the *transformer backbones* as
decoder/encoder-style configs driven by synthetic data at CPU scale. The
vision benchmarks use a ViT-like encoder stand-in (`paper-deit-t` reduced)
— patch embedding is the `frontend` stub, exactly like the assigned [vlm]
arch handling.
"""
from repro_torch.configs.base import ArchConfig, BlockDef

DEIT_T = ArchConfig(
    name="paper-deit-t",
    family="dense",
    n_layers=12,
    d_model=192,
    n_heads=3,
    n_kv_heads=3,
    d_ff=768,
    vocab_size=1000,       # ImageNet-1K classes (classification head)
    pattern=(BlockDef(attn="global", ffn="dense"),),
    norm="layernorm",
    act="gelu",
    ffn_gated=False,
    pos="learned",
    frontend="vision_patches",
    n_frontend_tokens=197,  # 14x14 patches + cls token
    source="[arXiv:2012.12877; hf]",
)

BERT_BASE = ArchConfig(
    name="paper-bert-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    pattern=(BlockDef(attn="global", ffn="dense"),),
    norm="layernorm",
    act="gelu",
    ffn_gated=False,
    pos="learned",
    source="[arXiv:1810.04805; hf]",
)
