"""Architecture registry: --arch <id> lookup + reduced smoke-test configs."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ArchConfig

_MODULES = {
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "musicgen-medium": "repro_torch.configs.musicgen_medium",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    # The paper's own model families, reproduced as configs (DeiT-like /
    # BERT-like LM stand-ins used by the paper-table benchmarks).
    "paper-deit-t": "repro_torch.configs.paper_models",
    "paper-bert-base": "repro_torch.configs.paper_models",
}

ARCH_IDS = tuple(k for k in _MODULES if not k.startswith("paper-"))


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[name])
    if name == "paper-deit-t":
        return mod.DEIT_T
    if name == "paper-bert-base":
        return mod.BERT_BASE
    cfg = mod.CONFIG
    cfg.validate()
    return cfg


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Same-family reduced config for CPU smoke tests.

    Keeps the pattern (hence every block type is exercised), shrinks widths,
    depth (one pattern period + tail sample), vocab, window, experts.
    """
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    period = len(cfg.pattern)
    n_layers = period + (1 if cfg.n_layers % period else 0)
    reduced = dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(2, n_layers),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab_size=257,  # deliberately non-multiple => exercises vocab padding
        window=8,
        lru_width=64 if cfg.lru_width else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        n_frontend_tokens=8 if cfg.frontend == "vision_patches" else cfg.n_frontend_tokens,
        vocab_pad_multiple=16,
    )
    reduced.validate()
    return reduced
