"""Architecture configuration schema.

An ArchConfig fully determines a decoder-style backbone: the layer stack is
`pattern` repeated cyclically for n_layers (scan groups over full pattern
periods + an unrolled tail for the remainder), each position described by a
BlockDef. All configs are frozen/hashable so they can ride as jit statics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockDef:
    """One position in the repeating layer pattern."""

    attn: str = "global"   # global | local | mlstm | slstm | rglru | none
    ffn: str = "dense"     # dense | moe | none
    cross_attn: bool = False  # extra cross-attention sublayer (VLM)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str            # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    pattern: Tuple[BlockDef, ...] = (BlockDef(),)
    window: int = 4096     # sliding/local attention window
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    sandwich_norm: bool = False  # post-sublayer norms (gemma2)
    act: str = "silu"      # silu | gelu
    ffn_gated: bool = True # GLU-style FFN (gate * up)
    pos: str = "rope"      # rope | learned | none
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    capacity_factor: float = 1.25
    # Dispatch locality groups: routing/capacity applied per group so the
    # scatter/gather stays within a data shard (no cross-shard collectives;
    # set to the DP degree by the launcher). 1 = global routing.
    moe_dispatch_groups: int = 1
    # Recurrent blocks
    conv_kernel: int = 4
    lru_width: int = 0     # rglru: 0 -> d_model
    # Frontend stubs for [audio]/[vlm] (precomputed embeddings per the brief)
    frontend: str = "none"  # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0
    tie_embeddings: bool = False
    # Numerics / padding
    dtype: str = "bfloat16"
    max_seq: int = 32_768   # learned-position table size / cache ceiling
    causal: bool = True     # False: encoder-style (paper's ViT/BERT stand-ins)
    vocab_pad_multiple: int = 256
    source: str = ""        # provenance note ([arXiv/hf; tier])

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def period(self) -> int:
        return len(self.pattern)

    @property
    def n_groups(self) -> int:
        """Full pattern periods covered by lax.scan."""
        return self.n_layers // self.period

    @property
    def n_tail(self) -> int:
        """Remainder layers (< period) applied after the scan, unrolled."""
        return self.n_layers % self.period

    def block_at(self, layer: int) -> BlockDef:
        return self.pattern[layer % self.period]

    @property
    def uses_attention(self) -> bool:
        return any(b.attn in ("global", "local") or b.cross_attn for b in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when decode state is bounded (window/recurrent) in all layers
        OR the arch is recurrent/hybrid — the long_500k eligibility rule
        (DESIGN.md Sec. 5)."""
        kinds = {b.attn for b in self.pattern}
        if kinds <= {"local", "mlstm", "slstm", "rglru", "none"}:
            return True
        # gemma2-style local/global alternation: global layers hold a long KV
        # but decode is O(seq) per token and the cache seq axis is sharded.
        return "local" in kinds or "rglru" in kinds or "mlstm" in kinds

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, (self.name, "q_per_kv")
        assert self.d_model > 0 and self.n_layers > 0
        for b in self.pattern:
            if b.ffn == "moe":
                assert self.n_experts > 1 and 0 < self.moe_top_k <= self.n_experts
        if self.frontend == "vision_patches":
            assert self.n_frontend_tokens > 0

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- model-FLOPs accounting (roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, hd = self.d_model, self.head_dim_
        n_attn = 0
        n_ffn = 0
        n_rec = 0
        for i in range(self.n_layers):
            b = self.block_at(i)
            if b.attn in ("global", "local"):
                n_attn += d * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
                n_attn += self.n_heads * hd * d  # o
                if self.qkv_bias:
                    n_attn += hd * (self.n_heads + 2 * self.n_kv_heads)
            elif b.attn == "mlstm":
                du = 2 * d
                n_rec += d * 2 * du + du * 3 * du // 1 + du * d  # up, qkv-ish, down
            elif b.attn == "slstm":
                n_rec += d * 4 * d + 4 * d * d // self.n_heads + d * d
            elif b.attn == "rglru":
                w = self.lru_width or d
                n_rec += d * 2 * w + w * d + w * (self.conv_kernel + 3)
            if b.cross_attn:
                n_attn += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            if b.ffn == "dense":
                mult = 3 if self.ffn_gated else 2
                n_ffn += mult * d * self.d_ff
            elif b.ffn == "moe":
                mult = 3 if self.ffn_gated else 2
                e = self.moe_top_k if active_only else self.n_experts
                n_ffn += e * mult * d * self.d_ff + d * self.n_experts
        n_embed = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return n_attn + n_ffn + n_rec + n_embed
