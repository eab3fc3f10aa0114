"""Module-dependent quantization policy (the paper's MDQ, Sec. 4.4.1).

A policy maps a *module kind* (what role a linear plays in the network) to a
pair of QuantSpecs (weights, activations). The paper's scheme:

  * attention q/k/v/o projections  -> per-HEAD learnable scales
  * FFN / everything else          -> per-tensor (layer-wise) scales
  * first (embedding) & last (head) layers pinned to 8-bit
  * scale gradients rescaled by g = 1/sqrt(Q_P * ||w||_1)  ("module_l1")

The LSQ+ baseline ("lsq" mode) uses per-tensor scales everywhere with the
original 1/sqrt(N*Q_P) gradient scale, so benchmarks can compare the two on
identical models.

Beyond-paper extension: per-EXPERT scales for MoE expert weights ("module"
granularity generalized to the expert axis) and per-head scales for cross-
attention projections in VLM backbones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.quantizer import QuantSpec

# Module kinds understood by the policy. Models tag each quantizable tensor
# with one of these.
ATTN_KINDS = ("attn_q", "attn_k", "attn_v", "attn_o",
              "cross_q", "cross_k", "cross_v", "cross_o")
FFN_KINDS = ("ffn_in", "ffn_gate", "ffn_out")
MOE_KINDS = ("moe_in", "moe_gate", "moe_out")
RECURRENT_KINDS = ("xlstm_qkv", "xlstm_gates", "xlstm_proj",
                   "rglru_in", "rglru_out", "rglru_conv")
EDGE_KINDS = ("embed", "lm_head", "frontend")
AUX_KINDS = ("router",)

ALL_KINDS = ATTN_KINDS + FFN_KINDS + MOE_KINDS + RECURRENT_KINDS + EDGE_KINDS + AUX_KINDS


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Network-level quantization configuration (static / hashable)."""

    w_bits: int = 32            # 32 => weights stay full precision
    a_bits: int = 32            # 32 => activations stay full precision
    mode: str = "mdq"           # "mdq" (paper's method) | "lsq" (baseline) | "off"
    edge_bits: int = 8          # first/last layer pin (paper Sec. 5.1)
    router_bits: int = 8        # MoE router / LRU decay gates pin
    recurrent_state_bits: int = 8  # gates whose error compounds over time
    # OBR (Eq. 10). lambda ramps 0 -> obr_lambda with a cosine schedule.
    obr_lambda: float = 0.0
    # Oscillation telemetry (Eq. 11-12) carried in the train state.
    track_oscillation: bool = False
    osc_momentum: float = 0.01
    osc_threshold: float = 0.005
    # Serving-time KV cache quantization (beyond-paper; 0 = fp16/bf16 cache).
    kv_cache_bits: int = 0
    # Serving int(4)_matmul dispatch (kernels/quant_matmul):
    #   "auto": the kernel route — the CUDA kernel for a CUDA tensor, its
    #           plain PyTorch version for a CPU tensor
    #   "on":   the kernel route, and raise unless the tensor is on CUDA
    #   "off":  the unfused dequantize + matmul composition
    fused_matmul: str = "auto"
    # Flash-decode attention over the pooled KV cache
    # (kernels/decode_attention): routes attend_decode and the cached side
    # of attend_chunk through a kernel that dequantizes int8/int4 KV per
    # tile with in-kernel pos masks and online softmax. Same tristate.
    fused_attention: str = "auto"
    # Sensitivity-analysis overrides (Tab. 1 / Tab. 9 harness):
    #   fp_kinds:   module kinds forced to full precision (leave-one-out)
    #   only_kinds: if set, ONLY these kinds are quantized (quantize-one-only)
    fp_kinds: tuple = ()
    only_kinds: Optional[tuple] = None

    @property
    def enabled(self) -> bool:
        return self.mode != "off" and (self.w_bits < 32 or self.a_bits < 32)

    def _skip(self, kind: str) -> bool:
        if kind in self.fp_kinds:
            return True
        if self.only_kinds is not None and kind not in self.only_kinds:
            return True
        return False

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


FP32 = None  # sentinel: tensor stays full-precision


def weight_spec(cfg: QuantConfig, kind: str) -> Optional[QuantSpec]:
    """QuantSpec for the weights of a module of the given kind (or None=FP)."""
    if not cfg.enabled or cfg.w_bits >= 32:
        return FP32
    if kind not in ALL_KINDS:
        raise KeyError(f"unknown module kind {kind!r}")
    if cfg._skip(kind):
        return FP32

    grad_mode = "module_l1" if cfg.mode == "mdq" else "lsq"

    if kind in EDGE_KINDS:
        bits = min(cfg.edge_bits, 8)
        return QuantSpec(bits=bits, signed=True, granularity="per_tensor",
                         grad_scale_mode=grad_mode)
    if kind in AUX_KINDS:
        return QuantSpec(bits=cfg.router_bits, signed=True, granularity="per_tensor",
                         grad_scale_mode=grad_mode)
    if kind in ATTN_KINDS and cfg.mode == "mdq":
        # MDQ: per-head scale. Weights are stored with an explicit head axis
        # (see models/common.py); the scale's broadcastable shape keeps the
        # head axis and is 1 elsewhere.
        return QuantSpec(bits=cfg.w_bits, signed=True, granularity="per_head",
                         grad_scale_mode=grad_mode)
    if kind in MOE_KINDS and cfg.mode == "mdq":
        # Beyond-paper: expert axis as a module axis (expert weights are
        # stored (E, d_in, d_out); scale keeps the expert axis).
        return QuantSpec(bits=cfg.w_bits, signed=True, granularity="per_expert",
                         grad_scale_mode=grad_mode)
    if kind == "xlstm_qkv" and cfg.mode == "mdq":
        return QuantSpec(bits=cfg.w_bits, signed=True, granularity="per_head",
                         grad_scale_mode=grad_mode)
    if kind == "xlstm_gates" or kind == "rglru_conv":
        # Gate weights parameterize decay/retention; rounding error compounds
        # over the sequence (DESIGN.md Sec. 5), pin to >= 8 bits.
        return QuantSpec(bits=max(cfg.w_bits, cfg.recurrent_state_bits), signed=True,
                         granularity="per_tensor", grad_scale_mode=grad_mode)
    return QuantSpec(bits=cfg.w_bits, signed=True, granularity="per_tensor",
                     grad_scale_mode=grad_mode)


def act_spec(cfg: QuantConfig, kind: str) -> Optional[QuantSpec]:
    """QuantSpec for the input activations of a module (or None=FP)."""
    if not cfg.enabled or cfg.a_bits >= 32:
        return FP32
    if cfg._skip(kind):
        return FP32
    grad_mode = "module_l1" if cfg.mode == "mdq" else "lsq"
    if kind in EDGE_KINDS or kind in AUX_KINDS:
        return QuantSpec(bits=min(cfg.edge_bits, 8), signed=False, offset=True,
                         granularity="per_tensor", grad_scale_mode=grad_mode)
    if kind in ("xlstm_gates", "rglru_conv"):
        return QuantSpec(bits=max(cfg.a_bits, cfg.recurrent_state_bits), signed=False,
                         offset=True, granularity="per_tensor", grad_scale_mode=grad_mode)
    # LSQ+ asymmetric activations (learned offset) everywhere else.
    return QuantSpec(bits=cfg.a_bits, signed=False, offset=True,
                     granularity="per_tensor", grad_scale_mode=grad_mode)


def kv_cache_spec(cfg: QuantConfig) -> Optional[QuantSpec]:
    """Per-head KV cache quantizer for serving (beyond-paper)."""
    if cfg.kv_cache_bits <= 0 or cfg.kv_cache_bits >= 16:
        return FP32
    return QuantSpec(bits=cfg.kv_cache_bits, signed=True, granularity="per_head",
                     grad_scale_mode="none")


# Named presets used by configs/CLI.
PRESETS = {
    "fp": QuantConfig(mode="off"),
    "w8a8": QuantConfig(w_bits=8, a_bits=8, mode="mdq"),
    "w4a4": QuantConfig(w_bits=4, a_bits=4, mode="mdq"),
    "w3a3": QuantConfig(w_bits=3, a_bits=3, mode="mdq", obr_lambda=0.1),
    "w2a2": QuantConfig(w_bits=2, a_bits=2, mode="mdq", obr_lambda=0.1),
    "w1a1": QuantConfig(w_bits=1, a_bits=1, mode="mdq", obr_lambda=0.1),
    "w4a4_lsq": QuantConfig(w_bits=4, a_bits=4, mode="lsq"),
    "w3a3_lsq": QuantConfig(w_bits=3, a_bits=3, mode="lsq"),
    "w2a2_lsq": QuantConfig(w_bits=2, a_bits=2, mode="lsq"),
}


def get_preset(name: str) -> QuantConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown quant preset {name!r}; have {sorted(PRESETS)}") from None
