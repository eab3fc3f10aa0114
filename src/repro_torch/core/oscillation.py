"""Oscillation telemetry (Eq. 11-12).

PyTorch counterpart of `repro.core.oscillation`:

  oscillation at step t:  x_t^int != x_{t-1}^int and sign(delta_t) differs
                          from the sign of the previous integer change
  frequency EMA:          f_t = m * o_t + (1 - m) * f_{t-1}

A weight oscillates when f_t exceeds a threshold (paper: 0.005). The state
is one `OscState` per quantized weight tensor: int8 codes, int8 direction
of the last change and the f32 EMA, 6 bytes a weight.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quantizer import QuantSpec, quantize_int


class OscState(NamedTuple):
    prev_int: torch.Tensor   # int8, w's shape
    prev_dir: torch.Tensor   # int8: sign of delta at the last change (0: none yet)
    freq: torch.Tensor       # f32 EMA of oscillation events


def init_osc_state(w: torch.Tensor, scale: torch.Tensor,
                   spec: QuantSpec) -> OscState:
    codes = quantize_int(w, scale, spec)
    return OscState(prev_int=codes, prev_dir=torch.zeros_like(codes),
                    freq=torch.zeros(w.shape, dtype=torch.float32,
                                     device=w.device))


@torch.no_grad()
def update_osc_state(state: OscState, w: torch.Tensor, scale: torch.Tensor,
                     spec: QuantSpec, momentum: float = 0.01) -> OscState:
    """One Eq. 12 update on the post-update weights; returns a new state."""
    codes = quantize_int(w, scale, spec)
    delta = codes.to(torch.int32) - state.prev_int.to(torch.int32)
    changed = delta != 0
    direction = torch.sign(delta).to(torch.int8)
    flip = changed & (state.prev_dir != 0) & (direction != state.prev_dir)
    freq = momentum * flip.to(torch.float32) + (1.0 - momentum) * state.freq
    prev_dir = torch.where(changed, direction, state.prev_dir)
    return OscState(prev_int=codes, prev_dir=prev_dir, freq=freq)


def oscillation_fraction(state: OscState, threshold: float = 0.005) -> torch.Tensor:
    """The Tab. 7/12/13 metric: the fraction of weights with f > threshold."""
    return torch.mean((state.freq > threshold).to(torch.float32))


@torch.no_grad()
def dampen_oscillating(w: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
                       state: OscState, threshold: float = 0.02) -> torch.Tensor:
    """Optional hard mitigation (beyond the paper, cf. Nagel et al. 2022):
    weights whose EMA exceeds `threshold` snap to their bin center."""
    codes = quantize_int(w, scale, spec)
    center = codes.to(w.dtype) * scale.to(w.dtype)
    return torch.where(state.freq > threshold, center, w)
