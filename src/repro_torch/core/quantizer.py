"""Uniform quantizers with learnable scale (LSQ) and offset (LSQ+), serving subset.

PyTorch counterpart of `repro.core.quantizer` for the inference path: the
integer codes (Eq. 5 without the STE), nibble packing, the LSQ scale init,
and the forward value of `fake_quant` that the tied serving head still
applies to its input activations. The training-side STE gradients (Eq. 6-7)
come with the training slice.

Conventions shared with the JAX package:
  * scales are stored BROADCASTABLE against their tensor (per-head scale of a
    (d_model, heads, head_dim) weight is (1, heads, 1); per-tensor is 0-d);
  * `round` is half-to-even (`torch.round` is);
  * `pack_int4` puts code 2p in the low nibble and 2p+1 in the high nibble of
    byte p, two's complement; unpacking shifts in int32 so the arithmetic
    right shift sign-extends each nibble.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Minimum representable scale; keeps division well-posed when s is learned.
EPS_SCALE = 1e-9


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantizer (hashable)."""

    bits: int = 8
    signed: bool = True
    # per_tensor | per_head | per_expert | per_channel (the grouping itself
    # is carried by the scale's broadcastable shape)
    granularity: str = "per_tensor"
    # LSQ+ learnable offset (asymmetric quantization, used for activations).
    offset: bool = False
    # module_l1 (paper's g = 1/sqrt(Q_P*||w||_1)) | lsq | none
    grad_scale_mode: str = "module_l1"

    def __post_init__(self):
        if self.bits < 1 or self.bits > 8:
            raise ValueError(f"bits must be in [1, 8], got {self.bits}")
        if self.granularity not in ("per_tensor", "per_head", "per_expert", "per_channel"):
            raise ValueError(f"unknown granularity {self.granularity!r}")
        if self.grad_scale_mode not in ("module_l1", "lsq", "none"):
            raise ValueError(f"unknown grad_scale_mode {self.grad_scale_mode!r}")

    @property
    def q_n(self) -> int:
        """Number of negative levels (Eq. 5)."""
        if self.bits == 1:
            return 1 if self.signed else 0
        return 2 ** (self.bits - 1) if self.signed else 0

    @property
    def q_p(self) -> int:
        """Number of positive levels (Eq. 5)."""
        if self.bits == 1:
            return 1
        return 2 ** (self.bits - 1) - 1 if self.signed else 2**self.bits - 1

    @property
    def n_bins(self) -> int:
        return self.q_n + self.q_p + 1


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32)


def _group_reduce_dims(scale_shape: tuple[int, ...], x_shape: tuple[int, ...]):
    """Dims of x reduced per scale group (where the scale broadcasts)."""
    if len(scale_shape) == 0:
        return tuple(range(len(x_shape)))
    assert len(scale_shape) == len(x_shape), (
        f"scale shape {scale_shape} must be 0-d or match rank of {x_shape}")
    return tuple(i for i, s in enumerate(scale_shape) if s == 1)


def scale_grad_factor(spec: QuantSpec, w: torch.Tensor,
                      scale_shape: tuple[int, ...]) -> torch.Tensor:
    """Gradient scale g for the learnable scale, shaped like the scale.

    Only its forward VALUE matters in serving: `grad_scale` is the identity
    up to the float rounding of `s*g + (s - s*g)`, which the JAX package's
    forward carries and this port reproduces.
    """
    if spec.grad_scale_mode == "none":
        return torch.ones(scale_shape, dtype=torch.float32, device=w.device)
    dims = _group_reduce_dims(scale_shape, tuple(w.shape))
    if spec.grad_scale_mode == "lsq":
        n = 1.0
        for a in dims:
            n *= w.shape[a]
        val = 1.0 / torch.sqrt(torch.tensor(n * spec.q_p, dtype=torch.float32))
        return torch.full(scale_shape, float(val), dtype=torch.float32,
                          device=w.device)
    l1 = torch.sum(torch.abs(w.to(torch.float32)), dim=dims,
                   keepdim=bool(len(scale_shape)))
    return 1.0 / torch.sqrt(spec.q_p * torch.clamp(l1, min=EPS_SCALE))


def grad_scale_value(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Forward value of `repro.core.quantizer.grad_scale`: x*g + (x - x*g)."""
    xg = x * g
    return xg + (x - xg)


def fake_quant_forward(x: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
                       offset: Optional[torch.Tensor] = None,
                       grad_scale_ref: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward value of `repro.core.quantizer.fake_quant` (no gradients).

    Same operation order and dtypes as the JAX function, so the rounding of
    every step matches: the scale passes through the identity-valued
    grad_scale, is floored at EPS_SCALE and cast to x's dtype before the
    division.
    """
    ref = x if grad_scale_ref is None else grad_scale_ref
    sshape = tuple(scale.shape)
    if len(sshape) == 0 or ref.dim() == len(sshape):
        g = scale_grad_factor(spec, ref, sshape)
    else:
        g = scale_grad_factor(spec, ref, ()).expand(sshape)
    s = grad_scale_value(scale, g)
    s = torch.clamp(s, min=EPS_SCALE).to(x.dtype)
    if offset is not None:
        b = grad_scale_value(offset, g).to(x.dtype)
        xs = (x - b) / s
    else:
        xs = x / s
    if spec.bits == 1 and spec.signed:
        xq = torch.where(xs >= 0, 1.0, -1.0).to(x.dtype) * s
    else:
        xs = torch.clamp(xs, -float(spec.q_n), float(spec.q_p))
        xq = torch.round(xs) * s
    if offset is not None:
        xq = xq + b
    return xq


def quantize_int(x: torch.Tensor, scale, spec: QuantSpec,
                 offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Integer codes (no STE; used for serving)."""
    s = torch.clamp(_f32(scale).to(x.device), min=EPS_SCALE)
    xs = x / s if offset is None else (x - offset) / s
    if spec.bits == 1 and spec.signed:
        return torch.where(xs >= 0, 1, -1).to(torch.int8)
    return torch.clamp(torch.round(xs), -spec.q_n, spec.q_p).to(torch.int8)


def dequantize_int(codes: torch.Tensor, scale, spec: QuantSpec,
                   offset: Optional[torch.Tensor] = None,
                   dtype=torch.float32) -> torch.Tensor:
    s = torch.clamp(_f32(scale).to(codes.device), min=EPS_SCALE).to(dtype)
    out = codes.to(dtype) * s
    if offset is not None:
        out = out + offset.to(dtype)
    return out


def pack_int4(codes: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack codes in [-8, 7] two-per-int8-byte along ``axis`` (even size).

    Byte p holds code 2p in the low nibble and code 2p+1 in the high nibble
    (two's complement), the layout the int4_matmul kernel unpacks.
    """
    axis = axis % codes.dim()
    size = codes.shape[axis]
    if size % 2:
        raise ValueError(f"pack axis {axis} has odd size {size}")
    c32 = codes.to(torch.int32)
    even = [slice(None)] * codes.dim()
    odd = [slice(None)] * codes.dim()
    even[axis], odd[axis] = slice(0, None, 2), slice(1, None, 2)
    b = (c32[tuple(even)] & 15) | ((c32[tuple(odd)] & 15) << 4)
    return torch.where(b > 127, b - 256, b).to(torch.int8)


def unpack_int4(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of pack_int4: (..., S/2, ...) int8 bytes -> (..., S, ...) codes."""
    axis = axis % packed.dim()
    p32 = packed.to(torch.int32)
    lo = ((p32 << 28) >> 28).to(torch.int8)
    hi = ((p32 << 24) >> 28).to(torch.int8)
    st = torch.stack([lo, hi], dim=axis + 1)
    shape = list(packed.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def init_scale(w: torch.Tensor, spec: QuantSpec,
               group_axes: tuple[int, ...] = ()) -> torch.Tensor:
    """LSQ init: s = 2*mean(|w|)/sqrt(Q_P), per scale group.

    group_axes: axes of w that index groups (e.g. the head axis). The result
    keeps those axes and has size-1 elsewhere; with no group axes it is 0-d.
    """
    denom = torch.sqrt(torch.tensor(float(spec.q_p), dtype=torch.float32,
                                    device=w.device))
    dims = tuple(i for i in range(w.dim()) if i not in group_axes)
    n = 1
    for i in dims:
        n *= w.shape[i]
    # sum / n, the order jnp.mean takes (not a multiply by 1/n)
    m = torch.sum(torch.abs(w.to(torch.float32)), dim=dims,
                  keepdim=bool(group_axes)) / n
    return torch.clamp(2.0 * m / denom, min=EPS_SCALE)
