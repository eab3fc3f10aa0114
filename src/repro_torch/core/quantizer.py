"""Uniform quantizers with learnable scale (LSQ) and offset (LSQ+).

PyTorch counterpart of `repro.core.quantizer` (Eq. 5-7 of "Quantization
Variation"):

  x_q = s * round(clip(x/s, -Q_N, Q_P))                         (Eq. 5)
  dL/dx   = dL/dx_q * 1[-Q_N <= x/s <= Q_P]                     (Eq. 6, STE)
  dx_q/ds = round(x/s) - x/s   inside the range                 (Eq. 7)
          = -Q_N / Q_P         below / above the range

As in the JAX package the gradients fall out of autograd through
`round_ste` and the clip, with no custom Function. The clip is written as
`minimum(maximum(x, lo), hi)` because torch's max/min, like JAX's, split
the gradient evenly at a tie (torch.clamp would pass all of it), and
`grad_scale` keeps the JAX expression `x*g + (x - x*g)` so the forward
value rounds the same way. Besides: the integer codes for serving, nibble
packing, and the LSQ scale / LSQ+ offset inits.

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


def scale_spans(scale_shape: tuple, w_shape: tuple, tp) -> bool:
    """The groups of a scale of `w`'s slice span the model ranks of `tp`:
    a 0-d scale (per-tensor, or an activation scale keyed on the weight),
    or one replicated while its weight splits across its groups (a
    per-expert (E, 1, 1) scale of an expert split on d_ff). A scale with
    an axis along the cut (`sharding._scale_pspec`: a per-head scale with
    its heads, a per-expert one with its experts) splits with its weight,
    so each of its groups is whole on its rank."""
    if tp is None:
        return False
    return not scale_shape or (tp.dim is not None
                               and scale_shape[tp.dim] != w_shape[tp.dim])


def scale_grad_factor(spec: QuantSpec, w: torch.Tensor,
                      scale_shape: tuple[int, ...], tp=None) -> torch.Tensor:
    """Gradient scale g for the learnable scale factor, shaped like the scale.

    module_l1 (paper, Sec 4.4.1): g = 1 / sqrt(Q_P * ||w||_1) per scale
    group; lsq: g = 1 / sqrt(N * Q_P); none: g = 1.

    tp: `w` is this rank's slice of a weight split over `tp.parts` model
    ranks along `tp.dim` (`dist.spmd.TPSplit`). Where the scale's groups
    span the ranks (`scale_spans`), g is the whole weight's, from the
    slices' l1 all-reduced over the model ranks, or from the whole element
    count; otherwise each group is whole on its rank.
    """
    if spec.grad_scale_mode == "none":
        return torch.ones(scale_shape, dtype=torch.float32, device=w.device)
    dims = _group_reduce_dims(scale_shape, tuple(w.shape))
    spans = scale_spans(scale_shape, tuple(w.shape), tp)
    if spec.grad_scale_mode == "lsq":
        n = float(tp.parts) if spans else 1.0
        for a in dims:
            n *= w.shape[a]
        val = 1.0 / torch.sqrt(torch.tensor(n * spec.q_p, dtype=torch.float32))
        return torch.full(scale_shape, float(val), dtype=torch.float32,
                          device=w.device)
    l1 = torch.sum(torch.abs(w.to(torch.float32)), dim=dims,
                   keepdim=bool(len(scale_shape)))
    if spans:
        from repro_torch.dist.spmd import all_reduce
        with torch.no_grad():
            l1 = all_reduce(l1, tp.group)
    return 1.0 / torch.sqrt(spec.q_p * torch.clamp(l1, min=EPS_SCALE))


def round_ste(x: torch.Tensor) -> torch.Tensor:
    """round(x) in the forward pass, identity gradient in the backward pass."""
    return x + (torch.round(x) - x).detach()


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """Binary (+-1) forward, clipped-identity backward (|x|<=1 window)."""
    s = torch.where(x >= 0, 1.0, -1.0).to(x.dtype)
    passthrough = _clip(x, -1.0, 1.0)
    return passthrough + (s - passthrough).detach()


def grad_scale(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Identity forward (x*g + (x - x*g), rounded as written); multiplies
    the incoming gradient by ``g``."""
    g = g.detach()
    xg = x * g
    return xg + (x - xg).detach()


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """jnp.clip: maximum then minimum, a tie splitting the gradient."""
    lo_t = torch.tensor(lo, dtype=x.dtype, device=x.device)
    hi_t = torch.tensor(hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def fake_quant(x: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
               offset: Optional[torch.Tensor] = None,
               grad_scale_ref: Optional[torch.Tensor] = None,
               tp=None) -> torch.Tensor:
    """Quantize-dequantize ``x`` with learnable ``scale`` (and LSQ+
    ``offset``), with the STE gradients of Eq. 6-7 for x, scale and offset.

    Same operation order and dtypes as `repro.core.quantizer.fake_quant`:
    the scale passes through grad_scale (the module-wise g factor from
    ``grad_scale_ref``, default x itself), is floored at EPS_SCALE and cast
    to x's dtype before the division. tp: the reference is this rank's
    tensor-parallel slice (`scale_grad_factor`).
    """
    ref = (x if grad_scale_ref is None else grad_scale_ref).detach()
    sshape = tuple(scale.shape)
    if grad_scale_ref is None or len(sshape) == 0 or ref.dim() == len(sshape):
        g = scale_grad_factor(spec, ref, sshape, tp)
    else:
        # activation scale keyed on module weights of another rank
        g = scale_grad_factor(spec, ref, (), tp).expand(sshape)
    s = grad_scale(scale, g)
    s = torch.maximum(s, torch.tensor(EPS_SCALE, dtype=s.dtype,
                                      device=s.device)).to(x.dtype)
    if offset is not None:
        b = grad_scale(offset, g).to(x.dtype)
        xs = (x - b) / s
    else:
        xs = x / s
    if spec.bits == 1 and spec.signed:
        xq = sign_ste(xs) * s
    else:
        xs = _clip(xs, -float(spec.q_n), float(spec.q_p))
        xq = round_ste(xs) * s
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


def init_offset(w: torch.Tensor, spec: QuantSpec,
                group_axes: tuple[int, ...] = ()) -> torch.Tensor:
    """LSQ+ offset init: zeros, per scale group (0-d without groups)."""
    del spec
    if not group_axes:
        return torch.zeros((), dtype=torch.float32, device=w.device)
    shape = tuple(w.shape[i] if i in group_axes else 1 for i in range(w.dim()))
    return torch.zeros(shape, dtype=torch.float32, device=w.device)
