"""Oscillation-aware Bin Regularization (OBR), Eq. 10 of the paper.

PyTorch counterpart of `repro.core.obr`:

  L_OBR = sum_m ( ||w_m^r - w_m^q||_2 + sum_n Var(w_{n,m}^r) )

where n ranges over the quantization bins of module m and the variance term
counts only bins holding more than two elements. The quantized value w^q,
the scale and the bin memberships are constants (`.detach()` where the
reference writes stop_gradient): the regularizer pulls latent weights
toward their bin center and bin mean, and must not be short-circuited by
the STE. Bins are per scale group (a per-head or per-expert scale makes a
bin a (group, level) pair); their statistics are masked reductions over the
<= 2^b levels, as in the reference (no kernel).

Eq. 10 is taken in two stages, so that a leaf held as slices on several
ranks needs only its sums moved: `obr_stats` gives a slice's sums (the
sum of squares of w - w_q, and each bin's count, sum and sum of squares,
placed at the slice's groups in the leaf's whole group tensor), the ranks
add them up, and `obr_finish` computes the value from the leaf's sums;
`obr_grad` gives the slice's gradient from them. `obr_loss` is the two
stages on one whole leaf.

`kure_loss` is the KURE baseline of Tab. 7.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.quantizer import EPS_SCALE, QuantSpec, quantize_int


# A leaf takes all its levels in one set of reductions over a (levels,
# *w.shape) mask up to this many bytes of mask; above it, a loop over levels.
VEC_BYTES = 1 << 30


def _level_moments(wf, codes, lvl, dims: tuple, keep: bool):
    m = (codes == lvl).to(torch.float32)
    return (torch.sum(m, dim=dims, keepdim=keep),
            torch.sum(m * wf, dim=dims, keepdim=keep),
            torch.sum(m * wf * wf, dim=dims, keepdim=keep))


class _Moments(torch.autograd.Function):
    """(count, sum, sum of squares) per (level, group), differentiable in
    w. The backward is the masked reductions' own derivative, written out:
    an element of level l in group g receives g_s1[l, g] + 2 w g_s2[l, g],
    gathered by its code. Autograd through the masked products would keep a
    weight-sized mask and product per level (the 8-bit embedding's 256
    levels: ~100 GB at full width); this keeps w and its codes."""

    @staticmethod
    def forward(ctx, wf, codes, q_n: int, q_p: int, dims: tuple, keep: bool):
        ctx.save_for_backward(wf, codes)
        ctx.q_n, ctx.keep = q_n, keep
        n_levels = q_n + q_p + 1
        if 4 * wf.numel() * n_levels <= VEC_BYTES:
            # a small leaf: all levels in one set of reductions (a few
            # kernels, not a few per level: the 24 routers' 256 levels)
            lv = torch.arange(-q_n, q_p + 1, device=wf.device,
                              dtype=codes.dtype).reshape((-1,) + (1,) * wf.dim())
            return _level_moments(wf, codes, lv, tuple(d + 1 for d in dims), keep)
        parts = [_level_moments(wf, codes, lvl, dims, keep)
                 for lvl in range(-q_n, q_p + 1)]
        return tuple(torch.stack(t) for t in zip(*parts))

    @staticmethod
    def backward(ctx, g_count, g_s1, g_s2):
        del g_count  # the counts are constants
        wf, codes = ctx.saved_tensors
        return (_moments_grad(wf, codes, g_s1, g_s2, ctx.q_n, ctx.keep),
                None, None, None, None, None)


def _moments_grad(wf, codes, g_s1, g_s2, q_n: int, keep: bool) -> torch.Tensor:
    """The gradient in w of sum(g_s1 * s1 + g_s2 * s2) over the bins: an
    element of level l in group g receives g_s1[l, g] + 2 w g_s2[l, g]."""
    idx = (codes.to(torch.int64) + q_n)[None]
    shape = (g_s1.shape[0],) + tuple(wf.shape)
    if not keep:  # per tensor: (n_bins,)
        g_s1 = g_s1.reshape((-1,) + (1,) * wf.dim())
        g_s2 = g_s2.reshape((-1,) + (1,) * wf.dim())
    t1 = torch.gather(g_s1.expand(shape), 0, idx)[0]
    t2 = torch.gather(g_s2.expand(shape), 0, idx)[0]
    return t1 + 2 * wf * t2


def _moment_dims(scale_shape: tuple, ndim: int) -> tuple:
    """(reduced axes, keepdim) of the bins' reductions: the axes on which
    the scale broadcasts (its size-1 axes; all axes for a 0-d scale)."""
    if len(scale_shape) == 0:
        return tuple(range(ndim)), False
    return tuple(i for i, s in enumerate(scale_shape) if s == 1), True


def per_bin_moments(w: torch.Tensor, codes: torch.Tensor, scale_shape,
                    spec: QuantSpec):
    """Per-(group, level) count / sum / sum of squares by masked
    reductions over the axes on which the scale broadcasts (its size-1
    axes; all axes for a 0-d scale). Three tensors (n_bins, *group_shape),
    differentiable in w (`_Moments`)."""
    dims, keep = _moment_dims(tuple(scale_shape), w.dim())
    return _Moments.apply(w.to(torch.float32), codes, spec.q_n, spec.q_p,
                          dims, keep)


class ObrStats(NamedTuple):
    """A leaf's (or a slice's) Eq. 10 sums: sq the 0-d sum of (w - w_q)^2;
    count / s1 / s2 each bin's count, sum and sum of squares, (n_bins,
    *group_shape) as `per_bin_moments` gives them. All f32; a leaf's are
    the sums of its slices'."""
    sq: torch.Tensor
    count: torch.Tensor
    s1: torch.Tensor
    s2: torch.Tensor


class Place(NamedTuple):
    """Where a slice's scale groups sit in the whole leaf's: the whole
    scale's shape and the slice's offset along each of its axes."""
    shape: tuple
    offsets: tuple

    def index(self, local_shape) -> tuple:
        return (slice(None),) + tuple(slice(o, o + n) for o, n
                                      in zip(self.offsets, local_shape))


def _quantized(w, scale, spec):
    """(clamped scale, codes, w_q): the constants of Eq. 10."""
    scale = torch.clamp(scale, min=EPS_SCALE).detach()
    codes = quantize_int(w, scale, spec).detach()
    return scale, codes, (codes.to(w.dtype) * scale.to(w.dtype)).detach()


def obr_stats(w: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
              place: Optional[Place] = None) -> ObrStats:
    """The sums of w (a whole leaf, or a slice of one with its scale's
    slice), differentiable in w. place: the bins' tensors are the whole
    leaf's group tensor, this slice's groups at `place`'s offsets and
    zeros elsewhere (None: the slice's own groups)."""
    scale, codes, w_q = _quantized(w, scale, spec)
    sq = torch.sum((w.to(torch.float32) - w_q.to(torch.float32)) ** 2)
    count, s1, s2 = per_bin_moments(w, codes, tuple(scale.shape), spec)
    if place is not None:
        def put(t):
            out = t.new_zeros(t.shape[:1] + tuple(place.shape))
            out[place.index(t.shape[1:])] = t
            return out
        count, s1, s2 = put(count), put(s1), put(s2)
    return ObrStats(sq, count, s1, s2)


def obr_finish(stats: ObrStats) -> torch.Tensor:
    """Eq. 10 from a whole leaf's sums: the l2 term plus the variances of
    the bins holding more than two elements. A 0-d f32."""
    l2 = torch.sqrt(stats.sq + 1e-12)
    cnt = torch.clamp(stats.count, min=1.0)
    mean = stats.s1 / cnt
    var = torch.clamp(stats.s2 / cnt - mean * mean, min=0.0)
    var = torch.where(stats.count > 2.0, var, torch.zeros_like(var))
    return l2 + torch.sum(var)


def obr_loss(w: torch.Tensor, scale: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Eq. 10 for one module (scale broadcastable against w): a 0-d f32."""
    return obr_finish(obr_stats(w, scale, spec))


def obr_grad(w: torch.Tensor, scale: torch.Tensor, spec: QuantSpec,
             stats: ObrStats, place: Optional[Place] = None):
    """(Eq. 10's value, its gradient in w) from the whole leaf's sums
    `stats`, w being the leaf or a slice of it (its groups at `place`, as
    in `obr_stats`). The gradient is autograd's through `obr_loss`,
    written out: the finish's gradients in sq, s1 and s2, then the l2
    term's g_sq * 2 (w - w_q) and the bins' `_moments_grad` on this
    slice's groups, so that a whole leaf gets obr_loss's gradient bit for
    bit."""
    sq, s1, s2 = (t.detach().requires_grad_(True) for t in stats[:1] + stats[2:])
    with torch.enable_grad():
        v = obr_finish(ObrStats(sq, stats.count, s1, s2))
        g_sq, g_s1, g_s2 = torch.autograd.grad(v, (sq, s1, s2))
    scale, codes, w_q = _quantized(w, scale, spec)
    _, keep = _moment_dims(tuple(scale.shape), w.dim())
    if place is not None:
        ix = place.index(tuple(scale.shape))
        g_s1, g_s2 = g_s1[ix], g_s2[ix]
    wf = w.detach().to(torch.float32)
    g_l2 = g_sq * (2.0 * (wf - w_q.to(torch.float32)))
    g_bins = _moments_grad(wf, codes, g_s1, g_s2, spec.q_n, keep)
    return v.detach(), g_l2.to(w.dtype) + g_bins.to(w.dtype)


def obr_lambda_schedule(step, total_steps: int, lam_max: float) -> torch.Tensor:
    """Cosine ramp 0 -> lam_max over total_steps (Sec. 4.4.3): a 0-d f32
    on the CPU (the step is a CPU tensor or an int)."""
    if lam_max <= 0.0 or total_steps <= 0:
        return torch.zeros((), dtype=torch.float32)
    frac = torch.clamp(torch.as_tensor(step).to(torch.float32) / float(total_steps),
                       0.0, 1.0)
    return lam_max * 0.5 * (1.0 - torch.cos(math.pi * frac))


def total_obr_loss(quant_leaves, lam) -> torch.Tensor:
    """lam * sum of Eq. 10 over (w, scale, spec) triples (the model's
    `quant_leaves`)."""
    total = None
    for w, scale, spec in quant_leaves:
        v = obr_loss(w, scale, spec)
        total = v if total is None else total + v
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return lam * total


def kure_loss(w: torch.Tensor, target_kurtosis: float = 1.8) -> torch.Tensor:
    """KURE (Chmiel et al., 2020), the Tab. 7 baseline: the squared
    deviation of the weight tensor's global kurtosis from the uniform
    distribution's 1.8 (OBR, by contrast, acts per bin)."""
    wf = w.to(torch.float32).reshape(-1)
    mu = torch.mean(wf)
    var = torch.clamp(torch.var(wf, unbiased=False), min=1e-12)
    kurt = torch.mean((wf - mu) ** 4) / (var * var)
    return (kurt - target_kurtosis) ** 2
