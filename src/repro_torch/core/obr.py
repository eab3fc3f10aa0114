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

`kure_loss` is the KURE baseline of Tab. 7.
"""
from __future__ import annotations

import math

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
        idx = (codes.to(torch.int64) + ctx.q_n)[None]
        shape = (g_s1.shape[0],) + tuple(wf.shape)
        if not ctx.keep:  # per tensor: (n_bins,)
            g_s1 = g_s1.reshape((-1,) + (1,) * wf.dim())
            g_s2 = g_s2.reshape((-1,) + (1,) * wf.dim())
        t1 = torch.gather(g_s1.expand(shape), 0, idx)[0]
        t2 = torch.gather(g_s2.expand(shape), 0, idx)[0]
        return t1 + 2 * wf * t2, None, None, None, None, None


def per_bin_moments(w: torch.Tensor, codes: torch.Tensor, scale_shape,
                    spec: QuantSpec):
    """Per-(group, level) count / sum / sum of squares by masked
    reductions over the axes on which the scale broadcasts (its size-1
    axes; all axes for a 0-d scale). Three tensors (n_bins, *group_shape),
    differentiable in w (`_Moments`)."""
    if len(scale_shape) == 0:
        dims, keep = tuple(range(w.dim())), False
    else:
        dims, keep = tuple(i for i, s in enumerate(scale_shape) if s == 1), True
    return _Moments.apply(w.to(torch.float32), codes, spec.q_n, spec.q_p,
                          dims, keep)


def obr_loss(w: torch.Tensor, scale: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Eq. 10 for one module (scale broadcastable against w): a 0-d f32."""
    scale = torch.clamp(scale, min=EPS_SCALE).detach()
    codes = quantize_int(w, scale, spec).detach()
    w_q = (codes.to(w.dtype) * scale.to(w.dtype)).detach()
    l2 = torch.sqrt(torch.sum((w.to(torch.float32) - w_q.to(torch.float32)) ** 2)
                    + 1e-12)
    count, s1, s2 = per_bin_moments(w, codes, tuple(scale.shape), spec)
    cnt = torch.clamp(count, min=1.0)
    mean = s1 / cnt
    var = torch.clamp(s2 / cnt - mean * mean, min=0.0)
    var = torch.where(count > 2.0, var, torch.zeros_like(var))
    return l2 + torch.sum(var)


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
