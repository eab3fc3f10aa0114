"""AdamW with decoupled weight decay, over the port's param trees.

PyTorch counterpart of `repro.optim.adamw`, with the same f32 update math
in the same order. Weight decay applies only to matrix-like weights (a
path through "w" or "pos_embed"); norms, biases and the learnable
quantizer scales/offsets are exempt, and the scales are floored at
SCALE_FLOOR after every update. The update runs IN PLACE on the params and
moments (the JAX version returns new trees).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 5e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    clip_norm: float = 1.0
    # "bfloat16" halves moment memory; the update math still runs in f32
    moments_dtype: str = "float32"


class AdamWState(NamedTuple):
    mu: Any
    nu: Any


def init(params, cfg: "AdamWConfig | None" = None) -> AdamWState:
    mdt = (torch.bfloat16 if (cfg and cfg.moments_dtype == "bfloat16")
           else torch.float32)
    zeros = lambda p: torch.zeros_like(p, dtype=mdt)
    return AdamWState(mu=T.map_tree(zeros, params), nu=T.map_tree(zeros, params))


def _decay_mask(params) -> list:
    """1.0 for leaves on a path through "w" or "pos_embed", else 0.0."""
    return [1.0 if any(k in ("w", "pos_embed") for k in path) else 0.0
            for path, _ in T.flatten(params)]


SCALE_FLOOR = 1e-6


@torch.no_grad()
def _project_scales(params) -> None:
    """Quantizer scales stay positive: floor every w_scale / a_scale leaf at
    SCALE_FLOOR (an Adam step can cross zero, after which max(s, eps)
    silently zeroes the quantizer and its gradient)."""
    for path, leaf in T.flatten(params):
        if path and path[-1] in ("w_scale", "a_scale"):
            leaf.clamp_(min=SCALE_FLOOR)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the f32 sum of every leaf's f32 sum of squares (leaves in
    walk order; the JAX package sums its stacked leaves in its own order)."""
    sq = None
    for g in T.leaves(grads):
        part = torch.sum(torch.square(g.to(torch.float32)))
        sq = part if sq is None else sq + part
    return torch.sqrt(sq)


@torch.no_grad()
def update_(grads, state: AdamWState, params, step, lr, cfg: AdamWConfig) -> dict:
    """One AdamW step, in place on `params`, `state.mu`, `state.nu`.
    step: the 0-based step count; lr: the learning rate (0-d f32).
    Returns {"grad_norm"}."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32), t)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32), t)
    for g, m, v, p, dm in zip(T.leaves(grads), T.leaves(state.mu),
                              T.leaves(state.nu), T.leaves(params),
                              _decay_mask(params)):
        g = g.to(torch.float32) * scale
        m32 = cfg.b1 * m.to(torch.float32) + (1.0 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1.0 - cfg.b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        step_val = (mh / (torch.sqrt(vh) + cfg.eps)
                    + cfg.weight_decay * dm * p.to(torch.float32))
        p.copy_(p.to(torch.float32) - lr * step_val)
        m.copy_(m32)
        v.copy_(v32)
    _project_scales(params)
    return {"grad_norm": gnorm}
