"""Learning-rate schedules (paper Appendix B), as f32 0-d CPU tensors.

PyTorch counterpart of `repro.optim.schedule`, op by op in f32.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def warmup_cosine(step, *, peak: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 1e-5) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr (paper Tab. 11 recipe)."""
    step = _f32(step)
    warm = peak * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_lr + 0.5 * (peak - min_lr) * (1.0 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, cos)


def linear_warmup_decay(step, *, peak: float, warmup_steps: int,
                        total_steps: int) -> torch.Tensor:
    """BERT-style linear schedule (paper Tab. 10 recipe)."""
    step = _f32(step)
    warm = peak * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return torch.where(step < warmup_steps, warm, peak * (1.0 - frac))
