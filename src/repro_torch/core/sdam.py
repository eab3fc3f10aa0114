"""SDAM: Standard Deviation of the Absolute Mean (Tab. 2 / Tab. 6).

PyTorch counterpart of `repro.core.sdam`: for each channel c, the mean of
|x| over every other axis; SDAM is the (population) standard deviation of
those per-channel absolute means.
"""
from __future__ import annotations

import torch


def sdam(x: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """SDAM of one tensor along `channel_axis` (f32)."""
    x = torch.movedim(x, channel_axis, -1)
    abs_mean = torch.mean(torch.abs(x.to(torch.float32)),
                          dim=tuple(range(x.dim() - 1)))
    return torch.std(abs_mean, correction=0)


def mean_sdam(tensors, channel_axis: int = -1) -> torch.Tensor:
    """Average SDAM over a collection of module activations (Tab. 2)."""
    vals = [sdam(t, channel_axis) for t in tensors]
    return torch.mean(torch.stack(vals)) if vals else torch.tensor(0.0)
