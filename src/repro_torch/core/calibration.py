"""Activation-scale calibration (LSQ+ init) from a sample batch.

PyTorch counterpart of `repro.core.calibration`. Weights get the
closed-form LSQ init (`quantizer.init_scale`); activation scales and
offsets cannot be derived from parameters, so they are taken from one
activation sample. Without one, the defaults (scale 1, offset 0) stand and
LSQ+ learns them.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import EPS_SCALE, QuantSpec


def calibrate_act_scale(sample: torch.Tensor, spec: QuantSpec):
    """(scale, offset), 0-d f32, from one activation sample.

    Symmetric: s = 2 mean|x| / sqrt(Q_P), offset 0. Asymmetric (LSQ+):
    offset = min(x), s = (max - min) / (Q_P + Q_N). Both floored at EPS.
    """
    x = sample.to(torch.float32)
    eps = torch.tensor(EPS_SCALE, dtype=torch.float32, device=x.device)
    if spec.offset:
        lo, hi = torch.min(x), torch.max(x)
        return torch.maximum((hi - lo) / float(spec.q_p + spec.q_n), eps), lo
    root = torch.sqrt(torch.tensor(float(spec.q_p), dtype=torch.float32))
    s = torch.maximum(2.0 * torch.mean(torch.abs(x)) / root.to(x.device), eps)
    return s, torch.zeros((), dtype=torch.float32, device=x.device)
