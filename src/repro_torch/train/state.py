"""Train state: params + AdamW moments + step + sentinel telemetry.

PyTorch counterpart of `repro.train.state`. A plain dict:
  {"params": ..., "mu": ..., "nu": ..., "step": int32 0-d CPU tensor,
   "osc": (), "err": (), "sent": SentinelState | ()}
"osc" holds one `OscState` per quantized weight (in `quant_leaf_paths`
order) when `qcfg.track_oscillation` is set, else (). "err" (gradient-
compression error feedback) stays empty: compression raises
NotImplementedError in this port (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.oscillation import init_osc_state
from repro_torch.core.policy import QuantConfig
from repro_torch.models.model import init_params, quant_leaves
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.sentinel import SentinelConfig, init_sentinel_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    total_steps: int = 1000
    warmup_steps: int = 50
    grad_accum: int = 1
    kd: str = "none"          # none | teacher | mckd
    kd_topk: int = 16
    kd_temperature: float = 1.0
    lb_coef: float = 0.01     # MoE load-balance coefficient
    compress_grads: bool = False
    lr_schedule: str = "cosine"
    adamw: AdamWConfig = AdamWConfig()
    # run sentinel (train/sentinel.py); None disables the in-step checks
    sentinel: Optional[SentinelConfig] = None

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def check_supported(tcfg: TrainConfig) -> None:
    """Raise for the training settings this port does not run yet (every
    quantizer setting trains, OBR and oscillation tracking included)."""
    if tcfg.compress_grads:
        raise NotImplementedError(
            "gradient compression (optim/grad_compress.py) is not ported "
            "yet: ROADMAP.md Queue 1, 'Distribution'")


def init_state(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig,
               generator: torch.Generator, device=None) -> dict:
    check_supported(tcfg)
    params = init_params(cfg, qcfg, generator, device)
    opt = adamw.init(params, tcfg.adamw)
    dev = next(iter(params["embed"].values())).device
    osc = ()
    if qcfg.track_oscillation:
        osc = tuple(init_osc_state(w, s, spec)
                    for w, s, spec in quant_leaves(params, qcfg))
    return {"params": params, "mu": opt.mu, "nu": opt.nu,
            "step": torch.zeros((), dtype=torch.int32),
            "osc": osc, "err": (),
            "sent": (init_sentinel_state(dev) if tcfg.sentinel is not None
                     else ())}
