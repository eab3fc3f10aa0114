"""Quickstart: variation-aware QAT of a small transformer in ~1 minute
(twin of `examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Builds a reduced llama-style model, quantizes it to W4A4 with the paper's
module-dependent scheme, trains a few dozen steps on the synthetic stream
with oscillation telemetry, and prints the variation metrics the paper is
built around (SDAM, oscillation %, per-head scales).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.policy import QuantConfig
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import TrainConfig, init_state
from repro_torch.train.train_step import make_train_step


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(get_config("granite-8b")).replace(n_layers=2)
    qcfg = QuantConfig(w_bits=4, a_bits=4, mode="mdq", obr_lambda=0.01,
                       track_oscillation=True)
    tcfg = TrainConfig(total_steps=60, warmup_steps=4,
                       adamw=AdamWConfig(lr_peak=5e-3))
    dcfg = DataConfig(p_noise=0.05)
    gen = torch.Generator(device=device).manual_seed(0)

    state = init_state(cfg, qcfg, tcfg, gen, device)
    step = make_train_step(cfg, qcfg, tcfg)

    print(f"arch={cfg.name} quant=W{qcfg.w_bits}A{qcfg.a_bits} mode={qcfg.mode}")
    for i in range(50):
        state, m = step(state, to_device(sample_batch(cfg, dcfg, i, 16, 16), device))
        if i % 10 == 0:
            print(f"step {i:3d}  loss={float(m['loss']):.3f} "
                  f"obr={float(m['loss_obr']):.3f} "
                  f"osc%={100 * float(m.get('osc_frac', 0)):.2f} "
                  f"|g|={float(m['grad_norm']):.3f}")

    # variation telemetry
    batch = to_device(sample_batch(cfg, dcfg, 999, 4, 16), device)
    with torch.no_grad():
        _, aux = M.forward(state["params"], batch, cfg, qcfg)
    print(f"\nactivation SDAM (Tab. 2 metric): {float(aux['act_sdam']):.4e}")
    wq_scale = torch.stack([lay["wq"]["w_scale"].reshape(-1)
                            for lay in state["params"]["layers"]])
    print(f"per-head wq scales (MDQ, layers x heads): {wq_scale.tolist()}")
    print("done.")


if __name__ == "__main__":
    main()
