"""Shared driver of the paper-table twins (`benchmarks/common.py`'s).

Each table trains a reduced model on the synthetic learnable stream and
reports the final eval CE / accuracy. The numbers are not ImageNet / GLUE:
what the tables reproduce at this scale are the paper's orderings (ours >=
baseline + KD >= baseline; OBR lowers oscillation; MDQ lowers SDAM; MCKD is
cheaper a step than vanilla KD).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.policy import QuantConfig
from repro_torch.data.mckd_store import synthetic_kd_labels
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import TrainConfig, init_state
from repro_torch.train.train_step import make_eval_step, make_train_step

DCFG = DataConfig(p_noise=0.05)
BATCH, SEQ = 16, 16


def bench_model(arch: str = "qwen1.5-0.5b", n_layers: int = 2):
    return reduced_config(get_config(arch)).replace(n_layers=n_layers)


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_eval(cfg, qcfg: QuantConfig, tcfg: TrainConfig, *, steps: int = 60,
               seed: int = 0, teacher_forward=None, step_fn=None, dcfg=None,
               device=None):
    """Train `steps` from a fresh state (a torch generator seeded with
    `seed` on `device`); return (dict(final_loss, eval_ce, eval_acc,
    s_per_step[, osc_pct]), state). s_per_step is the wall time a step
    from the third step on (device synchronized)."""
    device = resolve_device(device)
    dcfg = dcfg or DCFG
    gen = torch.Generator(device=device).manual_seed(seed)
    state = init_state(cfg, qcfg, tcfg, gen, device)
    if step_fn is None:
        step_fn = make_train_step(cfg, qcfg, tcfg,
                                  teacher_forward=teacher_forward)
    losses = []
    t0 = None
    m: dict = {}
    for i in range(steps):
        batch = sample_batch(cfg, dcfg, i, BATCH, SEQ)
        if tcfg.kd == "mckd":
            idx, p = synthetic_kd_labels(batch["labels"], cfg.vocab_size,
                                         tcfg.kd_topk, seed=i)
            batch = {**batch, "kd_idx": idx, "kd_p": p}
        state, m = step_fn(state, to_device(batch, device))
        if i == 1:
            _sync(device)
            t0 = time.monotonic()
        losses.append(float(m["loss"]))
    _sync(device)
    per_step = ((time.monotonic() - t0) / max(1, steps - 2)
                if t0 is not None else float("nan"))
    ev = make_eval_step(cfg, qcfg)
    evs = [ev(state["params"], to_device(
        sample_batch(cfg, dcfg, 10_000 + j, BATCH, SEQ), device))
        for j in range(4)]
    out = {
        "final_loss": losses[-1],
        "eval_ce": float(np.mean([float(e["ce"]) for e in evs])),
        "eval_acc": float(np.mean([float(e["acc"]) for e in evs])),
        "s_per_step": per_step,
    }
    if "osc_frac" in m:
        out["osc_pct"] = 100.0 * float(m["osc_frac"])
    return out, state


def default_tcfg(**kw) -> TrainConfig:
    base = dict(total_steps=80, warmup_steps=4,
                adamw=AdamWConfig(lr_peak=5e-3))
    base.update(kw)
    return TrainConfig(**base)


def cli_args(argv, default_steps: int) -> argparse.Namespace:
    """--device (cuda unless cpu is asked for) and --steps."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--steps", type=int, default=default_steps)
    return ap.parse_args(argv)
