"""Where a QAT training step's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--arch A] [--out FILE]

A training path of `chip_smoke.py` at full width, all layers, MCKD top-16
labels, sentinel on, batch 8 x 512: qwen1.5-0.5b under w4a4 (the default),
granite-moe-1b-a400m under w3a3 (OBR on) with oscillation tracking, or
musicgen-medium under w4a4 (learned positions, audio frames).
Builds the train state from a seed, runs one warm-up step, then profiles
`--steps` steps with torch.profiler: host wall ms per step, the device's
elapsed ms (CUDA events), the device time per kernel (the 20 costliest,
and every QAT kernel of the port: `named_kernels`), the device's busy
share of the window and the launches of each CUDA kernel of the port.
Then, profiler off, the device ms of the step's OBR term (value and
gradient over every quantized weight) and of the Eq. 12 oscillation
update, each alone between CUDA events (median of 3). Prints one JSON line
last; `--out` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.configs.registry import get_config
from repro_torch.core.obr import obr_lambda_schedule
from repro_torch.core.oscillation import update_osc_state
from repro_torch.core.policy import get_preset
from repro_torch.data.mckd_store import synthetic_kd_labels
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.kernels.ops import launch_counts, reset_launch_counts, resolve_device
from repro_torch.launch.profile_decode import device_summary, print_summary
from repro_torch.models.model import quant_leaves
from repro_torch.train.sentinel import SentinelConfig
from repro_torch.train.state import TrainConfig, init_state
from repro_torch.train.train_step import make_train_step, obr_

BATCH, SEQ = 8, 512
# arch -> (quant preset, track_oscillation): the training paths of chip_smoke.py
PATHS = {"qwen1.5-0.5b": ("w4a4", False),
         "granite-moe-1b-a400m": ("w3a3", True),
         "musicgen-medium": ("w4a4", False)}


def _device_ms(fn, reps: int = 3) -> float:
    """Median device ms of fn() between CUDA events."""
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_train")
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=sorted(PATHS))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    quant, track = PATHS[args.arch]
    cfg = get_config(args.arch)
    qcfg = get_preset(quant).replace(track_oscillation=track)
    tcfg = TrainConfig(total_steps=100, warmup_steps=5, kd="mckd",
                       sentinel=SentinelConfig())
    state = init_state(cfg, qcfg, tcfg,
                       torch.Generator(device=device).manual_seed(0), device)
    step_fn = make_train_step(cfg, qcfg, tcfg)

    def batch(i):
        b = sample_batch(cfg, DataConfig(), i, BATCH, SEQ)
        b["kd_idx"], b["kd_p"] = synthetic_kd_labels(b["labels"], cfg.vocab_size,
                                                     tcfg.kd_topk, seed=i)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in b.items()}

    state, m = step_fn(state, batch(0))  # warm-up
    torch.cuda.synchronize()
    reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    host_ms, losses = [], []
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for i in range(1, args.steps + 1):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch(i))
            losses.append(float(m["loss"]))  # the loop's own per-step sync
            host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    n = args.steps
    parts = {}
    params = state["params"]
    if qcfg.obr_lambda > 0.0:
        lam = obr_lambda_schedule(state["step"], tcfg.total_steps,
                                  qcfg.obr_lambda).to(device)
        grads = T.map_tree(torch.zeros_like, params)
        parts["obr_ms"] = _device_ms(lambda: obr_(params, grads, qcfg, lam))
        del grads
    if track:
        parts["osc_update_ms"] = _device_ms(lambda: tuple(
            update_osc_state(st, w, sc, spec, momentum=qcfg.osc_momentum)
            for st, (w, sc, spec) in zip(state["osc"], quant_leaves(params, qcfg))))
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "quant": quant,
        "track_oscillation": track, **parts,
        "batch": BATCH, "seq": SEQ, "steps": n,
        "device": torch.cuda.get_device_name(device),
        "step_host_ms": sorted(host_ms)[len(host_ms) // 2],
        "step_device_elapsed_ms": window_ms / n,
        **device_summary(prof, window_ms, n, top_n=20, named="qat_"),
        "launches_per_step": {k: v / n for k, v in launch_counts().items()},
        "tokens_per_s": BATCH * SEQ * 1e3 / (window_ms / n),
        "losses": losses,
    }
    print_summary(result)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return result


if __name__ == "__main__":
    main()
