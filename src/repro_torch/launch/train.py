"""Training launcher: the QAT loop on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --quant w4a4 --steps 3 --batch 8 --seq 512 --ckpt build/ckpt-run1

PyTorch counterpart of `repro.launch.train`, same flags without
--model-parallel, --compress-grads and --tpu-flags (sharding and gradient
compression are not ported; TPU flags have no counterpart), plus --device
(cuda unless "cpu" is asked for; no silent fallback) and --layers (cut the
depth, 0 = the config's). Params are random (a torch generator seeded with
--seed), data comes from `sample_batch` with synthetic MCKD labels. The
loop restores the newest verified checkpoint, steps, checks the sentinel's
health bits (rolling back to the newest verified checkpoint with an LR
backoff after `k_consecutive` fatal steps), saves asynchronously every
--save-every steps, and exits cleanly on SIGTERM/SIGINT.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.core.policy import get_preset
from repro_torch.data.mckd_store import synthetic_kd_labels
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault_tolerance import CheckpointManager
from repro_torch.train.sentinel import SentinelConfig, SentinelRunner, describe
from repro_torch.train.state import TrainConfig, init_state
from repro_torch.train.train_step import make_train_step


@dataclasses.dataclass
class RunReport:
    """What a `run_training` call did (tests and chip_smoke.py read it)."""

    final_step: int           # last loop index that completed
    final_loss: float
    steps_run: int            # step_fn invocations (includes replayed steps)
    rollbacks: int            # sentinel rollback-recoveries performed
    skipped: int              # updates skipped as fatal (sentinel counter)
    lr_scale: float           # final sentinel LR backoff multiplier
    preempted: bool           # SIGTERM/SIGINT clean exit taken
    straggler_flags: int
    start_step: int = 0       # the step the loop started from (restored + 1)
    losses: list = dataclasses.field(default_factory=list)   # per step run
    healths: list = dataclasses.field(default_factory=list)  # sentinel bits
    step_seconds: list = dataclasses.field(default_factory=list)
    peak_bytes: Optional[int] = None  # max device memory allocated (CUDA)


def _to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def run_training(cfg, qcfg, tcfg: TrainConfig, dcfg: DataConfig, *,
                 steps: int, batch_size: int = 16, seq_len: int = 64,
                 ckpt_dir: str, save_every: int = 100, log_every: int = 10,
                 extra_loss: Optional[Callable] = None,
                 on_step: Optional[Callable] = None,
                 mgr: Optional[CheckpointManager] = None,
                 seed: int = 0, device=None) -> RunReport:
    """The QAT loop: restore -> step -> health -> save, with sentinel
    rollback recovery (`tcfg.sentinel`; None runs the bare loop).

    extra_loss(params, step): an extra loss term (fault injection);
    on_step(i, state) -> state | None: a host hook before each step;
    mgr: a preconfigured CheckpointManager (tests use async_io=False); by
    default one over `ckpt_dir` stamped with an (arch, quant) fingerprint.
    """
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    if mgr is None:
        mgr = CheckpointManager(ckpt_dir, save_every=save_every,
                                expect_fingerprint=ckpt.fingerprint(cfg, qcfg))
    state, start = mgr.restore_or_init(
        lambda: init_state(cfg, qcfg, tcfg, gen, device))
    if start:
        print(f"restored from step {start}", flush=True)
    step_fn = make_train_step(cfg, qcfg, tcfg, extra_loss=extra_loss)
    runner = (SentinelRunner(tcfg.sentinel, mgr, state)
              if tcfg.sentinel is not None else None)

    report = RunReport(final_step=-1, final_loss=float("nan"), steps_run=0,
                       rollbacks=0, skipped=0, lr_scale=1.0, preempted=False,
                       straggler_flags=0)
    m: dict = {}
    # a checkpoint labelled s is taken AFTER loop index s completed, so a
    # restore or rollback to label s resumes at s + 1 (the data stream is
    # keyed on the step, so the replay is identical)
    i = start if start == 0 else start + 1
    report.start_step = i
    while i < steps:
        if on_step is not None:
            injected = on_step(i, state)
            if injected is not None:
                state = injected
        t0 = time.perf_counter()
        batch = sample_batch(cfg, dcfg, i, batch_size, seq_len)
        if tcfg.kd == "mckd":
            idx, p = synthetic_kd_labels(batch["labels"], cfg.vocab_size,
                                         tcfg.kd_topk, seed=i)
            batch.update(kd_idx=idx, kd_p=p)
        state, m = step_fn(state, _to_device(batch, device))
        loss = float(m["loss"])
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        report.step_seconds.append(time.perf_counter() - t0)
        report.losses.append(loss)
        report.steps_run += 1
        slow = mgr.straggler.tick()
        if runner is not None:
            health = int(m["health"])
            report.healths.append(health)
            if health:
                print(f"step {i:5d} health={describe(health)} "
                      f"(skipped={int(m['sentinel_skipped'])})", flush=True)
            if runner.observe(health):
                state, i = runner.rollback(state)
                print(f"sentinel: {runner.scfg.k_consecutive} consecutive "
                      f"fatal steps -> rolled back to step {i - 1}, "
                      f"lr_scale={float(state['sent'].lr_scale):.3g} "
                      f"(retry {runner.retries}/{runner.scfg.max_retries})",
                      flush=True)
                continue
        if log_every and i % log_every == 0:
            print(f"step {i:5d} loss={loss:.4f} lr={float(m['lr']):.2e} "
                  f"{report.step_seconds[-1]:.2f}s/step"
                  f"{' STRAGGLER' if slow else ''}", flush=True)
        mgr.maybe_save(state, i)
        if mgr.should_stop():
            print("preemption: final forced checkpoint + clean exit", flush=True)
            mgr.maybe_save(state, i, force=True)
            report.preempted = True
            break
        i += 1
    mgr.finalize()
    mgr.guard.restore_handlers()
    report.final_step = i if report.preempted else i - 1
    if m:
        report.final_loss = float(m["loss"])
        report.skipped = int(m.get("sentinel_skipped", 0))
        report.lr_scale = float(m.get("lr_scale", 1.0))
    report.rollbacks = runner.rollbacks if runner is not None else 0
    report.straggler_flags = mgr.straggler.flags
    if device.type == "cuda":
        report.peak_bytes = torch.cuda.max_memory_allocated(device)
    return report


def default_ckpt_dir(name: str) -> str:
    """`build/ckpt-<arch>` at the root of the checkout."""
    return str(Path(__file__).resolve().parents[3] / "build" / f"ckpt-{name}")


def main(argv=None) -> RunReport:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--quant", default="w4a4")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = all)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--grad-accum", type=int, default=1, dest="grad_accum")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--kd", default="mckd", choices=("none", "mckd"))
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--save-every", type=int, default=100, dest="save_every")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--no-sentinel", action="store_true", dest="no_sentinel",
                    help="disable in-step health checks + rollback recovery")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    qcfg = get_preset(args.quant)
    tcfg = TrainConfig(total_steps=args.steps,
                       warmup_steps=max(args.steps // 20, 2),
                       grad_accum=args.grad_accum, kd=args.kd, kd_topk=16,
                       adamw=AdamWConfig(lr_peak=args.lr),
                       sentinel=None if args.no_sentinel else SentinelConfig())
    dcfg = DataConfig(seed=args.seed)
    print(f"arch={cfg.name} layers={cfg.n_layers} quant={args.quant} "
          f"kd={args.kd} accum={args.grad_accum} device={device} "
          f"sentinel={'off' if args.no_sentinel else 'on'}", flush=True)
    report = run_training(
        cfg, qcfg, tcfg, dcfg, steps=args.steps, batch_size=args.batch,
        seq_len=args.seq, ckpt_dir=args.ckpt or default_ckpt_dir(cfg.name),
        save_every=args.save_every, seed=args.seed, device=device)
    print(f"done. final_step={report.final_step} "
          f"loss={report.final_loss:.4f} rollbacks={report.rollbacks} "
          f"skipped={report.skipped} preempted={report.preempted}", flush=True)
    return report


if __name__ == "__main__":
    main()
