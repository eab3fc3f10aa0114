"""End-to-end driver: QAT-train a ~100M-parameter LM for a few hundred steps
(twin of `examples/train_qat_lm.py`).

    PYTHONPATH=src python -m repro_torch.examples.train_qat_lm \
        --steps 300 --bits 4 --ckpt build/qat_ckpt [--device cpu]

Exercises the full production path on one card: paper-faithful W4A4
module-dependent QAT with MCKD soft labels and OBR, AdamW with warmup-cosine,
gradient accumulation, periodic async checkpoints with restart-on-relaunch,
preemption handling, straggler watch, and a loss-curve comparison against the
LSQ+ baseline (Fig. 6 reproduction) when --compare is passed.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, BlockDef
from repro_torch.core.policy import QuantConfig
from repro_torch.data.mckd_store import synthetic_kd_labels
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.fault_tolerance import CheckpointManager
from repro_torch.train.state import TrainConfig, init_state
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import leaves

# ~100M-class LM: 12L x d512 GLU-FFN backbone + 2 x 32k x 512 embeddings
# = 83M trainable parameters (+ quantizer scales)
LM_100M = ArchConfig(
    name="qat-lm-100m", family="dense", n_layers=12, d_model=512,
    n_heads=8, n_kv_heads=8, d_ff=2048, vocab_size=32_000,
    pattern=(BlockDef(attn="global", ffn="dense"),),
    norm="rmsnorm", act="silu", ffn_gated=True, pos="rope",
)
DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "qat_ckpt"


def train(args, mode: str, device):
    cfg = LM_100M
    qcfg = QuantConfig(w_bits=args.bits, a_bits=args.bits, mode=mode,
                       obr_lambda=0.05 if (args.bits <= 3 and mode == "mdq") else 0.0,
                       track_oscillation=args.bits <= 4)
    tcfg = TrainConfig(total_steps=args.steps, warmup_steps=max(args.steps // 20, 5),
                       grad_accum=args.grad_accum, kd="mckd", kd_topk=16,
                       adamw=AdamWConfig(lr_peak=3e-3))
    dcfg = DataConfig(p_noise=0.1)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    mgr = CheckpointManager(f"{args.ckpt}-{mode}", save_every=args.save_every)
    state, start = mgr.restore_or_init(lambda: init_state(cfg, qcfg, tcfg, gen, device))
    if start:
        print(f"[{mode}] restored checkpoint at step {start}")
    step = make_train_step(cfg, qcfg, tcfg)

    n_params = sum(x.numel() for x in leaves(state["params"]))
    print(f"[{mode}] params={n_params / 1e6:.1f}M  W{args.bits}A{args.bits}")
    losses = []
    t0 = time.monotonic()
    for i in range(start, args.steps):
        batch = sample_batch(cfg, dcfg, i, args.batch, args.seq)
        idx, p = synthetic_kd_labels(batch["labels"], cfg.vocab_size, 16, seed=i)
        batch.update(kd_idx=idx, kd_p=p)
        state, m = step(state, {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                                for k, v in batch.items()})
        losses.append(float(m["loss"]))
        straggler = mgr.straggler.tick()
        if i % args.log_every == 0:
            dt = (time.monotonic() - t0) / max(i - start + 1, 1)
            print(f"[{mode}] step {i:4d} loss={losses[-1]:.4f} "
                  f"lr={float(m['lr']):.2e} osc%={100 * float(m.get('osc_frac', 0)):.2f} "
                  f"({dt:.2f}s/step){' STRAGGLER' if straggler else ''}")
        mgr.maybe_save(state, i)
        if mgr.should_stop():
            print(f"[{mode}] preemption requested — checkpointing and exiting")
            mgr.maybe_save(state, i, force=True)
            break
    mgr.finalize()
    mgr.guard.restore_handlers()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--grad-accum", type=int, default=1, dest="grad_accum")
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--save-every", type=int, default=50, dest="save_every")
    ap.add_argument("--log-every", type=int, default=10, dest="log_every")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare", action="store_true",
                    help="also train the LSQ+ baseline and print both curves")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ours = train(args, "mdq", device)
    if args.compare:
        base = train(args, "lsq", device)
        print("\nstep, ours(MDQ), baseline(LSQ+)   # Fig. 6 reproduction")
        for i in range(0, len(ours), max(len(ours) // 20, 1)):
            print(f"{i:5d}, {ours[i]:.4f}, {base[i]:.4f}")
        print(f"final: ours={np.mean(ours[-5:]):.4f} "
              f"baseline={np.mean(base[-5:]):.4f}")
    return ours


if __name__ == "__main__":
    main()
