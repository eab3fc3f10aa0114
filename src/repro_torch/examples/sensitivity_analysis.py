"""Tab. 1-style sensitivity analysis on any assigned architecture (twin of
`examples/sensitivity_analysis.py`).

    PYTHONPATH=src python -m repro_torch.examples.sensitivity_analysis \
        --arch mixtral-8x7b [--device cpu]

Runs the leave-one-out QAT harness at the requested bitwidth on the reduced
config and prints the per-module-group sensitivity ordering.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.core.policy import QuantConfig
from repro_torch.core.sensitivity import leave_one_out_configs
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.tables.common import train_eval
from repro_torch.train.state import TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--bits", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(get_config(args.arch))
    base = QuantConfig(w_bits=args.bits, a_bits=args.bits, mode="mdq")
    tcfg = TrainConfig(total_steps=args.steps + 10, warmup_steps=4,
                       adamw=AdamWConfig(lr_peak=5e-3))
    print(f"arch={cfg.name} W{args.bits}A{args.bits} — leave-one-out QAT")
    rows = []
    for name, qcfg in leave_one_out_configs(base):
        out, _ = train_eval(cfg, qcfg, tcfg, steps=args.steps, device=device)
        rows.append((name, out["eval_ce"], out["eval_acc"]))
        print(f"  {name:28s} eval_ce={out['eval_ce']:.3f} acc={out['eval_acc']:.3f}")
    rows.sort(key=lambda r: r[1])
    print("\nmost sensitive kept-FP group (lowest CE when exempted):",
          rows[0][0])
    return rows


if __name__ == "__main__":
    main()
