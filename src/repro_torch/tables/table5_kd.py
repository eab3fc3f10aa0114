"""Tab. 5: KD schemes, cost and quality: no KD against vanilla KD (the
teacher in the loop) against multi-crop KD (precomputed sparse labels)
(twin of `benchmarks/table5_kd.py`).

The paper's finding: MCKD trains as well as vanilla KD at a fraction of the
time; here, seconds a step with and without the teacher's forward.

    python -m repro_torch.tables.table5_kd [--device cpu] [--steps N]
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import QuantConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.tables.common import (bench_model, cli_args, default_tcfg,
                                       train_eval)


def run(steps: int = 50, device=None):
    """{scheme: train_eval's dict} for the three KD schemes."""
    device = resolve_device(device)
    cfg = bench_model("qwen1.5-0.5b")
    qcfg = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    fp = QuantConfig(mode="off")
    # the paper's teacher is much larger than its student: 6x deeper and
    # 2x wider here, so the in-loop teacher's cost is realistic
    t_cfg = cfg.replace(n_layers=12, d_model=128, n_heads=8, n_kv_heads=8,
                        head_dim=16, d_ff=256)
    t_params = M.init_params(t_cfg, fp,
                             torch.Generator(device=device).manual_seed(7),
                             device)

    @torch.no_grad()
    def teacher_forward(batch):
        logits, _ = M.forward(t_params, batch, t_cfg, fp)
        return logits

    rows = {}
    out, _ = train_eval(cfg, qcfg, default_tcfg(), steps=steps, device=device)
    rows["no KD (hard labels)"] = out
    out, _ = train_eval(cfg, qcfg, default_tcfg(kd="teacher"), steps=steps,
                        teacher_forward=teacher_forward, device=device)
    rows["vanilla KD (teacher in loop)"] = out
    out, _ = train_eval(cfg, qcfg, default_tcfg(kd="mckd", kd_topk=8),
                        steps=steps, device=device)
    rows["MCKD (precomputed top-K)"] = out
    return rows


def main(argv=None):
    args = cli_args(argv, 50)
    rows = run(args.steps, args.device)
    print(f"{'scheme':30s} {'s/step':>8s} {'eval CE':>8s} {'acc':>6s}")
    for name, o in rows.items():
        print(f"{name:30s} {o['s_per_step']:8.3f} {o['eval_ce']:8.3f} "
              f"{o['eval_acc']:6.3f}")
    speedup = (rows["vanilla KD (teacher in loop)"]["s_per_step"]
               / max(rows["MCKD (precomputed top-K)"]["s_per_step"], 1e-9))
    print(f"# MCKD step-time speedup over vanilla KD: {speedup:.2f}x "
          "(paper: ~2.5x total time)")
    return rows


if __name__ == "__main__":
    main()
