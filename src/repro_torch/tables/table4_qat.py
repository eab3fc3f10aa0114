"""Tab. 4: the main QAT comparison, LSQ+ baseline against + KD against the
full method, at W4A4 / W3A3 / W2A2 (twin of `benchmarks/table4_qat.py`).

The paper's ordering: ours >= baseline + KD >= baseline at every bitwidth,
the margin growing as the bits shrink.

    python -m repro_torch.tables.table4_qat [--device cpu] [--steps N]
"""
from __future__ import annotations

import torch

from repro_torch.core.policy import QuantConfig
from repro_torch.data.synthetic import DataConfig
from repro_torch.models import model as M
from repro_torch.tables.common import (bench_model, cli_args, default_tcfg,
                                       train_eval)

BITS = (4, 3, 2)
# KD's value is variance reduction on noisy targets (paper Sec. 4.4.2):
# evaluated in the noisy-label regime, where the FP teacher's soft
# distribution beats one-hot labels.
NOISY = DataConfig(p_noise=0.3)


def method_cfgs(bits: int):
    lam = 0.01 if bits <= 3 else 0.0
    return {
        "baseline(LSQ+)": (QuantConfig(w_bits=bits, a_bits=bits, mode="lsq"),
                           default_tcfg(), False),
        "baseline+KD": (QuantConfig(w_bits=bits, a_bits=bits, mode="lsq"),
                        default_tcfg(kd="teacher"), True),
        "ours(MDQ+KD+OBR)": (
            QuantConfig(w_bits=bits, a_bits=bits, mode="mdq", obr_lambda=lam),
            default_tcfg(kd="teacher"), True),
    }


def run(steps: int = 120, device=None):
    """[(method, bits, eval CE, eval acc)]: the FP teacher (bits 32), then
    each method at each bitwidth, KD from the trained FP teacher."""
    cfg = bench_model("qwen1.5-0.5b")
    fp_q = QuantConfig(mode="off")
    fp_out, fp_state = train_eval(cfg, fp_q, default_tcfg(), steps=steps,
                                  dcfg=NOISY, device=device)
    rows = [("FP", 32, fp_out["eval_ce"], fp_out["eval_acc"])]
    t_params = fp_state["params"]

    @torch.no_grad()
    def teacher_forward(batch):
        logits, _ = M.forward(t_params, batch, cfg, fp_q)
        return logits

    for bits in BITS:
        for name, (qcfg, tcfg, kd) in method_cfgs(bits).items():
            out, _ = train_eval(cfg, qcfg, tcfg, steps=steps, dcfg=NOISY,
                                teacher_forward=teacher_forward if kd else None,
                                device=device)
            rows.append((name, bits, out["eval_ce"], out["eval_acc"]))
    return rows


def main(argv=None):
    args = cli_args(argv, 120)
    rows = run(args.steps, args.device)
    print(f"{'method':22s} {'bits':>4s} {'eval CE':>8s} {'acc':>6s}")
    for name, bits, ce, acc in rows:
        print(f"{name:22s} {bits:4d} {ce:8.3f} {acc:6.3f}")
    by = {(n, b): acc for n, b, _, acc in rows}
    ok = sum(by[("ours(MDQ+KD+OBR)", b)] >= by[("baseline(LSQ+)", b)] - 1e-6
             for b in BITS)
    print(f"# ours >= baseline (acc) at {ok}/{len(BITS)} bitwidths "
          "(paper: all; smoke-scale runs are noisy)")
    return rows


if __name__ == "__main__":
    main()
