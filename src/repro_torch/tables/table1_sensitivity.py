"""Tab. 1 / Tab. 9: quantization sensitivity (twin of
`benchmarks/table1_sensitivity.py`).

Leave-one-out: quantize everything EXCEPT one module group; quantize-one-
only: quantize ONLY that group. The paper finds MHSA (above all `value`)
the most sensitive: keeping it full-precision recovers the most accuracy,
and quantizing only it costs the most.

    python -m repro_torch.tables.table1_sensitivity [--device cpu] [--steps N]
"""
from __future__ import annotations

from repro_torch.core.policy import QuantConfig
from repro_torch.core.sensitivity import (leave_one_out_configs,
                                          quantize_one_only_configs)
from repro_torch.tables.common import (bench_model, cli_args, default_tcfg,
                                       train_eval)


def run(steps: int = 100, device=None):
    """[(row name, eval CE, eval acc)]: the FP model, the leave-one-out
    rows, then the quantize-one-only rows."""
    cfg = bench_model("qwen1.5-0.5b")
    base = QuantConfig(w_bits=2, a_bits=2, mode="lsq")  # stress bitwidth
    rows = []
    for name, qcfg in leave_one_out_configs(base):
        out, _ = train_eval(cfg, qcfg, default_tcfg(), steps=steps, device=device)
        rows.append((name, out["eval_ce"], out["eval_acc"]))
    for name, qcfg in quantize_one_only_configs(base):
        out, _ = train_eval(cfg, qcfg, default_tcfg(), steps=steps, device=device)
        rows.append((name, out["eval_ce"], out["eval_acc"]))
    fp = QuantConfig(mode="off")
    out, _ = train_eval(cfg, fp, default_tcfg(), steps=steps, device=device)
    rows.insert(0, ("None (FP model)", out["eval_ce"], out["eval_acc"]))
    return rows


def main(argv=None):
    args = cli_args(argv, 100)
    rows = run(args.steps, args.device)
    print(f"{'Quantization target':28s} {'eval CE':>8s} {'acc':>6s}")
    for name, ce, acc in rows:
        print(f"{name:28s} {ce:8.3f} {acc:6.3f}")
    d = {n: acc for n, _, acc in rows}
    print(f"# acc recovered: FP-MHSA=+{d['All, except MHSA'] - d['All']:.3f} "
          f"FP-value=+{d['All, except value'] - d['All']:.3f} "
          f"FP-FFN=+{d['All, except FFN'] - d['All']:.3f} "
          "(paper: MHSA / value high)")
    return rows


if __name__ == "__main__":
    main()
