"""Tab. 7 (+ Tab. 12 / 13): oscillation under different regularizers (twin
of `benchmarks/table7_oscillation.py`).

No regularizer against KURE (global kurtosis) against OBR at lambda 1, 0.1
and 0.01 on a 3-bit model: oscillation %, eval CE. Also the Tab. 13
direction: attention weights oscillate more than FFN weights.

    python -m repro_torch.tables.table7_oscillation [--device cpu] [--steps N]
"""
from __future__ import annotations

import torch

from repro_torch.core.obr import kure_loss
from repro_torch.core.oscillation import oscillation_fraction
from repro_torch.core.policy import QuantConfig
from repro_torch.models.model import quant_leaf_paths, quant_leaves
from repro_torch.tables.common import (bench_model, cli_args, default_tcfg,
                                       train_eval)
from repro_torch.train.train_step import make_train_step

ATTN_NAMES = ("wq", "wk", "wv", "wo")


def _kure_step(cfg, qcfg, tcfg, lam: float):
    """A train step with the KURE global-kurtosis regularizer added."""
    def extra(params, step):
        total = torch.zeros((), dtype=torch.float32)
        for w, _, _ in quant_leaves(params, qcfg):
            total = total.to(w.device) + kure_loss(w)
        return lam * total

    return make_train_step(cfg, qcfg, tcfg, extra_loss=extra)


def run(steps: int = 60, device=None):
    """{variant: train_eval's dict} for the regularizers, plus
    "_per_module": the baseline's mean oscillation % over attention and
    over FFN weights."""
    cfg = bench_model("qwen1.5-0.5b")
    rows = {}
    variants = {
        "baseline": QuantConfig(w_bits=3, a_bits=3, mode="mdq",
                                track_oscillation=True),
        "OBR lam=1.0": QuantConfig(w_bits=3, a_bits=3, mode="mdq",
                                   obr_lambda=1.0, track_oscillation=True),
        "OBR lam=0.1": QuantConfig(w_bits=3, a_bits=3, mode="mdq",
                                   obr_lambda=0.1, track_oscillation=True),
        "OBR lam=0.01": QuantConfig(w_bits=3, a_bits=3, mode="mdq",
                                    obr_lambda=0.01, track_oscillation=True),
    }
    states = {}
    for name, qcfg in variants.items():
        out, st = train_eval(cfg, qcfg, default_tcfg(), steps=steps,
                             device=device)
        rows[name] = out
        states[name] = (st, qcfg)
    kure_q = QuantConfig(w_bits=3, a_bits=3, mode="mdq", track_oscillation=True)
    out, _ = train_eval(cfg, kure_q, default_tcfg(), steps=steps,
                        step_fn=_kure_step(cfg, kure_q, default_tcfg(), 0.1),
                        device=device)
    rows["KURE lam=0.1"] = out

    # Tab. 13 direction: attention weights oscillate more than FFN weights
    st, qcfg = states["baseline"]
    attn_f, ffn_f = [], []
    for (path, _, _, _), osc in zip(quant_leaf_paths(st["params"], qcfg),
                                    st["osc"]):
        frac = float(oscillation_fraction(osc, qcfg.osc_threshold))
        (attn_f if path[-1] in ATTN_NAMES else ffn_f).append(frac)
    rows["_per_module"] = {
        "attn_osc_pct": 100 * sum(attn_f) / max(len(attn_f), 1),
        "ffn_osc_pct": 100 * sum(ffn_f) / max(len(ffn_f), 1),
    }
    return rows


def main(argv=None):
    args = cli_args(argv, 60)
    rows = run(args.steps, args.device)
    print(f"{'regularization':14s} {'osc %':>7s} {'eval CE':>8s} {'acc':>6s}")
    for name, o in rows.items():
        if name.startswith("_"):
            continue
        print(f"{name:14s} {o.get('osc_pct', float('nan')):7.2f} "
              f"{o['eval_ce']:8.3f} {o['eval_acc']:6.3f}")
    pm = rows["_per_module"]
    print(f"# per-module osc%: attn={pm['attn_osc_pct']:.2f} "
          f"ffn={pm['ffn_osc_pct']:.2f} (paper Tab. 13: attn > ffn)")
    base = rows["baseline"].get("osc_pct", 0)
    obr = rows["OBR lam=0.1"].get("osc_pct", 0)
    print(f"# OBR(0.1) reduces oscillation: {base:.2f}% -> {obr:.2f}% "
          f"({'OK' if obr <= base else 'VIOLATED'})")
    return rows


if __name__ == "__main__":
    main()
