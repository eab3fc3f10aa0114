"""Benchmark driver over the port (twin of `benchmarks/run.py`): one row per
paper table, the kernel bench and the roofline report.

    python -m repro_torch.tables.run [--device cpu] [--steps N]

Prints each table's own output, then ``name,us_per_call,derived`` CSV rows
in the reference's order: tables 1, 2, 4, 5, 7 and 8, the kernel bench
(`launch.kernel_bench.run`: its derived figure is the QAT forward's eager
unfused bytes over the kernel's boundary bytes) and the roofline report of
`dryrun_results.jsonl`. Runs on CUDA unless `--device cpu` is given (no
fallback); `--steps` sets every training table's steps (default: each
table's own). us_per_call is host wall time.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.kernels.ops import resolve_device


def _timed(name, fn):
    t0 = time.monotonic()
    result = fn()
    us = (time.monotonic() - t0) * 1e6
    return name, us, result


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="repro_torch.tables.run")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; no fallback")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps of every table (default: each table's own)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from repro_torch.launch import kernel_bench
    from repro_torch.tables import (roofline_report, table1_sensitivity, table2_sdam,
                                    table4_qat, table5_kd, table7_oscillation,
                                    table8_hardware)
    targv = ["--device", device.type] + ([] if args.steps is None
                                         else ["--steps", str(args.steps)])
    rows = []

    print("=" * 72, "\n[table1] sensitivity (leave-one-out / quantize-one-only)")
    name, us, r = _timed("table1_sensitivity", lambda: table1_sensitivity.main(targv))
    d = {n: acc for n, _, acc in r}
    rows.append((name, us,
                 f"fp_mhsa_acc_gain={d['All, except MHSA'] - d['All']:+.3f}"))

    print("=" * 72, "\n[table2] SDAM convnet-vs-transformer")
    name, us, r = _timed("table2_sdam", lambda: table2_sdam.main(targv))
    rows.append((name, us, f"transformer/convnet={r['transformer'] / r['convnet']:.2f}"))

    print("=" * 72, "\n[table4] QAT methods x bitwidths")
    name, us, r = _timed("table4_qat", lambda: table4_qat.main(targv))
    by = {(n, b): acc for n, b, _, acc in r}
    gain2 = by[("ours(MDQ+KD+OBR)", 2)] - by[("baseline(LSQ+)", 2)]
    rows.append((name, us, f"w2a2_acc_gain={gain2:+.3f}"))

    print("=" * 72, "\n[table5] KD schemes")
    name, us, r = _timed("table5_kd", lambda: table5_kd.main(targv))
    sp = (r["vanilla KD (teacher in loop)"]["s_per_step"]
          / max(r["MCKD (precomputed top-K)"]["s_per_step"], 1e-9))
    rows.append((name, us, f"mckd_speedup={sp:.2f}x"))

    print("=" * 72, "\n[table7] oscillation regularizers")
    name, us, r = _timed("table7_oscillation", lambda: table7_oscillation.main(targv))
    rows.append((name, us,
                 f"osc_base={r['baseline'].get('osc_pct', 0):.2f}%"
                 f"_obr={r['OBR lam=0.1'].get('osc_pct', 0):.2f}%"))

    print("=" * 72, "\n[table8] hardware MAC cost")
    name, us, r = _timed("table8_hardware", table8_hardware.main)
    ours = r["Ours (module-dependent, uniform W4A4)"][0]
    worst = max(v[0] for k, v in r.items() if k.startswith("MPQ"))
    rows.append((name, us, f"area_advantage={worst / ours:.2f}x"))

    print("=" * 72, "\n[kernels] CUDA kernels vs unfused")
    name, us, r = _timed("kernel_bench", lambda: kernel_bench.run(device))
    rows.append((name, us, f"hbm_reduction={r['qat_fwd']['reduction']:.1f}x"))

    print("=" * 72, "\n[roofline] dry-run sweep table")
    name, us, r = _timed("roofline_report", lambda: roofline_report.main([]))
    n_ok = sum(1 for x in r if x["status"] == "ok")
    rows.append((name, us, f"cells_ok={n_ok}"))

    print("=" * 72)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return rows


if __name__ == "__main__":
    main()
