"""Roofline table from the dry-run sweep (twin of
`benchmarks/roofline_report.py`).

    python -m repro_torch.tables.roofline_report [--path dryrun_results.jsonl]

Reads the JSON lines of `repro_torch.launch.dryrun` and prints, per (arch x
shape) on the single-pod mesh: the three roofline terms of one H100 rank,
the dominant one, the useful-FLOPs ratio (model FLOPs over the rank's
counted FLOPs x chips), the roofline fraction, and whether the rank fits
the card's 80 GB; then a count of the multi-pod cells, and a hint for each
dominant term the table shows.
"""
from __future__ import annotations

import argparse
import json
import os

HINTS = {
    "compute_s": "raise the useful-FLOPs ratio: expert-parallel MoE and "
                 "tensor-parallel recurrent / cross-attention blocks (each model "
                 "rank still computes those whole), cut remat waste / MoE "
                 "capacity slack",
    "memory_s": "cut HBM traffic: eager PyTorch writes every op's result to HBM; "
                "fuse the elementwise chains around the QAT kernels, bf16 "
                "attention probabilities, flash-style attention in training",
    "collective_s": "reshard: fewer FSDP regathers per microbatch, keep the model "
                    "axis inside one NVLink node (8 cards), overlap collectives "
                    "with compute, compress cross-node gradients (int8)",
}
DEFAULT_PATH = "dryrun_results.jsonl"


def load(path: str = DEFAULT_PATH):
    recs = []
    if not os.path.exists(path):
        return recs
    with open(path) as f:
        for line in f:
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    # keep the LAST record per cell (later rows override re-runs)
    dedup = {}
    for r in recs:
        dedup[(r["arch"], r["shape"], r["multi_pod"], r.get("preset", ""))] = r
    return list(dedup.values())


def table(recs, *, multi_pod=False):
    rows = []
    for r in recs:
        if r["multi_pod"] != multi_pod:
            continue
        if r["status"] == "skipped":
            rows.append((r["arch"], r["shape"], "SKIP", r.get("reason", "")[:60],
                         "", "", "", "", ""))
            continue
        if r["status"] != "ok":
            rows.append((r["arch"], r["shape"], "ERR",
                         (r.get("error") or "")[:60], "", "", "", "", ""))
            continue
        roof = r["roofline"]
        rows.append((
            r["arch"], r["shape"], roof["dominant"].replace("_s", ""),
            f"{roof['compute_s']:.2e}", f"{roof['memory_s']:.2e}",
            f"{roof['collective_s']:.2e}",
            f"{roof.get('useful_flops_ratio', 0):.3f}",
            f"{roof.get('roofline_fraction', 0):.4f}",
            "fits" if r.get("fits_80g") else
            f"OOM:{r['per_device_bytes'] / 2**30:.0f}G",
        ))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.tables.roofline_report")
    ap.add_argument("--path", default=DEFAULT_PATH)
    args = ap.parse_args(argv)
    recs = load(args.path)
    if not recs:
        print(f"no {args.path} found — run repro_torch.launch.dryrun first")
        return []
    hdr = ("arch", "shape", "bound", "compute_s", "memory_s", "coll_s",
           "useful", "roof_frac", "mem")
    fmt = "%-22s %-12s %-7s %-10s %-10s %-10s %-7s %-9s %-9s"
    print(fmt % hdr)
    for row in table(recs, multi_pod=False):
        print(fmt % row)
    n_multi = sum(1 for r in recs if r["multi_pod"] and r["status"] == "ok")
    n_multi_bad = sum(1 for r in recs if r["multi_pod"] and r["status"] == "error")
    print(f"# multi-pod (2x16x16) cells: {n_multi} ok, {n_multi_bad} failed")
    for term in sorted({r["roofline"]["dominant"] for r in recs if r["status"] == "ok"}):
        print(f"# {term.replace('_s', '')}-bound: {HINTS[term]}")
    return recs


if __name__ == "__main__":
    main()
