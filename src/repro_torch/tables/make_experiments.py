"""The dry-run and roofline markdown tables from the dry run's records
(twin of `benchmarks/make_experiments.py`).

    python -m repro_torch.tables.make_experiments [dryrun_results.jsonl]

Reads the JSON lines of `repro_torch.launch.dryrun` and prints three
markdown tables: the single-pod (16 x 16) and multi-pod (2 x 16 x 16) cells
(status, the meta run's seconds `trace_s` where the reference prints its
`compile_s`, GiB a rank, whether the rank fits the H100's 80 GB where the
reference asks 16 GB, the collectives by count), and the single-pod
roofline (the three terms of one rank, the dominant one, the useful-FLOPs
ratio, the roofline fraction, what moves the bound).
"""
from __future__ import annotations

import sys

from repro_torch.tables.roofline_report import DEFAULT_PATH, HINTS, load


def fmt_bytes(b) -> str:
    return f"{b / 2**30:.2f}"


def dryrun_table(recs, multi_pod: bool) -> str:
    lines = ["| arch | shape | status | trace s | GiB/rank | fits 80G | collectives (count) |",
             "|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["multi_pod"] != multi_pod:
            continue
        if r["status"] == "skipped":
            lines.append(f"| {r['arch']} | {r['shape']} | skip (long-ctx rule) "
                         f"| — | — | — | — |")
            continue
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | **ERROR** | — | — | — "
                         f"| {(r.get('error') or '')[:40]} |")
            continue
        coll = r["collectives"]["count_by_op"]
        coll_s = ", ".join(f"{k}:{int(v)}" for k, v in sorted(coll.items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | ok | {r['trace_s']} "
            f"| {fmt_bytes(r['per_device_bytes'])} "
            f"| {'yes' if r['fits_80g'] else 'NO'} | {coll_s} |")
    return "\n".join(lines)


def roofline_table(recs) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | bound "
             "| useful | roofline frac | what moves the bound |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r["multi_pod"] or r["status"] != "ok":
            continue
        roof = r["roofline"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {roof['compute_s']:.2e} "
            f"| {roof['memory_s']:.2e} | {roof['collective_s']:.2e} "
            f"| {roof['dominant'].replace('_s', '')} "
            f"| {roof.get('useful_flops_ratio', 0):.3f} "
            f"| {roof.get('roofline_fraction', 0):.4f} "
            f"| {HINTS[roof['dominant']]} |")
    return "\n".join(lines)


def render(recs) -> str:
    return "\n".join([
        "### Single-pod (16x16 = 256 ranks)\n", dryrun_table(recs, multi_pod=False),
        "\n### Multi-pod (2x16x16 = 512 ranks)\n", dryrun_table(recs, multi_pod=True),
        "\n### Roofline (single-pod)\n", roofline_table(recs)])


def main(argv=None) -> str:
    argv = sys.argv[1:] if argv is None else argv
    out = render(load(argv[0] if argv else DEFAULT_PATH))
    print(out)
    return out


if __name__ == "__main__":
    main()
