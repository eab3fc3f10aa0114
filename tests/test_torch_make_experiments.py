"""`repro_torch.tables.make_experiments` (twin of
`benchmarks/make_experiments.py`) on the dry run's own records: smoke cells
of reduced qwen1.5-0.5b through `launch.dryrun.lower_cell` on a (1, 4) and
a (1, 1, 4) mesh (rank 0 of 4, tensor-parallel) plus a skipped cell, as
the dry-run CLI writes them. The twin's tables have the reference's rows
for the same records (read with `trace_s` as `compile_s` and the 80 GB
card's fit as `fits_16g`) and the port's numbers in them."""
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import make_experiments as ref  # noqa: E402
from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.tables import make_experiments as M  # noqa: E402
from repro_torch.tables.roofline_report import HINTS  # noqa: E402

ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    cfg = reduced_config(get_config(ARCH))
    recs = []
    for name, mesh, multi in (("train_4k", (1, 4), False), ("decode_32k", (1, 4), False),
                              ("decode_32k", (1, 1, 4), True)):
        rec = {"arch": ARCH, "shape": name, "multi_pod": multi, "preset": "w4a4"}
        rec.update(D.lower_cell(ARCH, name, multi_pod=multi, preset="w4a4", grad_accum=8,
                                serve_kv_bits=8, mesh_sizes=mesh, cfg=cfg,
                                shape=shp.get_shape(name, smoke=True)))
        recs.append(rec)
    recs.append({"arch": ARCH, "shape": "long_500k", "multi_pod": False, "preset": "w4a4",
                 "status": "skipped", "reason": "long-context rule"})
    path = tmp_path_factory.mktemp("mx") / "dr.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return path, recs


def _rows(table: str) -> list:
    return [line for line in table.splitlines()[2:] if line.startswith("|")]


def test_tables_render_the_dry_run_records(records, capsys):
    path, recs = records
    out = M.main([str(path)])
    assert out == capsys.readouterr().out.rstrip("\n")
    single = M.dryrun_table(recs, multi_pod=False)
    rows = _rows(single)
    assert len(rows) == 3
    ok = [r for r in recs if r["status"] == "ok" and not r["multi_pod"]]
    for r in ok:
        line = next(x for x in rows if f"| {r['shape']} | ok |" in x)
        assert f"| {r['trace_s']} | {M.fmt_bytes(r['per_device_bytes'])} | yes |" in line
        if r["shape"] == "train_4k":  # the loss reads rank 0's logit columns
            assert "all-reduce:" in line and "all-gather:" not in line
        else:  # serving gathers its row-parallel partials and the logits
            assert "all-gather:" in line
    assert any("skip (long-ctx rule)" in x for x in rows)
    assert len(_rows(M.dryrun_table(recs, multi_pod=True))) == 1
    roof = _rows(M.roofline_table(recs))
    assert len(roof) == 2
    for r, line in zip(sorted(ok, key=lambda r: r["shape"]), roof):
        assert HINTS[r["roofline"]["dominant"]] in line
        assert f"| {r['roofline']['useful_flops_ratio']:.3f} |" in line


def test_tables_have_the_reference_rows(records):
    """The reference's renderer on the same records, its keys filled from
    the port's: the same rows, the same cells but the fit column's card."""
    _, recs = records
    as_ref = [dict(r, compile_s=r.get("trace_s"),
                   fits_16g=r.get("per_device_bytes", 0) < 16 * 2**30) for r in recs]
    for multi in (False, True):
        ours = _rows(M.dryrun_table(recs, multi))
        theirs = _rows(ref.dryrun_table(as_ref, multi))
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            assert a.split("|")[1:5] == b.split("|")[1:5]
            assert a.split("|")[-2] == b.split("|")[-2]
    ours, theirs = _rows(M.roofline_table(recs)), _rows(ref.roofline_table(as_ref))
    assert [a.split("|")[1:9] for a in ours] == [b.split("|")[1:9] for b in theirs]
