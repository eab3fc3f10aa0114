"""The example twins (`repro_torch.examples`) and the table driver
(`repro_torch.tables.run`) run on the CPU at their smallest flags.

Each example keeps the reference example's flags and prints and adds
--device: without it the default is CUDA, which this container lacks, so
the call raises rather than fall back to the CPU.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.examples import (quickstart, sensitivity_analysis,  # noqa: E402
                                  serve_continuous, serve_quantized, train_qat_lm)
from repro_torch.tables import run as tables_run  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401 (autouse)


def test_quickstart(capsys):
    quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=granite-8b-smoke quant=W4A4 mode=mdq" in out
    assert "activation SDAM (Tab. 2 metric)" in out and out.rstrip().endswith("done.")
    assert out.count("step ") == 5


def test_sensitivity_analysis(capsys):
    rows = sensitivity_analysis.main(["--device", "cpu", "--steps", "3", "--bits", "2"])
    out = capsys.readouterr().out
    assert rows and all(len(r) == 3 for r in rows)
    assert "most sensitive kept-FP group" in out and rows[0][0] in out


@pytest.mark.parametrize("drain", [0, 2])
def test_serve_continuous(drain, capsys):
    engine = serve_continuous.main(["--device", "cpu", "--drain-after", str(drain)])
    out = capsys.readouterr().out
    assert "5+1 requests over 2 slots (int8 KV, gemma2-2b-smoke)" in out
    # no request is lost: each is a result or shed in the queue
    shed = [rid for rid, rec in engine.metrics.records.items()
            if rid not in engine.results and rec.finish_reason is not None]
    assert len(engine.results) + len(shed) == 6
    if drain:
        assert any(r.finish_reason == "drained" for r in engine.results.values()) or shed
    else:
        assert all(engine.results[f"req-{i}"].finish_reason == "length" for i in range(5))


def test_serve_quantized(capsys):
    toks = serve_quantized.main(["--device", "cpu", "--new-tokens", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert toks.shape == (4, 4)
    assert "int-coded (4.0x smaller)" in out and "KV cache:" in out


def test_train_qat_lm_resumes(tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16", "--log-every", "1",
            "--ckpt", str(tmp_path / "ck")]
    losses = train_qat_lm.main(argv + ["--steps", "2", "--save-every", "1"])
    assert len(losses) == 2 and all(l == l for l in losses)
    out = capsys.readouterr().out
    assert "params=83.1M  W4A4" in out
    # a second run resumes from the newest checkpoint, step 1, and runs from
    # there (the reference example's loop: range(restored step, steps))
    again = train_qat_lm.main(argv + ["--steps", "2", "--save-every", "100"])
    assert "[mdq] restored checkpoint at step 1" in capsys.readouterr().out
    assert len(again) == 1


def test_examples_default_to_cuda():
    for mod, argv in ((quickstart, []), (serve_quantized, []), (train_qat_lm, ["--steps", "1"]),
                      (sensitivity_analysis, []), (serve_continuous, [])):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main(argv)


def test_table_driver_on_the_cpu(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no dry-run results here: the report says so
    rows = tables_run.main(["--device", "cpu", "--steps", "3"])
    names = [r[0] for r in rows]
    assert names == ["table1_sensitivity", "table2_sdam", "table4_qat", "table5_kd",
                     "table7_oscillation", "table8_hardware", "kernel_bench",
                     "roofline_report"]
    out = capsys.readouterr().out
    assert "name,us_per_call,derived" in out
    assert "area_advantage=1.47x" in out and "cells_ok=0" in out
