"""The port's kernel benchmark (`repro_torch.launch.kernel_bench`): its
gates pass on the CPU, they are the reference's (`benchmarks/kernel_bench.py`)
case for case, it writes nothing but its --out file, and it refuses to run
on a missing GPU unless asked for the CPU."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from benchmarks import kernel_bench as jkb  # noqa: E402
from repro_torch.launch import kernel_bench as kb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_gates_are_the_reference_gates():
    assert kb._PARITY_CASES == jkb._PARITY_CASES
    assert (kb.TOL_FWD, kb.TOL_GRAD) == (jkb.TOL_FWD, jkb.TOL_GRAD)
    assert kb._DECODE_GATES == jkb._DECODE_GATES
    assert kb._DECODE_POOLS == jkb._DECODE_POOLS
    assert (kb.M, kb.K, kb.N) == (jkb.M, jkb.K, jkb.N)


def test_smoke_on_cpu_passes_and_writes_only_its_out(tmp_path):
    work = tmp_path / "cwd"
    work.mkdir()
    out = tmp_path / "res" / "kb.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    before = set((ROOT / "build").rglob("*")) if (ROOT / "build").exists() else set()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.kernel_bench", "--smoke",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=work, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FAIL" not in proc.stdout
    assert list(work.iterdir()) == []
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == ["kb.json"]
    after = set((ROOT / "build").rglob("*")) if (ROOT / "build").exists() else set()
    assert after == before
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["smoke"] is True
    cases = {k.split(".")[0] for k in res["equivalence"]}
    assert cases == set(jkb._PARITY_CASES)
    assert all(v <= (kb.TOL_FWD if k.endswith(".fwd") else kb.TOL_GRAD)
               for k, v in res["equivalence"].items())
    assert sorted(res["decode_parity"]) == sorted(
        f"int{b}.decode.w{w}" for b in (0, 8, 4) for w in (0, 4))
    for bits, floor in jkb._DECODE_GATES.items():
        assert res["decode_gates"][f"int{bits}"]["reduction"] >= floor
    assert res["qat_bwd_gate"]["combined_bytes"] < res["qat_bwd_gate"]["split_bytes"]
    assert res["embedding_gate"]["lookup_equal"] is True


def test_decode_kernel_bytes_match_the_reference_boundary():
    """The kernel side of the decode traffic gate is the reference's
    boundary count (BENCH_kernels.json: the same inputs and outputs)."""
    ref = json.loads((ROOT / "BENCH_kernels.json").read_text())
    sweep = {(c["kv_bits"], c["n_slots"], c["max_len"]): c["fused_hbm_bytes"]
             for c in ref["decode_attention"]["pool_sweep"]}
    for bits in (8, 4):
        case = kb.decode_attention_case(torch.device("cpu"), bits, 4, 512)
        assert case["kernel_bytes"] == sweep[(bits, 4, 512)]


def test_byte_counter_counts_ops_not_views():
    a = torch.ones(100)
    b = torch.ones(100)
    with kb.ByteCounter() as bc:
        c = (a + b).reshape(10, 10).t()
        c.sum()
    # add: 2 reads + 1 write of 400 bytes; sum: 400 read + 4 written
    assert bc.bytes == 3 * 400 + 404 and bc.ops == 2
    assert kb.boundary_bytes((a, torch.ones(3).expand(5, 3)), b) == 400 + 12 + 400


def test_without_cuda_it_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kb.main(["--smoke", "--out", os.devnull])


def test_full_run_on_cpu_counts_bytes_and_times_nothing(tmp_path):
    """Without --smoke the run adds the reference's sections; on the CPU
    it counts bytes but measures no time (null, never a CPU number under a
    device name), and the gates still pass."""
    out = tmp_path / "kb.json"
    assert kb.main(["--device", "cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    for sect in ("qat_fwd", "qat_bwd", "serving_int4", "embedding_pack",
                 "decode_attention", "standalone"):
        assert sect in res, sect
    times = [v for sect in ("qat_fwd", "qat_bwd", "serving_int4", "standalone")
             for k, v in res[sect].items() if k.endswith("_ms")]
    times += [c[k] for c in res["decode_attention"]["pool_sweep"]
              for k in ("kernel_ms", "unfused_ms")]
    assert len(times) == 23 and all(t is None for t in times)
    sa = res["standalone"]
    assert sa["shape"] == [4096, 1024]
    # boundary: the f32 tensor read and written once (+ the scale) /
    # read once (+ the scale, + the (3, 16) f32 result)
    assert sa["fake_quant_kernel_bytes"] == 2 * 4096 * 1024 * 4 + 4
    assert sa["bin_stats_kernel_bytes"] == 4096 * 1024 * 4 + 4 + 3 * 16 * 4
    assert len(res["decode_attention"]["pool_sweep"]) == 6
