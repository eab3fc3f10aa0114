"""The port stands alone: it imports neither JAX nor the JAX package, its
kernel sources are in the repository, and chip_smoke.py refuses to report a
result without a GPU or outside a checkout."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    for m in ("repro_torch.kernels.build", "repro_torch.launch.train",
              "repro_torch.train.train_step", "repro_torch.train.checkpoint",
              "repro_torch.optim.adamw", "repro_torch.core.kd"):
        assert m in mods, m
    assert len(mods) > 30
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib')) or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(bad)); print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[0] == "0", out.stdout


IMPORT_RE = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                       re.MULTILINE)


def test_no_source_imports_jax_or_the_jax_package():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(f) for f in files if IMPORT_RE.search(f.read_text())]
    assert offenders == []


def test_every_kernel_source_exists():
    from repro_torch.kernels import build
    assert set(build.SOURCES) == {"quant_matmul", "decode_attention",
                                  "qat_matmul"}
    for path in build.SOURCES.values():
        assert path.is_file() and path.suffix == ".cu"
        assert path.parent == PKG / "kernels" / "csrc"
        assert 'extern "C"' in path.read_text()
    assert "arch=compute_90a,code=sm_90a" in build.ARCH_FLAGS


def test_chip_smoke_refuses_without_gpu_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = subprocess.run([sys.executable, str(lone)], capture_output=True,
                         text=True, env=env, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def _c_param_count(source: Path, fn: str) -> int:
    m = re.search(r'extern "C" [\w ]+\b' + fn + r"\(([^)]*)\)", source.read_text())
    assert m, fn
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_ctypes_signatures_match_the_c_entries(monkeypatch):
    """Each wrapper declares as many ctypes arguments as its C entry takes
    (ctypes would pass a pointer it was not told about as a 32-bit int)."""
    import types
    from repro_torch.kernels import build, decode_attention, quant_matmul
    qat = ("qat_fwd_launch", "qat_dx_launch", "qat_dw_launch", "qat_bwd_launch",
           "qat_fwd_batched_launch", "qat_bwd_batched_launch")
    fake = {name: types.SimpleNamespace(**{
        fn: types.SimpleNamespace() for fn in (
            "int_matmul_launch", "decode_attention_launch",
            "decode_attention_smem_bytes") + qat}) for name in build.SOURCES}
    fake["qat_matmul"].qat_tile = lambda: quant_matmul.QAT_TILE
    monkeypatch.setattr(build, "load", lambda name: fake[name])
    monkeypatch.setattr(quant_matmul, "_SIGNED", False)
    monkeypatch.setattr(quant_matmul, "_QAT_SIGNED", False)
    monkeypatch.setattr(decode_attention, "_SIGNED", False)
    quant_matmul._lib()
    quant_matmul._qat_lib()
    decode_attention._lib()
    for lib, fn in (("quant_matmul", "int_matmul_launch"),
                    ("decode_attention", "decode_attention_launch"),
                    ("decode_attention", "decode_attention_smem_bytes"),
                    *(("qat_matmul", f) for f in qat)):
        declared = getattr(fake[lib], fn).argtypes
        assert len(declared) == _c_param_count(build.SOURCES[lib], fn), fn
