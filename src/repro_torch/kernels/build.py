"""Build the CUDA kernels from `csrc/` and load them with ctypes.

Each source is compiled by `nvcc -gencode arch=compute_90a,code=sm_90a -O3
-shared -Xcompiler -fPIC` into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
`build/kernels/` at the root of the checkout. The file name carries a hash
of the source, so an edited kernel is rebuilt and an unchanged one is not.
All sources build in parallel, one nvcc process each. Nothing is downloaded
and no prebuilt kernel is used: a missing nvcc or a failed build raises.

Building happens at first use (`load`), never at import: the CPU tests
import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
# kernel library name -> its CUDA source
SOURCES = {
    "quant_matmul": CSRC / "quant_matmul.cu",
    "decode_attention": CSRC / "decode_attention.cu",
    "qat_matmul": CSRC / "qat_matmul.cu",
    "fake_quant": CSRC / "fake_quant.cu",
    "bin_stats": CSRC / "bin_stats.cu",
}
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
_TICKETS: dict = {}


def build_dir() -> Path:
    """`build/kernels/` at the root of the checkout that holds this package."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared headers
    of `csrc/` and the flags."""
    text = SOURCES[name].read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(text + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()
    return build_dir() / f"{name}-{digest[:12]}.so"


def build_all(names=None) -> dict:
    """Compile every (or the named) kernel library that is not built yet.

    Starts one nvcc per source, all at once, and waits for them. Returns
    {name: {"seconds": wall seconds, "log": nvcc's stderr (ptxas -v)}};
    a library that was already built reports seconds 0.0 and no log.
    """
    names = list(SOURCES) if names is None else list(names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    report = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exit {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": secs, "log": stdout + stderr}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def ptr(t):
    """A tensor's data pointer for a ctypes argument, or None (NULL)."""
    return None if t is None else t.data_ptr()


def tickets(device, n: int, owner: str):
    """A zeroed int32 buffer of at least n tickets on `device`, one per
    `owner` (a kernel that merges its splits in the last block to arrive):
    made once with torch.zeros and grown when too short. The kernel leaves
    every ticket it takes at zero, so the buffer is zero again when the
    launch ends; launches on one stream run in turn."""
    key = (owner, str(device))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf
