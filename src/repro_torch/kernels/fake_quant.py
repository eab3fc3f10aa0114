"""LSQ fake-quantization (Eq. 5 forward): wrappers of `csrc/fake_quant.cu`.

`fake_quant_2d` (per-tensor scale and optional offset) and `fake_quant_rows`
(one scale a row, no offset) replace the JAX package's Pallas kernels of the
same names (src/repro/kernels/fake_quant.py:48 and :73). Both are bound by
HBM bandwidth: one read of x and one write of the result, in x's dtype (f32
or bf16). The kernel reads the scale and offset from device memory, so a
call does not wait on the host; edges are masked where the reference pads
to its (256, 512) tiles.

A CPU tensor takes the plain version in `kernels/ref.py`, which the kernel
equals bit for bit; a CUDA tensor launches the kernel, and a build or
launch failure raises. Launches are counted in each wrapper's `launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGNED = False
_DTYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = build.load("fake_quant")
    if not _SIGNED:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # x scale offset y | n q_n q_p bf16 vec | stream
        lib.fake_quant_tensor_launch.argtypes = [p, p, p, p, ll, i, i, i, i, p]
        # x row_scale y | M N q_n q_p bf16 vec | stream
        lib.fake_quant_rows_launch.argtypes = [p, p, p, i, ll, i, i, i, i, p]
        lib.fake_quant_tensor_launch.restype = i
        lib.fake_quant_rows_launch.restype = i
        _SIGNED = True
    return lib


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 2:
        raise ValueError(f"{name} takes a 2D x, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 or bf16, got {x.dtype}")


def _device_scalar(v, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    if t.numel() != 1:
        raise ValueError(f"expected one value, got shape {tuple(t.shape)}")
    return t.reshape(1).contiguous()


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def fake_quant_2d(x: torch.Tensor, scale, offset=None, *, q_n: int,
                  q_p: int) -> torch.Tensor:
    """Per-tensor fake-quant of x (M, N) f32 or bf16 -> x's dtype; scale
    and offset are scalars (0-d tensors or numbers), offset None for none.
    Replaces the TPU kernel `fake_quant_2d` (src/repro/kernels/
    fake_quant.py:48); bound by HBM bytes (x read once, y written once)."""
    if x.device.type == "cpu":
        return ref.fake_quant_2d(x, scale, offset, q_n=q_n, q_p=q_p)
    _check(x, "fake_quant_2d")
    x = x.contiguous()
    s = _device_scalar(scale, x)
    b = None if offset is None else _device_scalar(offset, x)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().fake_quant_tensor_launch(
        x.data_ptr(), s.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), x.numel(), q_n, q_p, int(x.dtype == torch.bfloat16),
        int(_aligned(x, y)), stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant_tensor_launch failed: cudaError {rc} "
                           f"(shape {tuple(x.shape)}, {x.dtype})")
    fake_quant_2d.launches += 1
    return y


def fake_quant_rows(x: torch.Tensor, row_scale: torch.Tensor, *, q_n: int,
                    q_p: int) -> torch.Tensor:
    """Row-grouped fake-quant: x (M, N) f32 or bf16, row_scale (M, 1) — the
    group axis (heads, experts) on rows — -> x's dtype. Replaces the TPU
    kernel `fake_quant_rows` (src/repro/kernels/fake_quant.py:73); bound
    by HBM bytes (x read once, y written once)."""
    if x.device.type == "cpu":
        return ref.fake_quant_rows(x, row_scale, q_n=q_n, q_p=q_p)
    _check(x, "fake_quant_rows")
    m, n = x.shape
    if row_scale.numel() != m or row_scale.device != x.device:
        raise ValueError(f"row_scale {tuple(row_scale.shape)} on "
                         f"{row_scale.device}: want ({m}, 1) on {x.device}")
    x = x.contiguous()
    rs = row_scale.reshape(m).to(torch.float32).contiguous()
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().fake_quant_rows_launch(
        x.data_ptr(), rs.data_ptr(), y.data_ptr(), m, n, q_n, q_p,
        int(x.dtype == torch.bfloat16), int(n % 4 == 0 and _aligned(x, y)),
        stream)
    if rc != 0:
        raise RuntimeError(f"fake_quant_rows_launch failed: cudaError {rc} "
                           f"(shape {tuple(x.shape)}, {x.dtype})")
    fake_quant_rows.launches += 1
    return y


fake_quant_2d.launches = 0
fake_quant_rows.launches = 0
