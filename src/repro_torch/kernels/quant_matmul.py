"""Serving matmuls over int-coded weights: wrappers of `csrc/quant_matmul.cu`.

`int_matmul` (one int8 code a byte) and `int4_matmul` (two nibble-packed
codes a byte) replace the JAX package's Pallas kernels of the same names
(src/repro/kernels/quant_matmul.py:819 and :863). Both compute
x @ bf16(code * max(col_scale, 1e-9)) with bf16 x and f32 accumulation.

Dispatch is by the device of `x` alone: a CPU tensor takes the plain
version in `kernels/ref.py`; a CUDA tensor launches the kernel, and any
build or launch failure raises. Each wrapper counts its launches in its
`launches` attribute (a plain int, reset with `ops.reset_launch_counts`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = build.load("quant_matmul")
    if not _SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.int_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, i, p]
        lib.int_matmul_launch.restype = ctypes.c_int
        _SIGNED = True
    return lib


def _check(x, codes, scale, k_rows: int):
    if x.device.type != "cuda":
        raise ValueError(f"int(4)_matmul kernel needs CUDA tensors, got {x.device}")
    for name, t in (("codes", codes), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dim() != 2 or codes.dim() != 2 or scale.dim() != 1:
        raise ValueError(f"shapes x {tuple(x.shape)} codes {tuple(codes.shape)} "
                         f"scale {tuple(scale.shape)}: want (M,K), (K',N), (N,)")
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    if codes.shape[0] != k_rows or scale.shape[0] != codes.shape[1]:
        raise ValueError(f"shape mismatch x {tuple(x.shape)} codes "
                         f"{tuple(codes.shape)} scale {tuple(scale.shape)}")


def _launch(x, codes, scale, packed: bool) -> torch.Tensor:
    m, k = x.shape
    n = codes.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    codes = codes.contiguous()
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    vec = int(n % 4 == 0 and codes.data_ptr() % 4 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _lib().int_matmul_launch(xb.data_ptr(), codes.data_ptr(),
                                  scale.data_ptr(), out.data_ptr(), m, k, n,
                                  int(packed), vec, stream)
    if rc != 0:
        raise RuntimeError(f"int_matmul_launch failed: cudaError {rc} "
                           f"(M={m}, K={k}, N={n}, packed={packed})")
    return out


def int_matmul(x: torch.Tensor, w_codes: torch.Tensor,
               w_col_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(codes (K, N) int8, col_scale (N,)) -> (M, N) f32."""
    if x.device.type == "cpu":
        return ref.int_matmul(x, w_codes, w_col_scale)
    _check(x, w_codes, w_col_scale, x.shape[1])
    out = _launch(x, w_codes, w_col_scale, packed=False)
    int_matmul.launches += 1
    return out


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                w_col_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(packed (K/2, N) int8 nibble pairs, col_scale (N,))."""
    if x.device.type == "cpu":
        return ref.int4_matmul(x, w_packed, w_col_scale)
    if x.shape[-1] % 2:
        raise ValueError(f"int4_matmul needs an even K, got {x.shape[-1]}")
    _check(x, w_packed, w_col_scale, x.shape[1] // 2)
    out = _launch(x, w_packed, w_col_scale, packed=True)
    int4_matmul.launches += 1
    return out


int_matmul.launches = 0
int4_matmul.launches = 0
