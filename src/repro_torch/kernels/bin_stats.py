"""Per-bin statistics of a per-tensor quantizer: wrapper of `csrc/bin_stats.cu`.

`bin_stats_2d` replaces the JAX package's Pallas kernel of the same name
(src/repro/kernels/bin_stats.py:48): (3, n_bins) f32 [count, sum, sum of
squares] of w over the bins of clip(round(w / max(s, 1e-9)), -Q_N, Q_P) +
Q_N, in one pass over w. Bound on the card by reading w once (4 bytes an
element). Each element's code is computed once, by its own lane; a warp
groups equal codes (`__match_any_sync`) and the group's lowest lane adds
the group's count, sum and sum of squares (summed over a fixed lane tree
in f64) to the warp's own bins, so an element's work does not grow with
the bin count. The order is fixed (warp bins in warp order, per-block f64
partials, then a fixed-order f64 finish, no float atomics): the bits
repeat. NaN and Inf follow the reference's one-hot contraction (a NaN code
counts nowhere; a bin's sum is NaN when a non-finite w outside it meets the
one-hot's 0), as `ref.bin_stats_2d` spells out: a block whose bin sums show
such a value counts them again in a rare second pass.

A CPU tensor takes the plain version in `kernels/ref.py` (index_add_ in f64,
rounded once), and so does a meta tensor (shapes only; its masks take a
`nonzero`, which meta answers under the dry run's `rows_all_live`); a CUDA tensor
launches the kernel, and a build or launch failure raises. Launches are
counted in `bin_stats_2d.launches`; `launch.cost` counts a call as one op
of about 8 f32 operations an element and no dot FLOPs.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.launch import cost

TILE = 4096              # elements of a block step (csrc/bin_stats.cu)
THREADS = 256            # threads a block, each taking 4 float4s of a tile
BLOCKS_TARGET = 132 * 4  # about 4 blocks on each of the H100's 132 SMs
_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = build.load("bin_stats")
    if not _SIGNED:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.bin_stats_tile.argtypes = []
        lib.bin_stats_tile.restype = i
        # w scale partial out | n blocks tiles q_n q_p vec | stream
        lib.bin_stats_launch.argtypes = [p, p, p, p, ll, i, i, i, i, i, p]
        lib.bin_stats_launch.restype = i
        if lib.bin_stats_tile() != TILE:
            raise RuntimeError(f"bin_stats.cu tile {lib.bin_stats_tile()} != "
                               f"TILE {TILE}")
        _SIGNED = True
    return lib


def grid(n: int) -> tuple[int, int]:
    """(blocks, tiles a block) for n elements: about BLOCKS_TARGET blocks,
    each a fixed range of whole tiles."""
    n_tiles = max(1, -(-n // TILE))
    tiles = -(-n_tiles // BLOCKS_TARGET)
    return -(-n_tiles // tiles), tiles


def _figures(w, scale, *, q_n: int, q_p: int) -> dict:
    """`launch.cost` figures: elementwise work on the f32 units, and the
    blocks' f64 partial bins."""
    return {"flops": 0.0, "ops": 8.0 * w.numel(), "f32": True,
            "scratch": 8 * grid(w.numel())[0] * 3 * (q_n + q_p + 1)}


@cost.counted("bin_stats_2d", _figures)
def bin_stats_2d(w: torch.Tensor, scale, *, q_n: int, q_p: int) -> torch.Tensor:
    """w (M, N) with a per-tensor scale (0-d tensor or number) ->
    (3, q_n + q_p + 1) f32 [count, sum, sum of squares]. Replaces the TPU
    kernel `bin_stats_2d` (src/repro/kernels/bin_stats.py:48); bound by
    HBM bytes (w read once)."""
    if ref.takes_plain(w):
        return ref.bin_stats_2d(w, scale, q_n=q_n, q_p=q_p)
    if w.device.type != "cuda":
        raise ValueError(f"bin_stats_2d kernel needs CUDA tensors, got {w.device}")
    n_bins = q_n + q_p + 1
    if not 1 <= n_bins <= 256:
        raise ValueError(f"bin_stats_2d takes 1..256 bins, got {n_bins}")
    w = w.to(torch.float32).contiguous()
    s = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
    if s.numel() != 1:
        raise ValueError(f"bin_stats_2d takes a per-tensor scale, got {tuple(s.shape)}")
    s = s.reshape(1).contiguous()
    n = w.numel()
    blocks, tiles = grid(n)
    partial = torch.empty((blocks, 3, n_bins), dtype=torch.float64, device=w.device)
    out = torch.empty((3, n_bins), dtype=torch.float32, device=w.device)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    rc = _lib().bin_stats_launch(w.data_ptr(), s.data_ptr(), partial.data_ptr(),
                                 out.data_ptr(), n, blocks, tiles, q_n, q_p,
                                 int(w.data_ptr() % 16 == 0), stream)
    if rc != 0:
        raise RuntimeError(f"bin_stats_launch failed: cudaError {rc} "
                           f"(n={n}, bins={n_bins})")
    bin_stats_2d.launches += 1
    return out


bin_stats_2d.launches = 0
