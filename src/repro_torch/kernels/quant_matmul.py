"""Quantized matmuls: wrappers of `csrc/quant_matmul.cu` and `csrc/qat_matmul.cu`.

Serving, over int-coded weights: `int_matmul` (one int8 code a byte) and
`int4_matmul` (two nibble-packed codes a byte) replace the JAX package's
Pallas kernels of the same names (src/repro/kernels/quant_matmul.py:819 and
:863). Both compute x @ bf16(code * max(col_scale, 1e-9)) with bf16 x and
f32 accumulation.

Training, over latent f32 weights (the QAT hot path): `quant_matmul` (the
fused fake-quant forward, :81), `quant_matmul_dx` (:241), `quant_matmul_dw`
(:361) and `quant_matmul_bwd` (:574, all five cotangents at once), with the
reference's signatures: x (M, K), w (K, N), a_scale / a_offset 0-d, w_scale
(1, N) column or (K, 1) row groups, dy (M, N). Their MoE counterparts
`quant_matmul_batched` (:141) and `quant_matmul_bwd_batched` (:743) take a
leading expert axis: x (E, M, K), w (E, K, N), a_scale / a_offset (E, 1),
w_scale (E, N), dy (E, M, N). `quant_matmul_bwd[_batched]` keep the
reference's route rule: past `BWD_SCRATCH_BUDGET_BYTES` of (TPU) scratch
they run the split dx / dw kernels (expert by expert for the batched one),
so the port takes the same route at every shape; the GPU kernels themselves
do not use the tiles.

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
_QAT_SIGNED = False

# The reference's tiles and backward scratch budget (quant_matmul.py:34-41),
# copied with the same numbers: they only decide the combined-vs-split route.
DEFAULT_TILES = (128, 128, 512)  # (bm, bn, bk)
BWD_SCRATCH_BUDGET_BYTES = 8 * 1024 * 1024
QAT_TILE = 128  # output tile edge of csrc/qat_matmul.cu (checked at load)


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


# ---------------------------------------------------------------------------
# QAT fused matmul (csrc/qat_matmul.cu)
# ---------------------------------------------------------------------------

def bwd_scratch_bytes(m, k, n, tiles=DEFAULT_TILES):
    """f32 scratch footprint of the reference's combined backward: the
    (bm, bk) dX accumulator, the (bk, Np) dW row panel, and the (1, Np) dws
    scratch (a copy of the JAX package's formula)."""
    bm = min(tiles[0], m)
    bn = min(tiles[1], n)
    bk = min(tiles[2], k)
    n_pad = -(-n // bn) * bn
    return 4 * (bm * bk + bk * n_pad + n_pad)


def bwd_uses_combined(m, k, n, tiles=DEFAULT_TILES, scratch_budget=None):
    """Whether the reference's combined backward fits its scratch budget;
    past it quant_matmul_bwd runs the split dx / dw kernels."""
    budget = (BWD_SCRATCH_BUDGET_BYTES if scratch_budget is None
              else scratch_budget)
    return bwd_scratch_bytes(m, k, n, tiles) <= budget


def padded_dims(m: int, k: int, n: int, tiles=DEFAULT_TILES):
    """(M, K, N) as the JAX package's `ops` pads them to tile multiples
    before its kernels (and so before its route decision)."""
    bm, bn, bk = tiles
    return -(-m // bm) * bm, -(-k // bk) * bk, -(-n // bn) * bn


def _qat_lib() -> ctypes.CDLL:
    global _QAT_SIGNED
    lib = build.load("qat_matmul")
    if not _QAT_SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.qat_tile.argtypes = []
        lib.qat_tile.restype = i
        lib.qat_fwd_launch.argtypes = [p, i, p, p, p, p, i, p,
                                       i, i, i, i, i, i, i, p]
        lib.qat_dx_launch.argtypes = [p, p, i, p, p, p, p, i, p, p, p, p,
                                      i, i, i, i, i, i, i, i, p]
        lib.qat_dw_launch.argtypes = [p, p, i, p, p, p, p, i, p, p, p,
                                      i, i, i, i, i, i, i, i, p]
        lib.qat_bwd_launch.argtypes = [p, p, i, p, p, p, p, i, p, p, p, p, p,
                                       p, p, i, i, i, i, i, i, i, i, p]
        lib.qat_fwd_batched_launch.argtypes = [p, i, p, p, p, p, p,
                                               i, i, i, i, i, i, i, i, p]
        lib.qat_bwd_batched_launch.argtypes = [p, p, i, p, p, p, p, p, p, p,
                                               p, p, p, p, i, i, i, i, i, i,
                                               i, i, i, p]
        for fn in (lib.qat_fwd_launch, lib.qat_dx_launch, lib.qat_dw_launch,
                   lib.qat_bwd_launch, lib.qat_fwd_batched_launch,
                   lib.qat_bwd_batched_launch):
            fn.restype = i
        if lib.qat_tile() != QAT_TILE:
            raise RuntimeError(f"qat_matmul.cu tile {lib.qat_tile()} != "
                               f"QAT_TILE {QAT_TILE}")
        _QAT_SIGNED = True
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _qat_operands(x, w, a_scale, a_offset, w_scale, dy=None):
    """Check and normalise the operands of a QAT kernel launch: x (M, K)
    bf16 or f32, w (K, N) f32, 0-d scalars, w_scale (1, N) or (K, 1); all
    contiguous on one CUDA device. Returns (x, w, a_s, a_b, ws_vec, k_side,
    dy) with ws_vec the flat (N,) or (K,) scale vector."""
    if x.device.type != "cuda":
        raise ValueError(f"QAT kernels need CUDA tensors, got {x.device}")
    if x.dim() != 2 or w.dim() != 2 or w_scale.dim() != 2:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"w_scale {tuple(w_scale.shape)}: want (M,K), (K,N), "
                         "(1,N) or (K,1)")
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} disagree on K")
    if tuple(w_scale.shape) == (1, n):
        k_side = False
    elif tuple(w_scale.shape) == (k, 1):
        k_side = True
    else:
        raise ValueError(f"w_scale {tuple(w_scale.shape)} is neither (1, {n}) "
                         f"nor ({k}, 1)")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    ts = [x, w, w_scale] + ([] if dy is None else [dy])
    for t in ts + [torch.as_tensor(a_scale), torch.as_tensor(a_offset)]:
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
    if dy is not None and tuple(dy.shape) != (m, n):
        raise ValueError(f"dy {tuple(dy.shape)} != ({m}, {n})")
    f32 = lambda t: t.to(torch.float32).contiguous()
    return (x.contiguous(), f32(w), f32(a_scale.reshape(())),
            f32(a_offset.reshape(())), f32(w_scale.reshape(-1)), k_side,
            None if dy is None else f32(dy))


def _raise(name: str, rc: int, m: int, k: int, n: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaError {rc} (M={m}, K={k}, N={n})")


def quant_matmul(x, w, a_scale, a_offset, w_scale, *, q_n_a: int, q_p_a: int,
                 q_n_w: int, q_p_w: int) -> torch.Tensor:
    """q_a(x) @ q_w(w) -> (M, N) f32 (the reference's quant_matmul)."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if x.device.type == "cpu":
        return ref.quant_matmul(x, w, a_scale, a_offset, w_scale, **qs)
    x, w, a_s, a_b, ws, k_side, _ = _qat_operands(x, w, a_scale, a_offset,
                                                  w_scale)
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _qat_lib().qat_fwd_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(), int(k_side),
        out.data_ptr(), m, k, n, q_n_a, q_p_a, q_n_w, q_p_w, stream)
    _raise("qat_fwd_launch", rc, m, k, n)
    quant_matmul.launches += 1
    return out


def _bwd_launch(entry: str, dy, x, w, a_scale, a_offset, w_scale, qs: dict,
                round_cot: bool, want_dx: bool, want_dw: bool):
    x, w, a_s, a_b, ws, k_side, dy = _qat_operands(x, w, a_scale, a_offset,
                                                   w_scale, dy)
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    t = QAT_TILE
    outs, ptrs = [], []
    if want_dx:
        dx, dsa, dba = (torch.empty((m, k), **f32), torch.empty((), **f32),
                        torch.empty((), **f32))
        outs += [dx, dsa, dba]
        ptrs += [dx.data_ptr(), dsa.data_ptr(), dba.data_ptr()]
    if want_dw:
        dw = torch.empty((k, n), **f32)
        dws = torch.empty((k, 1) if k_side else (1, n), **f32)
        outs += [dw, dws]
        ptrs += [dw.data_ptr(), dws.data_ptr()]
    if want_dx:  # scratch: each dX block's (dsa, dba) partials
        part_x = torch.empty((2 * _cdiv(m, t) * _cdiv(k, t),), **f32)
        ptrs.append(part_x.data_ptr())
    if want_dw:  # scratch: dws partials per row block (or column block)
        rows = _cdiv(n, t) * k if k_side else _cdiv(k, t) * n
        part_w = torch.empty((rows,), **f32)
        ptrs.append(part_w.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(_qat_lib(), entry)(
        dy.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
        w.data_ptr(), a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(),
        int(k_side), *ptrs, m, k, n, qs["q_n_a"], qs["q_p_a"], qs["q_n_w"],
        qs["q_p_w"], int(round_cot), stream)
    _raise(entry, rc, m, k, n)
    return tuple(outs)


def quant_matmul_dx(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                    q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True):
    """(dX (M, K), dsa, dba): the backward wrt x, raw scale sums."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if x.device.type == "cpu":
        return ref.quant_matmul_dx(dy, x, w, a_scale, a_offset, w_scale,
                                   round_cot=round_cot, **qs)
    out = _bwd_launch("qat_dx_launch", dy, x, w, a_scale, a_offset, w_scale,
                      qs, round_cot, True, False)
    quant_matmul_dx.launches += 1
    return out


def quant_matmul_dw(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                    q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True):
    """(dW (K, N), dws (1, N) or (K, 1)): the backward wrt w."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if x.device.type == "cpu":
        return ref.quant_matmul_dw(dy, x, w, a_scale, a_offset, w_scale,
                                   round_cot=round_cot, **qs)
    out = _bwd_launch("qat_dw_launch", dy, x, w, a_scale, a_offset, w_scale,
                      qs, round_cot, False, True)
    quant_matmul_dw.launches += 1
    return out


def quant_matmul_bwd(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                     q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True,
                     scratch_budget=None):
    """(dX, dsa, dba, dW, dws) in one launch, or through the split dx / dw
    kernels where the reference would split (vocab-wide N): the route is
    `bwd_uses_combined` on the reference's padded shape."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    m, k = x.shape
    if not bwd_uses_combined(*padded_dims(m, k, w.shape[1]),
                             scratch_budget=scratch_budget):
        if x.device.type == "cuda":
            w = w.contiguous()  # one copy for both kernels (a transposed view)
        dx, dsa, dba = quant_matmul_dx(dy, x, w, a_scale, a_offset, w_scale,
                                       round_cot=round_cot, **qs)
        dw, dws = quant_matmul_dw(dy, x, w, a_scale, a_offset, w_scale,
                                  round_cot=round_cot, **qs)
        return dx, dsa, dba, dw, dws
    if x.device.type == "cpu":
        return ref.quant_matmul_bwd(dy, x, w, a_scale, a_offset, w_scale,
                                    round_cot=round_cot, **qs)
    out = _bwd_launch("qat_bwd_launch", dy, x, w, a_scale, a_offset, w_scale,
                      qs, round_cot, True, True)
    quant_matmul_bwd.launches += 1
    return out


def _batched_operands(x, w, a_scale, a_offset, w_scale, dy=None):
    """Check and normalise the operands of a batched (per-expert) launch:
    x (E, M, K) bf16 or f32, w (E, K, N), a_scale / a_offset (E, 1) or
    (E,), w_scale (E, N), dy (E, M, N); all on one CUDA device. Returns
    them contiguous, the scales flat f32 (E,) / (E, N), w and dy f32."""
    if x.device.type != "cuda":
        raise ValueError(f"QAT kernels need CUDA tensors, got {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)}: "
                         "want (E,M,K), (E,K,N)")
    e, m, k = x.shape
    if tuple(w.shape[:2]) != (e, k):
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} disagree "
                         "on E or K")
    n = w.shape[2]
    if tuple(w_scale.shape) != (e, n):
        raise ValueError(f"w_scale {tuple(w_scale.shape)} != ({e}, {n})")
    for name, t in (("a_scale", a_scale), ("a_offset", a_offset)):
        if t.numel() != e:
            raise ValueError(f"{name} {tuple(t.shape)} has not one value an expert")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or f32, got {x.dtype}")
    for t in (w, a_scale, a_offset, w_scale) + (() if dy is None else (dy,)):
        if t.device != x.device:
            raise ValueError(f"operand on {t.device}, x on {x.device}")
    if dy is not None and tuple(dy.shape) != (e, m, n):
        raise ValueError(f"dy {tuple(dy.shape)} != ({e}, {m}, {n})")
    f32 = lambda t: t.to(torch.float32).contiguous()
    return (x.contiguous(), f32(w), f32(a_scale.reshape(e)),
            f32(a_offset.reshape(e)), f32(w_scale),
            None if dy is None else f32(dy))


def quant_matmul_batched(x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                         q_p_a: int, q_n_w: int, q_p_w: int) -> torch.Tensor:
    """Per expert q_a(x[e]) @ q_w(w[e]) -> (E, M, N) f32 (the reference's
    quant_matmul_batched): x (E, M, K), w (E, K, N), a_scale / a_offset
    (E, 1), w_scale (E, N) per-expert column scales."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if x.device.type == "cpu":
        return ref.quant_matmul_batched(x, w, a_scale, a_offset, w_scale, **qs)
    x, w, a_s, a_b, ws, _ = _batched_operands(x, w, a_scale, a_offset, w_scale)
    e, m, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, m, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _qat_lib().qat_fwd_batched_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(), out.data_ptr(),
        e, m, k, n, q_n_a, q_p_a, q_n_w, q_p_w, stream)
    _raise("qat_fwd_batched_launch", rc, m, k, n)
    quant_matmul_batched.launches += 1
    return out


def quant_matmul_bwd_batched(dy, x, w, a_scale, a_offset, w_scale, *,
                             q_n_a: int, q_p_a: int, q_n_w: int, q_p_w: int,
                             round_cot: bool = True, scratch_budget=None):
    """(dX (E, M, K), dsa (E, 1), dba (E, 1), dW (E, K, N), dws (E, N)), the
    scale sums raw, in one launch (+ the finish pass); or, where the
    reference's combined kernel would not fit its scratch budget on the
    padded per-expert shape, expert by expert through the split
    quant_matmul_dx / quant_matmul_dw (the reference's fallback)."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    e, m, k = x.shape
    n = w.shape[2]
    if not bwd_uses_combined(*padded_dims(m, k, n),
                             scratch_budget=scratch_budget):
        outs = []
        for i in range(e):
            wi = w[i].contiguous() if x.device.type == "cuda" else w[i]
            args = (dy[i], x[i], wi, a_scale.reshape(e)[i],
                    a_offset.reshape(e)[i], w_scale[i:i + 1])
            dx_e, dsa_e, dba_e = quant_matmul_dx(*args, round_cot=round_cot, **qs)
            dw_e, dws_e = quant_matmul_dw(*args, round_cot=round_cot, **qs)
            outs.append((dx_e, dsa_e, dba_e, dw_e, dws_e[0]))
        dx, dsa, dba, dw, dws = (torch.stack(t) for t in zip(*outs))
        return dx, dsa.reshape(e, 1), dba.reshape(e, 1), dw, dws
    if x.device.type == "cpu":
        return ref.quant_matmul_bwd_batched(dy, x, w, a_scale, a_offset,
                                            w_scale, round_cot=round_cot, **qs)
    x, w, a_s, a_b, ws, dy = _batched_operands(x, w, a_scale, a_offset,
                                               w_scale, dy)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    t = QAT_TILE
    dx, dw = torch.empty((e, m, k), **f32), torch.empty((e, k, n), **f32)
    dsa, dba = torch.empty((e, 1), **f32), torch.empty((e, 1), **f32)
    dws = torch.empty((e, n), **f32)
    part_x = torch.empty((e * 2 * _cdiv(m, t) * _cdiv(k, t),), **f32)
    part_w = torch.empty((e * _cdiv(k, t) * n,), **f32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _qat_lib().qat_bwd_batched_launch(
        dy.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
        w.data_ptr(), a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(),
        dx.data_ptr(), dsa.data_ptr(), dba.data_ptr(), dw.data_ptr(),
        dws.data_ptr(), part_x.data_ptr(), part_w.data_ptr(), e, m, k, n,
        q_n_a, q_p_a, q_n_w, q_p_w, int(round_cot), stream)
    _raise("qat_bwd_batched_launch", rc, m, k, n)
    quant_matmul_bwd_batched.launches += 1
    return dx, dsa, dba, dw, dws


quant_matmul.launches = 0
quant_matmul_dx.launches = 0
quant_matmul_dw.launches = 0
quant_matmul_bwd.launches = 0
quant_matmul_batched.launches = 0
quant_matmul_bwd_batched.launches = 0
