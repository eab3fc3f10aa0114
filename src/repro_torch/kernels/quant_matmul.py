"""Quantized matmuls: wrappers of `csrc/quant_matmul.cu` and `csrc/qat_matmul.cu`.

Serving, over int-coded weights: `int_matmul` (one int8 code a byte) and
`int4_matmul` (two nibble-packed codes a byte) replace the JAX package's
Pallas kernels of the same names (src/repro/kernels/quant_matmul.py:819 and
:863). Both compute x @ bf16(code * max(col_scale, 1e-9)) with bf16 x and
f32 accumulation, on the tensor cores, with the contraction cut by one
plan (`int4_plan`, a function of (K, N) only) into splits that the last
block of each tile merges in order.

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

What runs on the card: every product runs on the tensor cores, both
forwards, both combined backwards (`quant_matmul_bwd` and, per expert,
`quant_matmul_bwd_batched`) and the split dx / dw (the vocab-wide head, and
each expert on the batched backward's split route): a prologue that
dequantizes each operand once into zero-padded bf16 scratch, then an
mma.sync tile, the expert on the grid; the scratch lives for the call. The
backwards take f32 cotangents (the lm heads') as three exact bf16 planes
(`ref.cotangent_planes`), whose bf16 x bf16 products sum to the f32
products; bf16 cotangents as one. Where the combined grid is short of a
wave and its dW tiles are deep (paper-deit-t's tall, narrow head),
`dw_splits` cuts the dW contraction into ranges that the last block of each
tile adds in order.
`fwd_prologue` / `bwd_prologue` run the prologues alone, 2D or per expert,
for checks.

Dispatch is by the device of `x` alone: a CPU tensor takes the plain
version in `kernels/ref.py`, and so does a meta tensor (the dry run's:
outputs of the right shape and dtype, nothing computed, no launch); a CUDA
tensor launches the kernel, and any build or launch failure raises. Each
wrapper counts its launches in its `launches` attribute (a plain int, reset
with `ops.reset_launch_counts`), and reports its dot FLOPs, bound
operations and scratch to `launch.cost` (`cost.counted`), from its
arguments' shapes alone, so a call costs the same on every device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.launch import cost

_SIGNED = False
_QAT_SIGNED = False

# The reference's tiles and backward scratch budget (quant_matmul.py:34-41),
# copied with the same numbers: they only decide the combined-vs-split route.
DEFAULT_TILES = (128, 128, 512)  # (bm, bn, bk)
BWD_SCRATCH_BUDGET_BYTES = 8 * 1024 * 1024
QAT_TILE = 128  # output tile edge of csrc/qat_matmul.cu (checked at load)
# its contraction rows a pipeline stage (the combined backward refuses dW
# ranges of other multiples), and the blocks of one wave its dW split aims
# at (two on each of an H100's 132 SMs; a constant, never read from the
# card, as INT4_BLOCKS)
QAT_STAGE = 32
QAT_BLOCKS = 264
# int4_matmul's tiling (csrc/quant_matmul.cu, checked at load): 128 output
# columns a block of 8 warps, 16-deep mma steps; and the blocks of one wave
# its plan aims at, two on each of an H100's 132 SMs (a constant: never read
# from the card, so the plan, and the bits, are the same on any card)
INT4_COLS, INT4_STEP, INT4_WARPS = 128, 16, 8
INT4_BLOCKS = 264
# int_matmul's output columns a block (csrc/quant_matmul.cu, checked at
# load): 128 for decode (M <= 8), 64 for prefill, whose four 8-token n-tiles
# would hold too many accumulators at 128; its steps, warps and plan are
# int4_matmul's, so the width never changes an element's sum
INT8_COLS = (128, 64)


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = build.load("quant_matmul")
    if not _SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        # x codes scale out part tickets | M K N [ldx] splits per vec | stream
        lib.int_matmul_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
        lib.int4_matmul_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.int4_matmul_tile.argtypes = []
        lib.int_matmul_tile.argtypes = []
        for fn in (lib.int_matmul_launch, lib.int4_matmul_launch, lib.int4_matmul_tile,
                   lib.int_matmul_tile):
            fn.restype = i
        if lib.int4_matmul_tile() != INT4_COLS * 1000 + INT4_STEP // 2:
            raise RuntimeError(f"quant_matmul.cu int4 tile {lib.int4_matmul_tile()} != "
                               f"({INT4_COLS}, {INT4_STEP // 2})")
        if lib.int_matmul_tile() != INT8_COLS[0] * 1000 + INT8_COLS[1]:
            raise RuntimeError(f"quant_matmul.cu int8 tile {lib.int_matmul_tile()} != "
                               f"{INT8_COLS}")
        _SIGNED = True
    return lib


def int4_plan(k: int, n: int) -> dict:
    """How `int4_matmul` and `int_matmul` cut a (K, N) weight: 128-column
    tiles (one block each, 8 warps), and the contraction into `splits`
    ranges of `ksteps_per_split` 16-deep mma steps: as many blocks as one
    wave holds (`INT4_BLOCKS`; a second, partial wave would double the
    time) where the column tiles alone leave the card idle, and at least
    one step a warp.
    A function of (K, N) only: every output element's sum order, hence its
    bits, is the same whatever M the call has."""
    col_tiles = _cdiv(n, INT4_COLS)
    ksteps = max(1, _cdiv(k, INT4_STEP))
    splits = max(1, min(INT4_BLOCKS // col_tiles, ksteps // INT4_WARPS))
    per = _cdiv(ksteps, splits)
    return {"col_tiles": col_tiles, "ksteps": ksteps, "splits": _cdiv(ksteps, per),
            "ksteps_per_split": per}


def int4_token_tiles(m: int) -> tuple[int, int]:
    """(tokens a block carries, token tiles): one 8-token mma n-tile for
    decode (M <= 8), else four. It sets only how many tokens share one
    dequantized weight tile, never an element's sum order."""
    tok = 8 if m <= 8 else 32
    return tok, _cdiv(m, tok)


def int8_col_tiles(m: int, n: int) -> int:
    """`int_matmul`'s column tiles at M rows: 128 columns a block for decode
    (M <= 8), 64 for prefill (`INT8_COLS`). The plan's splits are
    `int4_plan(K, N)`'s whatever the width."""
    return _cdiv(n, INT8_COLS[int(m > 8)])


def _plan_scratch(plan: dict, m: int, n: int, tiles: int, device, owner: str):
    """(part, tickets) for a split plan: f32 sums of each split and one
    ticket a (column tile, token tile); (None, None) with one split."""
    if plan["splits"] == 1:
        return None, None
    part = torch.empty((plan["splits"], m, n), dtype=torch.float32, device=device)
    return part, build.tickets(device, tiles * int4_token_tiles(m)[1], owner)


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


def _operands(x, codes, scale):
    """bf16 x, the codes and f32 scales, contiguous; and an empty f32 out."""
    out = torch.empty((x.shape[0], codes.shape[1]), dtype=torch.float32, device=x.device)
    return (x.to(torch.bfloat16).contiguous(), codes.contiguous(),
            scale.to(torch.float32).contiguous(), out)


def _int_figures(x, w_codes, w_col_scale) -> dict:
    """`launch.cost` figures of int_matmul / int4_matmul: 2 M K N dot FLOPs
    and the split plan's f32 partial sums."""
    (m, k), n = x.shape, w_codes.shape[1]
    splits = int4_plan(k, n)["splits"]
    return {"flops": 2.0 * m * k * n,
            "scratch": 4 * splits * m * n if splits > 1 else 0}


@cost.counted("int_matmul", _int_figures)
def int_matmul(x: torch.Tensor, w_codes: torch.Tensor,
               w_col_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(codes (K, N) int8, col_scale (N,)) -> (M, N) f32,
    on the tensor cores by `int4_plan`'s split of the contraction."""
    if ref.takes_plain(x):
        return ref.int_matmul(x, w_codes, w_col_scale)
    _check(x, w_codes, w_col_scale, x.shape[1])
    xb, codes, scale, out = _operands(x, w_codes, w_col_scale)
    (m, k), n = xb.shape, codes.shape[1]
    if k % 2 or xb.data_ptr() % 4:  # the kernel reads x in aligned bf16 pairs
        xb = torch.nn.functional.pad(xb, (0, k % 2))
    plan = int4_plan(k, n)
    part, tickets = _plan_scratch(plan, m, n, int8_col_tiles(m, n), x.device, "int_matmul")
    vec = int(n % 16 == 0 and codes.data_ptr() % 16 == 0)
    rc = _lib().int_matmul_launch(xb.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                                  out.data_ptr(), build.ptr(part), build.ptr(tickets),
                                  m, k, n, xb.shape[1], plan["splits"],
                                  plan["ksteps_per_split"], vec,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    _raise("int_matmul_launch", rc, m, k, n)
    int_matmul.launches += 1
    return out


@cost.counted("int4_matmul", _int_figures)
def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                w_col_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ dequant(packed (K/2, N) int8 nibble pairs, col_scale (N,)),
    on the tensor cores by `int4_plan`'s split of the contraction."""
    if ref.takes_plain(x):
        return ref.int4_matmul(x, w_packed, w_col_scale)
    if x.shape[-1] % 2:
        raise ValueError(f"int4_matmul needs an even K, got {x.shape[-1]}")
    _check(x, w_packed, w_col_scale, x.shape[1] // 2)
    xb, codes, scale, out = _operands(x, w_packed, w_col_scale)
    (m, k), n = xb.shape, codes.shape[1]
    plan = int4_plan(k, n)
    part, tickets = _plan_scratch(plan, m, n, plan["col_tiles"], x.device, "int4_matmul")
    vec = int(n % 16 == 0 and codes.data_ptr() % 16 == 0)
    rc = _lib().int4_matmul_launch(xb.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                                   out.data_ptr(), build.ptr(part), build.ptr(tickets),
                                   m, k, n, plan["splits"], plan["ksteps_per_split"], vec,
                                   torch.cuda.current_stream(x.device).cuda_stream)
    _raise("int4_matmul_launch", rc, m, k, n)
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
        lib.qat_fwd_tc_launch.argtypes = [p, i, p, p, p, p, i, p, p, i, p, i,
                                          i, i, i, i, i, i, i, i, p]
        lib.qat_fwd_prologue_launch.argtypes = [p, i, p, p, p, p, i, p, i, p,
                                                i, i, i, i, i, i, i, i, i, p]
        lib.qat_dx_tc_launch.argtypes = [p, i, p, p, p, p, i, p, p, p, p, p,
                                         i, p, i, i, i, i, i, i, i, i, i, p]
        lib.qat_dw_tc_launch.argtypes = [p, i, p, p, p, p, i, p, p, p, p, i,
                                         p, i, i, i, i, i, i, i, i, i, p]
        lib.qat_bwd_tc_launch.argtypes = [p, p, i, p, p, p, p, i, p, p, p, p,
                                          p, p, p, p, i, p, i, p, i, p, p, i,
                                          i, i, i, i, i, i, i, i, i, i, p]
        lib.qat_bwd_prologue_launch.argtypes = [p, p, i, p, p, p, p, i, p, i,
                                                p, i, p, i, i, i, i, i, i, i,
                                                i, i, i, p]
        for fn in (lib.qat_fwd_tc_launch, lib.qat_fwd_prologue_launch,
                   lib.qat_dx_tc_launch, lib.qat_dw_tc_launch,
                   lib.qat_bwd_tc_launch, lib.qat_bwd_prologue_launch):
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


def _fwd_tc_scratch(m: int, k: int, n: int, e: int = 1):
    """The tensor-core forward's bf16 scratch, xd (E, M, ld_x) and wd (E, K,
    ld_w) (E = 1: the 2D forward): ((ld_x, ld_w), their bytes), K and N
    rounded up to a multiple of 8 elements (16 bytes), so every row starts
    16-byte aligned; the prologue zeroes the pad."""
    lds = (_cdiv(k, 8) * 8, _cdiv(n, 8) * 8)
    return lds, (2 * e * m * lds[0], 2 * e * k * lds[1])


def _fwd_tc_scratch_tensors(lead: tuple, m: int, k: int, n: int, device):
    """xd (*lead, M, ld_x) and wd (*lead, K, ld_w); lead () or (E,)."""
    lds, _ = _fwd_tc_scratch(m, k, n)
    return tuple(torch.empty((*lead, rows, ld), dtype=torch.bfloat16, device=device)
                 for rows, ld in zip((m, k), lds))


def _fwd_tc(x, w, a_s, a_b, ws, k_side: bool, qs: dict, out=None):
    """The tensor-core forward on checked operands, x (M, K) or per expert
    (E, M, K): its prologue and tile into `out`, or (out None) the prologue
    alone. Returns the scratch (xd, wd)."""
    lead, (m, k), n = tuple(x.shape[:-2]), x.shape[-2:], w.shape[-1]
    xd, wd = _fwd_tc_scratch_tensors(lead, m, k, n, x.device)
    entry = "qat_fwd_prologue_launch" if out is None else "qat_fwd_tc_launch"
    outs = [] if out is None else [out.data_ptr()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = getattr(_qat_lib(), entry)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(), int(k_side), *outs,
        xd.data_ptr(), xd.shape[-1], wd.data_ptr(), wd.shape[-1],
        lead[0] if lead else 1, m, k, n, qs["q_n_a"], qs["q_p_a"],
        qs["q_n_w"], qs["q_p_w"], stream)
    _raise(entry, rc, m, k, n)
    return xd, wd


# ---------------------------------------------------------------------------
# `launch.cost` figures of the QAT kernels, from the arguments' shapes: the
# dot FLOPs of the math (2 M K N a product), the tensor-core operations that
# bound the call (x the cotangent's planes) and the bf16 scratch it holds
# ---------------------------------------------------------------------------

def _emkn(x, w) -> tuple:
    """(E, M, K, N) of a 2D (E = 1) or per-expert call."""
    return (x.shape[0] if x.dim() == 3 else 1), x.shape[-2], x.shape[-1], w.shape[-1]


def _fwd_figures(x, w, *_, **__) -> dict:
    e, m, k, n = _emkn(x, w)
    return {"flops": 2.0 * e * m * k * n, "scratch": sum(_fwd_tc_scratch(m, k, n, e)[1])}


def _bwd_figures(dy, x, w, *_, round_cot: bool = True, scratch_budget=None,
                 **__) -> dict:
    e, m, k, n = _emkn(x, w)
    planes = plane_count(round_cot)
    flops = 4.0 * e * m * k * n
    if bwd_route(m, k, n, scratch_budget) == "split":  # expert by expert
        return {"flops": flops, "ops": flops * planes,
                "scratch": sum(_bwd_tc_scratch(m, k, n, 1, planes)[1])}
    splits, _ = dw_splits(m, k, n, planes)
    return {"flops": flops, "ops": flops * planes,
            "scratch": sum(_bwd_tc_scratch(m, k, n, e, planes)[1])
            + (4 * e * splits * k * n if splits > 1 else 0)}


def _split_figures(dx: bool):
    def figures(dy, x, w, *_, round_cot: bool = True, **__) -> dict:
        _, m, k, n = _emkn(x, w)
        planes = plane_count(round_cot)
        xd, wd, planes_bytes = _bwd_tc_scratch(m, k, n, 1, planes)[1]
        flops = 2.0 * m * k * n
        return {"flops": flops, "ops": flops * planes,
                "scratch": planes_bytes + (wd if dx else xd)}
    return figures


@cost.counted("quant_matmul", _fwd_figures)
def quant_matmul(x, w, a_scale, a_offset, w_scale, *, q_n_a: int, q_p_a: int,
                 q_n_w: int, q_p_w: int) -> torch.Tensor:
    """q_a(x) @ q_w(w) -> (M, N) f32 (the reference's quant_matmul)."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if ref.takes_plain(x):
        return ref.quant_matmul(x, w, a_scale, a_offset, w_scale, **qs)
    x, w, a_s, a_b, ws, k_side, _ = _qat_operands(x, w, a_scale, a_offset,
                                                  w_scale)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    _fwd_tc(x, w, a_s, a_b, ws, k_side, qs, out)
    quant_matmul.launches += 1
    return out


def fwd_prologue(x, w, a_scale, a_offset, w_scale, *, q_n_a: int, q_p_a: int,
                 q_n_w: int, q_p_w: int):
    """The tensor-core forward's prologue alone: (xd, wd) as the zero-padded
    bf16 scratch that quant_matmul (x (M, K)) or quant_matmul_batched (x
    (E, M, K)) multiplies (`_fwd_tc_scratch`). A check: the training path
    reaches the prologue only inside the forwards, whose counts it adds to."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    lds, _ = _fwd_tc_scratch(*x.shape[-2:], w.shape[-1])
    if ref.takes_plain(x):
        return ref.fwd_prologue(x, w, a_scale, a_offset, w_scale, lds=lds, **qs)
    if x.dim() == 3:
        x, w, a_s, a_b, ws, _ = _batched_operands(x, w, a_scale, a_offset,
                                                  w_scale)
        k_side = False
    else:
        x, w, a_s, a_b, ws, k_side, _ = _qat_operands(x, w, a_scale, a_offset,
                                                      w_scale)
    out = _fwd_tc(x, w, a_s, a_b, ws, k_side, qs)
    fwd_prologue.launches += 1
    return out


def bwd_route(m: int, k: int, n: int, scratch_budget=None) -> str:
    """The kernels quant_matmul_bwd (and quant_matmul_bwd_batched, on the
    per-expert shape) takes for a CUDA tensor: "split" (the split dx / dw
    grids, where the reference splits), else "tc" (the combined backward);
    both on the tensor cores, the cotangent on `plane_count` planes."""
    if not bwd_uses_combined(*padded_dims(m, k, n),
                             scratch_budget=scratch_budget):
        return "split"
    return "tc"


def plane_count(round_cot: bool) -> int:
    """bf16 planes the tensor-core backward multiplies a cotangent as: 1
    (bf16(dY)) for bf16 cotangents, 3 (dY's exact split hi + mid + lo,
    `ref.cotangent_planes`) for f32 ones."""
    return 1 if round_cot else 3


def dw_splits(m: int, k: int, n: int, planes: int) -> tuple[int, int]:
    """(S, rows): how the combined backward cuts its dW contraction over M
    rows: S ranges of `rows` rows (a multiple of `QAT_STAGE`; the last range
    ends at M), one block a (range, dW tile), added in range order by the
    tile's last block. One range (rows = M) on one plane (the bf16 tiles
    keep their bits), where the grid's dX and dW tiles already fill a wave
    of `QAT_BLOCKS`, or where M <= N (a dW tile then walks no deeper than a
    dX tile); else ceil(M / N) ranges, each about a dX tile's depth N.
    A function of the (per-expert) shape only, never of the card or of the
    expert count: an expert of the batched backward cuts as the 2D backward
    does on its slices, so their bits are equal."""
    t = QAT_TILE
    tiles = _cdiv(m, t) * _cdiv(k, t) + _cdiv(k, t) * _cdiv(n, t)
    if planes == 1 or tiles >= QAT_BLOCKS or m <= n:
        return 1, m
    rows = _cdiv(_cdiv(m, _cdiv(m, n)), QAT_STAGE) * QAT_STAGE
    return _cdiv(m, rows), rows


def _bwd_tc_scratch(m: int, k: int, n: int, e: int = 1, planes: int = 1):
    """The tensor-core backward's bf16 scratch, xd (E, M, ld_x), wd (E, K,
    ld_w) and the cotangent's planes (E, planes, M, ld_y) (E = 1: the 2D
    backward): ((ld_x, ld_w, ld_y), their bytes), each leading dimension K,
    N, N rounded up to a multiple of 8 elements (16 bytes), so every row
    (and every plane and expert slice) starts 16-byte aligned; the prologue
    zeroes the pad."""
    lds = tuple(_cdiv(d, 8) * 8 for d in (k, n, n))
    return lds, (2 * e * m * lds[0], 2 * e * k * lds[1], 2 * e * planes * m * lds[2])


def _bwd_tc_scratch_tensors(lead: tuple, m: int, k: int, n: int, device,
                            planes: int = 1, xd: bool = True, wd: bool = True):
    """xd (*lead, M, ld_x), wd (*lead, K, ld_w) and the planes (*lead, M,
    ld_y) for one plane, (*lead, planes, M, ld_y) for more; lead () or (E,).
    xd / wd False: None in its place. Allocated for one call."""
    lds, _ = _bwd_tc_scratch(m, k, n)
    shapes = ((m, lds[0]) if xd else None, (k, lds[1]) if wd else None,
              (m, lds[2]) if planes == 1 else (planes, m, lds[2]))
    return tuple(None if s is None else
                 torch.empty((*lead, *s), dtype=torch.bfloat16, device=device)
                 for s in shapes)


def _dx_outputs(m: int, k: int, device):
    """(dX, dsa, dba) f32 and the scratch of each dX block's (dsa, dba)
    partials."""
    f32 = dict(dtype=torch.float32, device=device)
    t = QAT_TILE
    return ((torch.empty((m, k), **f32), torch.empty((), **f32), torch.empty((), **f32)),
            torch.empty((2 * _cdiv(m, t) * _cdiv(k, t),), **f32))


def _dw_outputs(k: int, n: int, k_side: bool, device):
    """(dW, dws) f32 and the scratch of the dws partials per row block (or,
    for row scales, per column block)."""
    f32 = dict(dtype=torch.float32, device=device)
    t = QAT_TILE
    return ((torch.empty((k, n), **f32), torch.empty((k, 1) if k_side else (1, n), **f32)),
            torch.empty((_cdiv(n, t) * k if k_side else _cdiv(k, t) * n,), **f32))


def _dw_split_scratch(lead: tuple, m: int, k: int, n: int, splits: int, device):
    """(part_s, tickets) for a dW contraction cut into `splits` ranges: the
    ranges' f32 sums (*lead, S, K, N), allocated for the call, and one
    int32 ticket a dW tile of every expert (`build.tickets`: zero, and left
    at zero by the kernel); (None, None) for one range."""
    if splits == 1:
        return None, None
    e = lead[0] if lead else 1
    part_s = torch.empty((*lead, splits, k, n), dtype=torch.float32, device=device)
    tiles = e * _cdiv(k, QAT_TILE) * _cdiv(n, QAT_TILE)
    return part_s, build.tickets(device, tiles, "qat_bwd")


def _bwd_tc(dy, x, w, a_s, a_b, ws, k_side: bool, qs: dict, round_cot: bool,
            outs: tuple, parts: tuple) -> None:
    """The combined backward on checked operands, 2D (x (M, K)) or per expert
    (x (E, M, K)), in one `qat_bwd_tc_launch` (prologue, tile, finish pass):
    into `outs` (dX, dsa, dba, dW, dws) with the scale partials `parts`
    (part_x, part_w); the cotangent on `plane_count(round_cot)` planes, the
    dW contraction cut by `dw_splits` (its (E, S, K, N) f32 sums and a
    ticket a dW tile where S > 1)."""
    lead, (m, k), n = tuple(x.shape[:-2]), x.shape[-2:], w.shape[-1]
    e = lead[0] if lead else 1
    dev = x.device
    planes = plane_count(round_cot)
    splits, rows = dw_splits(m, k, n, planes)
    scratch = _bwd_tc_scratch_tensors(lead, m, k, n, dev, planes)
    part_s, tickets = _dw_split_scratch(lead, m, k, n, splits, dev)
    rc = _qat_lib().qat_bwd_tc_launch(
        dy.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
        a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(), int(k_side),
        *(t.data_ptr() for t in outs + parts),
        *(v for t in scratch for v in (t.data_ptr(), t.shape[-1])),
        build.ptr(part_s), build.ptr(tickets), splits, rows, e, m, k, n,
        qs["q_n_a"], qs["q_p_a"], qs["q_n_w"], qs["q_p_w"], planes,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise("qat_bwd_tc_launch", rc, m, k, n)


def _split_tc(dy, x, w, a_scale, a_offset, w_scale, qs: dict, round_cot: bool,
              want_dx: bool, want_dw: bool):
    """The split backward on the tensor cores, 2D: one prologue (wd for dX,
    xd for dW, and the cotangent's planes), then the dX grid (-> dX, dsa,
    dba) and / or the dW grid (-> dW, dws), each with its finish pass."""
    x, w, a_s, a_b, ws, k_side, dy = _qat_operands(x, w, a_scale, a_offset,
                                                   w_scale, dy)
    m, k = x.shape
    n = w.shape[1]
    dev = x.device
    planes = plane_count(round_cot)
    lds, _ = _bwd_tc_scratch(m, k, n)
    xd, wd, dyb = _bwd_tc_scratch_tensors((), m, k, n, dev, planes, xd=want_dw,
                                          wd=want_dx)
    ptr = lambda s: 0 if s is None else s.data_ptr()
    head = (x.data_ptr(), int(x.dtype == torch.bfloat16), w.data_ptr(),
            a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(), int(k_side))
    tail = (m, k, n, qs["q_n_a"], qs["q_p_a"], qs["q_n_w"], qs["q_p_w"], planes,
            torch.cuda.current_stream(dev).cuda_stream)
    lib = _qat_lib()
    rc = lib.qat_bwd_prologue_launch(dy.data_ptr(), *head, ptr(xd), lds[0], ptr(wd),
                                     lds[1], dyb.data_ptr(), lds[2], 1, *tail)
    _raise("qat_bwd_prologue_launch", rc, m, k, n)
    outs = ()
    if want_dx:
        dxs, part_x = _dx_outputs(m, k, dev)
        rc = lib.qat_dx_tc_launch(*head, *(o.data_ptr() for o in dxs + (part_x,)),
                                  wd.data_ptr(), lds[1], dyb.data_ptr(), lds[2], *tail)
        _raise("qat_dx_tc_launch", rc, m, k, n)
        outs += dxs
    if want_dw:
        dws, part_w = _dw_outputs(k, n, k_side, dev)
        rc = lib.qat_dw_tc_launch(*head, *(o.data_ptr() for o in dws + (part_w,)),
                                  xd.data_ptr(), lds[0], dyb.data_ptr(), lds[2], *tail)
        _raise("qat_dw_tc_launch", rc, m, k, n)
        outs += dws
    return outs


@cost.counted("quant_matmul_dx", _split_figures(dx=True))
def quant_matmul_dx(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                    q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True):
    """(dX (M, K), dsa, dba): the backward wrt x, raw scale sums."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if ref.takes_plain(x):
        return ref.quant_matmul_dx(dy, x, w, a_scale, a_offset, w_scale,
                                   round_cot=round_cot, **qs)
    out = _split_tc(dy, x, w, a_scale, a_offset, w_scale, qs, round_cot,
                    True, False)
    quant_matmul_dx.launches += 1
    return out


@cost.counted("quant_matmul_dw", _split_figures(dx=False))
def quant_matmul_dw(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                    q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True):
    """(dW (K, N), dws (1, N) or (K, 1)): the backward wrt w."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if ref.takes_plain(x):
        return ref.quant_matmul_dw(dy, x, w, a_scale, a_offset, w_scale,
                                   round_cot=round_cot, **qs)
    out = _split_tc(dy, x, w, a_scale, a_offset, w_scale, qs, round_cot,
                    False, True)
    quant_matmul_dw.launches += 1
    return out


def _split_bwd(dy, x, w, a_scale, a_offset, w_scale, qs: dict, round_cot: bool):
    """(dX, dsa, dba, dW, dws) on the split route: the plain dx / dw for a
    CPU tensor; on the card one prologue and both grids, counted as one
    quant_matmul_dx and one quant_matmul_dw launch."""
    if ref.takes_plain(x):
        return ref.quant_matmul_bwd(dy, x, w, a_scale, a_offset, w_scale,
                                    round_cot=round_cot, **qs)
    out = _split_tc(dy, x, w, a_scale, a_offset, w_scale, qs, round_cot,
                    True, True)
    quant_matmul_dx.launches += 1
    quant_matmul_dw.launches += 1
    return out


@cost.counted("quant_matmul_bwd", _bwd_figures)
def quant_matmul_bwd(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                     q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True,
                     scratch_budget=None):
    """(dX, dsa, dba, dW, dws) in one launch (+ the prologue and the finish
    pass), or through the split dx / dw grids where the reference would
    split (vocab-wide N): the route is `bwd_route`, whose combined route is
    `bwd_uses_combined` on the reference's padded shape."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    m, k = x.shape
    if bwd_route(m, k, w.shape[1], scratch_budget) == "split":
        return _split_bwd(dy, x, w, a_scale, a_offset, w_scale, qs, round_cot)
    if ref.takes_plain(x):
        return ref.quant_matmul_bwd(dy, x, w, a_scale, a_offset, w_scale,
                                    round_cot=round_cot, **qs)
    x, w, a_s, a_b, ws, k_side, dy = _qat_operands(x, w, a_scale, a_offset,
                                                   w_scale, dy)
    n, dev = w.shape[1], x.device
    (dxs, part_x), (dws, part_w) = _dx_outputs(m, k, dev), _dw_outputs(k, n, k_side, dev)
    _bwd_tc(dy, x, w, a_s, a_b, ws, k_side, qs, round_cot, dxs + dws, (part_x, part_w))
    quant_matmul_bwd.launches += 1
    return dxs + dws


def bwd_prologue(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                 q_p_a: int, q_n_w: int, q_p_w: int, planes: int = 1):
    """The tensor-core backward's prologue alone: (xd, wd, the cotangent's
    planes) as the zero-padded bf16 scratch that quant_matmul_bwd (x (M, K))
    or quant_matmul_bwd_batched (x (E, M, K)) multiplies (`_bwd_tc_scratch`;
    planes 1, bf16(dY)), or that the split dx / dw multiply (planes 3 for
    f32 cotangents). A check: the training path reaches the prologue only
    inside those, whose counts it adds to."""
    if planes not in (1, 3):
        raise ValueError(f"planes must be 1 or 3, got {planes}")
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    m, k = x.shape[-2:]
    n = w.shape[-1]
    lds, _ = _bwd_tc_scratch(m, k, n)
    if ref.takes_plain(x):
        return ref.bwd_prologue(dy, x, w, a_scale, a_offset, w_scale, lds=lds,
                                planes=planes, **qs)
    if x.dim() == 3:
        x, w, a_s, a_b, ws, dy = _batched_operands(x, w, a_scale, a_offset,
                                                   w_scale, dy)
        k_side = False
    else:
        x, w, a_s, a_b, ws, k_side, dy = _qat_operands(x, w, a_scale, a_offset,
                                                       w_scale, dy)
    lead = tuple(x.shape[:-2])
    xd, wd, dyb = _bwd_tc_scratch_tensors(lead, m, k, n, x.device, planes)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _qat_lib().qat_bwd_prologue_launch(
        dy.data_ptr(), x.data_ptr(), int(x.dtype == torch.bfloat16),
        w.data_ptr(), a_s.data_ptr(), a_b.data_ptr(), ws.data_ptr(),
        int(k_side), xd.data_ptr(), lds[0], wd.data_ptr(), lds[1],
        dyb.data_ptr(), lds[2], lead[0] if lead else 1, m, k, n, q_n_a,
        q_p_a, q_n_w, q_p_w, planes, stream)
    _raise("qat_bwd_prologue_launch", rc, m, k, n)
    bwd_prologue.launches += 1
    return xd, wd, dyb


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


@cost.counted("quant_matmul_batched", _fwd_figures)
def quant_matmul_batched(x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                         q_p_a: int, q_n_w: int, q_p_w: int) -> torch.Tensor:
    """Per expert q_a(x[e]) @ q_w(w[e]) -> (E, M, N) f32 (the reference's
    quant_matmul_batched): x (E, M, K), w (E, K, N), a_scale / a_offset
    (E, 1), w_scale (E, N) per-expert column scales."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    if ref.takes_plain(x):
        return ref.quant_matmul_batched(x, w, a_scale, a_offset, w_scale, **qs)
    x, w, a_s, a_b, ws, _ = _batched_operands(x, w, a_scale, a_offset, w_scale)
    out = torch.empty((x.shape[0], x.shape[1], w.shape[2]), dtype=torch.float32,
                      device=x.device)
    _fwd_tc(x, w, a_s, a_b, ws, False, qs, out)
    quant_matmul_batched.launches += 1
    return out


@cost.counted("quant_matmul_bwd_batched", _bwd_figures)
def quant_matmul_bwd_batched(dy, x, w, a_scale, a_offset, w_scale, *,
                             q_n_a: int, q_p_a: int, q_n_w: int, q_p_w: int,
                             round_cot: bool = True, scratch_budget=None):
    """(dX (E, M, K), dsa (E, 1), dba (E, 1), dW (E, K, N), dws (E, N)), the
    scale sums raw, in one launch (+ the prologue and the finish pass), on
    the route `bwd_route` gives the per-expert shape: the combined backward
    ("tc", the expert on the grid), or, where the reference's combined
    kernel would not fit its scratch budget on the padded per-expert shape,
    expert by expert through the split dx / dw (the reference's fallback;
    `quant_matmul_bwd`'s split route)."""
    qs = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)
    e, m, k = x.shape
    n = w.shape[2]
    if bwd_route(m, k, n, scratch_budget) == "split":
        outs = []
        for i in range(e):
            dx_e, dsa_e, dba_e, dw_e, dws_e = _split_bwd(
                dy[i], x[i], w[i], a_scale.reshape(e)[i], a_offset.reshape(e)[i],
                w_scale[i:i + 1], qs, round_cot)
            outs.append((dx_e, dsa_e, dba_e, dw_e, dws_e[0]))
        dx, dsa, dba, dw, dws = (torch.stack(t) for t in zip(*outs))
        return dx, dsa.reshape(e, 1), dba.reshape(e, 1), dw, dws
    if ref.takes_plain(x):
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
    _bwd_tc(dy, x, w, a_s, a_b, ws, False, qs, round_cot, (dx, dsa, dba, dw, dws),
            (part_x, part_w))
    quant_matmul_bwd_batched.launches += 1
    return dx, dsa, dba, dw, dws


quant_matmul.launches = 0
quant_matmul_dx.launches = 0
quant_matmul_dw.launches = 0
quant_matmul_bwd.launches = 0
bwd_prologue.launches = 0
fwd_prologue.launches = 0
quant_matmul_batched.launches = 0
quant_matmul_bwd_batched.launches = 0
