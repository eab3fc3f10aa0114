"""Plain PyTorch versions of the CUDA kernels (the correctness contract).

Each function repeats its CUDA kernel's arithmetic with whole-tensor torch
ops: the same dequantization rule, the same casts to the compute dtype and
the same f32 accumulation, in another summation order. Every product is
written as f32 @ f32 on operands that were rounded to bf16 first:
`torch.matmul` on two bf16 tensors would round its result to bf16, and
cuBLAS may reduce a bf16 product in lower precision. The wrappers in
`quant_matmul` / `decode_attention` take these for CPU tensors; the tests
hold them against the JAX package's Pallas kernels (interpret mode), and
`chip_smoke.py` holds each CUDA kernel against them on the card. The
batched (per-expert) versions are the 2D rule with the expert's scales
broadcast over a leading expert axis. The fake-quant versions are bit-equal
to their kernels (every rounding is written out); `bin_stats_2d` sums in
f64 and rounds once.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import unpack_int4

NEG_INF = -2.0e9  # finite: a fully masked row keeps m = NEG_INF, l > 0
EPS = 1e-9        # both quantizer scales are floored here, as in the kernels


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round an f32 tensor to bf16 and back (the values a bf16 tile holds)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _act_codes(x, a_scale, a_offset, q_n: int, q_p: int):
    """Activation quantizer of the QAT kernels: u = (x - b) / max(s, 1e-9),
    q = clip(round(u)), and the dequantized bf16-valued xd = bf16(q*s + b)
    (a multiply and an add, each rounded: no fused multiply-add)."""
    s = torch.clamp(torch.as_tensor(a_scale, dtype=torch.float32,
                                    device=x.device), min=EPS)
    b = torch.as_tensor(a_offset, dtype=torch.float32, device=x.device)
    u = (x.to(torch.float32) - b) / s
    q = torch.clamp(torch.round(u), -float(q_n), float(q_p))
    return u, q, _bf16(q * s + b)


def _weight_codes(w, w_scale, q_n: int, q_p: int):
    """Weight quantizer: u = w / max(ws, 1e-9) with ws (1, N) per column or
    (K, 1) per row, q = clip(round(u)), wd = bf16(q * ws)."""
    s = torch.clamp(w_scale.to(torch.float32), min=EPS)
    u = w.to(torch.float32) / s
    q = torch.clamp(torch.round(u), -float(q_n), float(q_p))
    return u, q, _bf16(q * s)


def _in_range(u, q_n: int, q_p: int) -> torch.Tensor:
    """Eq. 6 mask on the UNCLIPPED u, as f32 0/1."""
    return ((u >= -float(q_n)) & (u <= float(q_p))).to(torch.float32)


def quant_matmul(x, w, a_scale, a_offset, w_scale, *, q_n_a: int, q_p_a: int,
                 q_n_w: int, q_p_w: int) -> torch.Tensor:
    """q_a(x) @ q_w(w) -> (M, N) f32: x (M, K) bf16 or f32, w (K, N) f32,
    a_scale / a_offset 0-d, w_scale (1, N) column or (K, 1) row scales.
    Both operands are dequantized in f32 and rounded to bf16; the products
    (exact in f32) are summed in f32."""
    _, _, xd = _act_codes(x, a_scale, a_offset, q_n_a, q_p_a)
    _, _, wd = _weight_codes(w, w_scale, q_n_w, q_p_w)
    return xd @ wd


def _cotangent(dy, round_cot: bool) -> torch.Tensor:
    """dY as the kernels read it: rounded to bf16 for a bf16 linear, kept in
    f32 for the lm head (round_cot=False)."""
    dy = dy.to(torch.float32)
    return _bf16(dy) if round_cot else dy


def quant_matmul_dx(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                    q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True):
    """Backward wrt x: (dX (M, K) f32, dsa, dba) with dsa / dba 0-d f32.

    dX = bf16(dY @ Wd^T) masked by Eq. 6 (the accumulator is rounded
    through bf16 whatever round_cot says); dsa = sum dxd * (q - mf*u) and
    dba = sum dxd * (1 - mf) are the RAW sums: the caller applies the
    gradient scale g."""
    _, _, wd = _weight_codes(w, w_scale, q_n_w, q_p_w)
    dxd = _bf16(_cotangent(dy, round_cot) @ wd.T)
    u, q, _ = _act_codes(x, a_scale, a_offset, q_n_a, q_p_a)
    mf = _in_range(u, q_n_a, q_p_a)
    return (dxd * mf, torch.sum(dxd * (q - mf * u)),
            torch.sum(dxd * (1.0 - mf)))


def quant_matmul_dw(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                    q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True):
    """Backward wrt w: (dW (K, N) f32, dws). dW = bf16(Xd^T @ dY) masked by
    Eq. 6 on w / ws; dws = sum dwd * (q - mf*u), per column (1, N) summed
    over K for column scales, per row (K, 1) summed over N for row
    scales."""
    _, _, xd = _act_codes(x, a_scale, a_offset, q_n_a, q_p_a)
    dwd = _bf16(xd.T @ _cotangent(dy, round_cot))
    u, q, _ = _weight_codes(w, w_scale, q_n_w, q_p_w)
    mf = _in_range(u, q_n_w, q_p_w)
    part = dwd * (q - mf * u)
    k_side = w_scale.shape[0] != 1
    return dwd * mf, torch.sum(part, dim=1 if k_side else 0, keepdim=True)


def quant_matmul_bwd(dy, x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                     q_p_a: int, q_n_w: int, q_p_w: int, round_cot: bool = True):
    """All five cotangents: (dX, dsa, dba, dW, dws)."""
    kw = dict(q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w,
              round_cot=round_cot)
    dx, dsa, dba = quant_matmul_dx(dy, x, w, a_scale, a_offset, w_scale, **kw)
    dw, dws = quant_matmul_dw(dy, x, w, a_scale, a_offset, w_scale, **kw)
    return dx, dsa, dba, dw, dws


def _expert_scales(a_scale, a_offset, w_scale):
    """(E, 1) activation scale / offset and (E, N) column scales as the
    broadcast shapes the 2D helpers take for (E, M, K) / (E, K, N)."""
    e = w_scale.shape[0]
    return (a_scale.reshape(e, 1, 1), a_offset.reshape(e, 1, 1),
            w_scale.reshape(e, 1, -1))


def quant_matmul_batched(x, w, a_scale, a_offset, w_scale, *, q_n_a: int,
                         q_p_a: int, q_n_w: int, q_p_w: int) -> torch.Tensor:
    """Per expert q_a(x[e]) @ q_w(w[e]) -> (E, M, N) f32: x (E, M, K) bf16
    or f32, w (E, K, N) f32, a_scale / a_offset (E, 1), w_scale (E, N)."""
    s_a, b_a, s_w = _expert_scales(a_scale, a_offset, w_scale)
    _, _, xd = _act_codes(x, s_a, b_a, q_n_a, q_p_a)
    _, _, wd = _weight_codes(w, s_w, q_n_w, q_p_w)
    return xd @ wd


def quant_matmul_bwd_batched(dy, x, w, a_scale, a_offset, w_scale, *,
                             q_n_a: int, q_p_a: int, q_n_w: int, q_p_w: int,
                             round_cot: bool = True):
    """Per-expert backward: (dX (E, M, K), dsa (E, 1), dba (E, 1),
    dW (E, K, N), dws (E, N)), all f32, the scale sums raw; each expert's
    five are `quant_matmul_bwd`'s on that expert's operands."""
    s_a, b_a, s_w = _expert_scales(a_scale, a_offset, w_scale)
    cot = _cotangent(dy, round_cot)
    u, q, xd = _act_codes(x, s_a, b_a, q_n_a, q_p_a)
    uw, qw, wd = _weight_codes(w, s_w, q_n_w, q_p_w)
    dxd = _bf16(cot @ wd.transpose(1, 2))
    mf = _in_range(u, q_n_a, q_p_a)
    dsa = torch.sum(dxd * (q - mf * u), dim=(1, 2)).reshape(-1, 1)
    dba = torch.sum(dxd * (1.0 - mf), dim=(1, 2)).reshape(-1, 1)
    dwd = _bf16(xd.transpose(1, 2) @ cot)
    mfw = _in_range(uw, q_n_w, q_p_w)
    dws = torch.sum(dwd * (qw - mfw * uw), dim=1)
    return dxd * mf, dsa, dba, dwd * mfw, dws


def int_matmul(x: torch.Tensor, w_codes: torch.Tensor,
               w_col_scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ bf16(codes (K, N) * max(col_scale (N,), 1e-9)) -> (M, N) f32.

    The kernel's rule (quant_matmul.py int_matmul in the JAX package): the
    weight is dequantized in f32 and rounded once to bf16, x is rounded to
    bf16, and the bf16 x bf16 products (exact in f32) are summed in f32.
    """
    s = torch.clamp(w_col_scale.to(torch.float32), min=1e-9)
    wd = (w_codes.to(torch.float32) * s).to(torch.bfloat16)
    return torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                        wd.to(torch.float32))


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                w_col_scale: torch.Tensor) -> torch.Tensor:
    """int_matmul over nibble-packed codes: w_packed (K/2, N) int8, byte p
    holding row 2p in the low nibble and row 2p+1 in the high nibble."""
    return int_matmul(x, unpack_int4(w_packed, 0), w_col_scale)


def dequant_kv(store: torch.Tensor, scale, head_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """(B, T, Hkv, D or D/2) cache bytes (+ (B, T, Hkv, 1) f32 scales) ->
    (B, T, Hkv, D) values in `dtype`: f32(code) * scale rounded once."""
    if scale is None:
        return store.to(dtype)
    codes = unpack_int4(store, -1) if store.shape[-1] * 2 == head_dim else store
    return (codes.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def pooled_decode_attention(q, k_store, v_store, k_scale, v_scale, kv_pos,
                            q_pos, *, q_per_kv: int, window: int,
                            softcap: float):
    """Flash-decode over the pooled cache in one pass; returns (acc, m, l).

    q (B, C, H, D); k/v_store (B, T, Hkv, D) fp values or int8 codes, last
    axis D/2 when nibble-packed; k/v_scale (B, T, Hkv, 1) f32 or None;
    kv_pos (B, T) int (-1 = idle row); q_pos (B, C) int. acc (B, C, H, D) is
    the UNNORMALIZED f32 output, m / l (B, C, H) f32 the row max and sum.
    Queries are pre-scaled by D**-0.5 in f32 and cast back to q.dtype, the
    compute dtype: K/V are dequantized into it and P is cast to it before PV.
    """
    b, c, h, d = q.shape
    hkv = h // q_per_kv
    cd = q.dtype
    qs = (q.to(torch.float32) * d ** -0.5).to(cd)
    k = dequant_kv(k_store, k_scale, d, cd)
    v = dequant_kv(v_store, v_scale, d, cd)
    q5 = qs.reshape(b, c, hkv, q_per_kv, d).to(torch.float32)
    s = torch.einsum("bqhgd,bthd->bhgqt", q5, k.to(torch.float32))
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    kp = kv_pos[:, None, :].to(torch.int64)
    qp = q_pos[:, :, None].to(torch.int64)
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid &= kp > (qp - window)
    s = torch.where(valid[:, None, None], s, NEG_INF)  # (B, Hkv, g, C, T)
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bhgqt,bthd->bqhgd", p.to(cd).to(torch.float32),
                       v.to(torch.float32))
    m = m.permute(0, 3, 1, 2).reshape(b, c, h)
    l = l.permute(0, 3, 1, 2).reshape(b, c, h)
    return acc.reshape(b, c, h, d), m, l


def _fma_f32(q: torch.Tensor, s: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32(q * s + b) rounded once, as a fused multiply-add: the reference's
    TPU kernel rounds `xq * s + b` once (XLA fuses the two). q holds integers
    with |q| <= 255 and s an f32, so q * s is exact in f64; the f64 sum is
    made round-to-odd (its error, by TwoSum, pushes an even result to the odd
    neighbour), which makes its rounding to f32 the correctly rounded one."""
    p = q.to(torch.float64) * s.to(torch.float64)
    bb = b.to(torch.float64).expand_as(p)
    t = p + bb
    bv = t - p
    err = (p - (t - bv)) + (bb - bv)
    even = (t.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    t = torch.where((err != 0) & even, torch.nextafter(t, toward), t)
    return t.to(torch.float32)


def fake_quant_2d(x: torch.Tensor, scale, offset=None, *, q_n: int,
                  q_p: int) -> torch.Tensor:
    """Per-tensor Eq. 5 forward of x (M, N) f32 or bf16 -> x's dtype:
    u = (x - b) / max(s, 1e-9) (IEEE division), q = clip(round(u)) with
    round half to even, y = q * s + b rounded once; without an offset
    y = q * s (the reference kernel's "+ 0" is dropped by XLA, so -0 stays)."""
    x32 = x.to(torch.float32)
    s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                    device=x.device), min=EPS)
    if offset is None:
        q = torch.clamp(torch.round(x32 / s), -float(q_n), float(q_p))
        return (q * s).to(x.dtype)
    b = torch.as_tensor(offset, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round((x32 - b) / s), -float(q_n), float(q_p))
    return _fma_f32(q, s, b).to(x.dtype)


def fake_quant_rows(x: torch.Tensor, row_scale: torch.Tensor, *, q_n: int,
                    q_p: int) -> torch.Tensor:
    """Eq. 5 forward of x (M, N) with one scale a row, row_scale (M, 1),
    no offset: y = clip(round(x / s)) * s, in x's dtype."""
    s = torch.clamp(row_scale.to(torch.float32), min=EPS)
    q = torch.clamp(torch.round(x.to(torch.float32) / s), -float(q_n),
                    float(q_p))
    return (q * s).to(x.dtype)


def bin_stats_2d(w: torch.Tensor, scale, *, q_n: int, q_p: int) -> torch.Tensor:
    """(3, n_bins) f32 [count, sum, sum of squares] of w over the bins of
    code = clip(round(w / max(s, 1e-9)), -Q_N, Q_P) + Q_N (per-tensor s).
    Accumulated by index_add_ in f64 (w * w exact there) and rounded once,
    without the reference oracle's (elements x bins) one-hot."""
    w32 = w.reshape(-1).to(torch.float32)
    s = torch.clamp(torch.as_tensor(scale, dtype=torch.float32,
                                    device=w.device), min=EPS)
    codes = (torch.clamp(torch.round(w32 / s), -float(q_n), float(q_p))
             .to(torch.int64) + q_n)
    wd = w32.to(torch.float64)
    out = torch.zeros((3, q_n + q_p + 1), dtype=torch.float64, device=w.device)
    out[0].index_add_(0, codes, torch.ones_like(wd))
    out[1].index_add_(0, codes, wd)
    out[2].index_add_(0, codes, wd * wd)
    return out.to(torch.float32)
