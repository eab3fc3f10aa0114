"""Plain PyTorch versions of the serving kernels (the correctness contract).

Each function repeats its CUDA kernel's arithmetic with whole-tensor torch
ops: the same dequantization rule, the same casts to the compute dtype and
the same f32 accumulation, in another summation order. The wrappers in
`quant_matmul` / `decode_attention` take these for CPU tensors; the tests
hold them against the JAX package's Pallas kernels (interpret mode), and
`chip_smoke.py` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import unpack_int4

NEG_INF = -2.0e9  # finite: a fully masked row keeps m = NEG_INF, l > 0


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
