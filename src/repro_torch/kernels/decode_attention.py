"""Flash-decode attention over the pooled KV cache: wrapper of
`csrc/decode_attention.cu`.

Replaces the JAX package's Pallas kernel `pooled_decode_attention`
(src/repro/kernels/decode_attention.py:137). KV codes are read as stored
(fp values, int8 codes, or int4 codes nibble-packed along head_dim) with
per-(slot, token, head) scales; the pos >= 0 / pos <= q_pos / ring-window
masks come from the pool's `pos` rows inside the kernel; GQA runs as
(Hkv, C * q_per_kv) query rows per kv head. The call returns the
UNNORMALIZED (acc, m, l) so `attend_chunk` can merge the chunk's own keys.

A CPU tensor takes the plain version in `kernels/ref.py`; a CUDA tensor
launches the kernel, and a build or launch failure raises. Launches are
counted in `pooled_decode_attention.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

NEG_INF = ref.NEG_INF
MAX_ROWS_PER_BLOCK = 64
SMEM_LIMIT = 227 * 1024  # bytes of shared memory one H100 block may use

_KV_KIND = {torch.bfloat16: 0, torch.float32: 1}
_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = build.load("decode_attention")
    if not _SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v ks vs pos qpos acc m l | B T Hkv G D GT kind q_bf16 window
        lib.decode_attention_launch.argtypes = (
            [p] * 10 + [i] * 9 + [ctypes.c_float, p])
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_smem_bytes.argtypes = [i, i]
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        _SIGNED = True
    return lib


def _rows_per_block(lib, g: int, d: int) -> int:
    gt = min(g, MAX_ROWS_PER_BLOCK)
    while gt > 1 and lib.decode_attention_smem_bytes(gt, d) > SMEM_LIMIT:
        gt //= 2
    if lib.decode_attention_smem_bytes(gt, d) > SMEM_LIMIT:
        raise ValueError(f"head_dim {d} does not fit the kernel's shared memory")
    return gt


def pooled_decode_attention(q, k_store, v_store, k_scale, v_scale, kv_pos,
                            q_pos, *, q_per_kv: int, window: int,
                            softcap: float):
    """Flash-decode over the pooled cache; returns partial reductions.

    q:        (B, C, H, D) bf16 or f32 queries, the compute dtype. Scaled
              by D**-0.5 in f32 here and cast back, like the fallback.
    k_store:  (B, T, Hkv, D) fp values, or int8 code bytes with the last
              axis D (int8) or D/2 (nibble-packed int4).
    k_scale:  (B, T, Hkv, 1) f32 scales, or None for the fp cache.
    kv_pos:   (B, T) int32 absolute positions, -1 = idle/unwritten row.
    q_pos:    (B, C) int32 query positions, -1 = padding query.

    Returns (acc (B, C, H, D), m (B, C, H), l (B, C, H)), all f32.
    """
    if q.device.type == "cpu":
        return ref.pooled_decode_attention(
            q, k_store, v_store, k_scale, v_scale, kv_pos, q_pos,
            q_per_kv=q_per_kv, window=window, softcap=softcap)
    b, c, h, d = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"decode attention kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"q must be bf16 or f32, got {q.dtype}")
    if h % q_per_kv:
        raise ValueError(f"{h} heads not divisible by q_per_kv={q_per_kv}")
    hkv = h // q_per_kv
    t = k_store.shape[1]
    quantized = k_scale is not None
    if quantized:
        if k_store.dtype != torch.int8 or v_store.dtype != torch.int8:
            raise TypeError("quantized cache stores int8 code bytes")
        packed = k_store.shape[-1] * 2 == d
        kind = 3 if packed else 2
    else:
        if k_store.dtype not in _KV_KIND or v_store.dtype != k_store.dtype:
            raise TypeError(f"fp cache must be bf16 or f32, got {k_store.dtype}")
        packed = False
        kind = _KV_KIND[k_store.dtype]
    ds = d // 2 if packed else d
    for name, tsr in (("k_store", k_store), ("v_store", v_store)):
        if tuple(tsr.shape) != (b, t, hkv, ds) or tsr.device != q.device:
            raise ValueError(f"{name} {tuple(tsr.shape)} on {tsr.device}: want "
                             f"{(b, t, hkv, ds)} on {q.device}")
    if tuple(kv_pos.shape) != (b, t) or tuple(q_pos.shape) != (b, c):
        raise ValueError(f"kv_pos {tuple(kv_pos.shape)} / q_pos "
                         f"{tuple(q_pos.shape)}: want {(b, t)} / {(b, c)}")

    g = c * q_per_kv
    qs = (q.to(torch.float32) * d ** -0.5).to(q.dtype)
    q5 = qs.reshape(b, c, hkv, q_per_kv, d).permute(0, 2, 1, 3, 4)
    q5 = q5.reshape(b, hkv, g, d).contiguous()
    qp = torch.repeat_interleave(q_pos.to(torch.int32), q_per_kv, dim=1).contiguous()
    pos = kv_pos.to(torch.int32).contiguous()
    k_store = k_store.contiguous()
    v_store = v_store.contiguous()
    if quantized:
        ks = k_scale.reshape(b, t, hkv).to(torch.float32).contiguous()
        vs = v_scale.reshape(b, t, hkv).to(torch.float32).contiguous()
        ks_ptr, vs_ptr = ks.data_ptr(), vs.data_ptr()
    else:
        ks_ptr = vs_ptr = None
    acc = torch.empty((b, hkv, g, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, g), dtype=torch.float32, device=q.device)
    lib = _lib()
    gt = _rows_per_block(lib, g, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.decode_attention_launch(
        q5.data_ptr(), k_store.data_ptr(), v_store.data_ptr(), ks_ptr, vs_ptr,
        pos.data_ptr(), qp.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), b, t, hkv, g, d, gt, kind, int(q.dtype == torch.bfloat16),
        int(window), float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_launch failed: cudaError {rc} "
                           f"(B={b}, T={t}, Hkv={hkv}, G={g}, D={d})")
    pooled_decode_attention.launches += 1
    # (B, Hkv, C*q_per_kv, ...) rows back to the (B, C, H, ...) layout
    acc = acc.reshape(b, hkv, c, q_per_kv, d).permute(0, 2, 1, 3, 4)
    m = m.reshape(b, hkv, c, q_per_kv).permute(0, 2, 1, 3)
    l = l.reshape(b, hkv, c, q_per_kv).permute(0, 2, 1, 3)
    return acc.reshape(b, c, h, d), m.reshape(b, c, h), l.reshape(b, c, h)


pooled_decode_attention.launches = 0
