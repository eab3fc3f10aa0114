"""Flash-decode attention over the pooled KV cache: wrapper of
`csrc/decode_attention.cu`.

Replaces the JAX package's Pallas kernel `pooled_decode_attention`
(src/repro/kernels/decode_attention.py:137). KV codes are read as stored
(fp values, int8 codes, or int4 codes nibble-packed along head_dim) with
per-(slot, token, head) scales; the pos >= 0 / pos <= q_pos / ring-window
masks come from the pool's `pos` rows inside the kernel; GQA runs as
(Hkv, C * q_per_kv) query rows per kv head. The call returns the
UNNORMALIZED (acc, m, l) so `attend_chunk` can merge the chunk's own keys.

The kernel splits the key walk across blocks by `decode_plan`: splits of
`KV_SPLIT` keys from key 0 whatever the call (so a row's bits depend only on
its own keys, not on the pool's size or its other slots), merged in split
order by the last block of each (slot, kv head, row tile) to finish. bf16
queries run QK^T and P.V on the tensor cores; f32 queries on f32 FMAs.

A CPU tensor takes the plain version in `kernels/ref.py`, and so does a
meta tensor (shapes only); a CUDA tensor launches the kernel, and a build or
launch failure raises. Launches are counted in
`pooled_decode_attention.launches`; `launch.cost` counts a call as one op
of 4 B C H T D dot FLOPs (QK^T and P.V over every cache row).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.launch import cost

NEG_INF = ref.NEG_INF
KV_SPLIT = 64  # keys of a split (csrc/decode_attention.cu KS, checked at load)
SMEM_LIMIT = 227 * 1024  # bytes of shared memory one H100 block may use

_KV_KIND = {torch.bfloat16: 0, torch.float32: 1}
_SIGNED = False


def _lib() -> ctypes.CDLL:
    global _SIGNED
    lib = build.load("decode_attention")
    if not _SIGNED:
        p, i = ctypes.c_void_p, ctypes.c_int
        # q k v ks vs pos qpos acc m l part_acc part_ml tickets | B T C Hkv
        # qpk D GT kind q_bf16 window | qscale softcap stream
        lib.decode_attention_launch.argtypes = (
            [p] * 13 + [i] * 10 + [ctypes.c_float] * 2 + [p])
        lib.decode_attention_launch.restype = i
        lib.decode_attention_smem_bytes.argtypes = [i, i, i]
        lib.decode_attention_smem_bytes.restype = ctypes.c_longlong
        lib.decode_attention_split.argtypes = []
        lib.decode_attention_split.restype = i
        if lib.decode_attention_split() != KV_SPLIT:
            raise RuntimeError(f"decode_attention.cu split {lib.decode_attention_split()} "
                               f"!= KV_SPLIT {KV_SPLIT}")
        _SIGNED = True
    return lib


def _require_cuda(device) -> None:
    if device.type != "cuda":
        raise ValueError(f"decode attention kernel needs CUDA tensors, got {device}")


def decode_plan(t: int, g: int, q_bf16: bool, max_rows: int = 32) -> dict:
    """How the kernel cuts a call: `splits` of KV_SPLIT keys over the T
    cache rows (a function of T alone: the split boundaries sit at fixed
    keys, so idle rows past the live keys only add wholly masked splits,
    which the merge skips), and tiles of `rows` query rows of a kv head (for
    bf16 a multiple of 16, a warp's mma rows), which no row's sum order
    depends on. A block is 128 threads either way. Tiles of 32 rows beat 64
    at a 32-token prefill chunk on the card: twice the blocks, each merging
    half the rows."""
    step = 16 if q_bf16 else 1
    rows = min(max_rows, -(-g // step) * step)
    return {"splits": -(-t // KV_SPLIT), "rows": rows, "row_tiles": -(-g // rows)}


def _plan(lib, t: int, g: int, d: int, q_bf16: bool) -> dict:
    """`decode_plan`, with fewer rows a tile where head_dim needs the room."""
    plan = decode_plan(t, g, q_bf16)
    smem = lambda pl: lib.decode_attention_smem_bytes(pl["rows"], d, int(q_bf16))
    while plan["rows"] > (16 if q_bf16 else 1) and smem(plan) > SMEM_LIMIT:
        plan = decode_plan(t, g, q_bf16, max_rows=plan["rows"] // 2)
    if smem(plan) > SMEM_LIMIT:
        raise ValueError(f"head_dim {d} does not fit the kernel's shared memory")
    return plan


def _figures(q, k_store, *_, q_per_kv: int, **__) -> dict:
    """`launch.cost` figures: QK^T and P.V over the T cache rows, and the
    splits' f32 partial triples where T spans more than one split."""
    b, c, h, d = q.shape
    t = k_store.shape[1]
    splits = -(-t // KV_SPLIT)
    scratch = 4 * b * (h // q_per_kv) * splits * c * q_per_kv * (d + 2)
    return {"flops": 4.0 * b * c * h * t * d, "scratch": scratch if splits > 1 else 0}


@cost.counted("pooled_decode_attention", _figures)
def pooled_decode_attention(q, k_store, v_store, k_scale, v_scale, kv_pos,
                            q_pos, *, q_per_kv: int, window: int,
                            softcap: float, parts: bool = False):
    """Flash-decode over the pooled cache; returns partial reductions.

    q:        (B, C, H, D) bf16 or f32 queries, the compute dtype. Scaled
              by D**-0.5 in f32 in the kernel and cast back, as the plain
              version does.
    k_store:  (B, T, Hkv, D) fp values, or int8 code bytes with the last
              axis D (int8) or D/2 (nibble-packed int4).
    k_scale:  (B, T, Hkv, 1) f32 scales, or None for the fp cache.
    kv_pos:   (B, T) int32 absolute positions, -1 = idle/unwritten row.
    q_pos:    (B, C) int32 query positions, -1 = padding query.

    Returns (acc (B, C, H, D), m (B, C, H), l (B, C, H)), all f32. With
    `parts`, each KV_SPLIT-key split's own triple before the kernel's merge,
    stacked in split order on a leading axis (S, ...): a sequence-sharded
    cache merges every rank's splits in one pass, as the kernel merges its
    own (`models.attention.merge_partials`).
    """
    if ref.takes_plain(q):
        kw = dict(q_per_kv=q_per_kv, window=window, softcap=softcap)
        if not parts:
            return ref.pooled_decode_attention(
                q, k_store, v_store, k_scale, v_scale, kv_pos, q_pos, **kw)
        cut = lambda x, s: None if x is None else x[:, s:s + KV_SPLIT]
        outs = [ref.pooled_decode_attention(
            q, cut(k_store, s), cut(v_store, s), cut(k_scale, s), cut(v_scale, s),
            cut(kv_pos, s), q_pos, **kw) for s in range(0, k_store.shape[1], KV_SPLIT)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))
    b, c, h, d = q.shape
    _require_cuda(q.device)
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
    q_bf16 = q.dtype == torch.bfloat16
    if d % (16 if q_bf16 else 4):  # bf16: the mma tiles; f32: 16-byte rows
        raise ValueError(f"head_dim {d} is not a multiple of {16 if q_bf16 else 4}")
    if t == 0:
        raise ValueError("the cache has no rows")
    q = q.contiguous()
    qp = q_pos.to(torch.int32).contiguous()
    pos = kv_pos.to(torch.int32).contiguous()
    k_store = k_store.contiguous()
    v_store = v_store.contiguous()
    ks = vs = None
    if quantized:
        ks = k_scale.reshape(b, t, hkv).to(torch.float32).contiguous()
        vs = v_scale.reshape(b, t, hkv).to(torch.float32).contiguous()
    acc = torch.empty((b, c, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, c, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, c, h), dtype=torch.float32, device=q.device)
    lib = _lib()
    plan = _plan(lib, t, g, d, q_bf16)
    part_acc = part_ml = tickets = None
    if plan["splits"] > 1:  # each split's triple, and the row tiles' tickets
        part_acc = torch.empty((b * hkv, plan["splits"], g, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b * hkv, plan["splits"], g, 2), dtype=torch.float32,
                              device=q.device)
        tickets = build.tickets(q.device, b * hkv * plan["row_tiles"], "decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    # queries scale by D**-0.5 in f32 inside the kernel, then round to q's
    # dtype, as the plain version does
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_store.data_ptr(), v_store.data_ptr(), build.ptr(ks),
        build.ptr(vs), pos.data_ptr(), qp.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), build.ptr(part_acc), build.ptr(part_ml), build.ptr(tickets), b, t,
        c, hkv, q_per_kv, d,
        plan["rows"], kind, int(q_bf16), int(window), d ** -0.5, float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention_launch failed: cudaError {rc} "
                           f"(B={b}, T={t}, Hkv={hkv}, G={g}, D={d})")
    pooled_decode_attention.launches += 1
    if not parts:
        return acc, m, l
    if part_acc is None:  # one split: the outputs are its triple
        return acc[None], m[None], l[None]
    # (B Hkv, S, G = C qpk, ...) -> (S, B, C, H, ...): row g of kv head j is
    # chunk token g // qpk, head j qpk + g % qpk
    ns = plan["splits"]
    pa = part_acc.view(b, hkv, ns, c, q_per_kv, d).permute(2, 0, 3, 1, 4, 5)
    pm = part_ml.view(b, hkv, ns, c, q_per_kv, 2).permute(2, 0, 3, 1, 4, 5)
    pm = pm.reshape(ns, b, c, h, 2)
    return pa.reshape(ns, b, c, h, d), pm[..., 0], pm[..., 1]


pooled_decode_attention.launches = 0
