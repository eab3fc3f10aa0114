"""Attention: full-sequence (training / prefill) attention, the pooled KV
cache and chunked/cached attention.

PyTorch counterpart of `repro.models.attention`:
  * `attend_full` / `attend_local_chunked` are the training path, written
    as the JAX package's einsum composition (scores summed in f32, P cast to
    V's dtype), not as SDPA, so the tests compare like with like.
  * `KVCache` holds fp K/V, or int8 codes (nibble-packed along head_dim at
    <= 4 bits with an even head_dim) with per-(slot, token, head) scales,
    plus the absolute position stored in each row (-1 = empty).
  * `cache_append_chunk` writes IN PLACE into the cache's tensors (the JAX
    version returns a new cache); entries with pos < 0 are dropped by
    selecting the kept entries first (`append_rows`), since `index_put_`
    would reject the out-of-range slot the JAX scatter drops with
    mode="drop".
  * `attend_chunk` / `attend_decode` attend against the cache ∪ the chunk's
    own keys; with the kernel route on, the cached side is one flash-decode
    kernel call and the chunk's keys are merged with one more online-softmax
    step. Masked scores use the finite NEG_INF, so fully masked rows stay
    NaN-free.
  * A sequence-sharded cache (`seq`, a `dist.spmd.SeqSplit`: this rank
    holds rows [index T, (index + 1) T) of a cache of parts x T rows):
    `attend_chunk` runs the kernel over this rank's rows, all-gathers each
    key split's (acc, m, l) triple over the model ranks and merges them all
    in one pass in rank order, as the kernel merges its key splits
    (`merge_partials`: bit-equal to the whole cache's kernel call where each
    rank holds whole splits), then merges the chunk keys as before; the
    unfused route all-gathers the slices first.
    `local_rows` keeps the appended rows this rank holds. The cache holds
    every head of its rows: a tensor-parallel attention (heads split over
    the model ranks, `models.model.block_decode`) gathers its q, k and v
    over heads before `attend_chunk` and keeps its own heads of the
    output; the training path (`attend_full`) runs on the local heads.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.policy import QuantConfig, kv_cache_spec
from repro_torch.core.quantizer import pack_int4, unpack_int4
from repro_torch.kernels.decode_attention import pooled_decode_attention
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.common import rope as rope_apply  # noqa: F401 (re-export)

NEG_INF = -2.0e9  # mask value kept finite to avoid NaN in padded softmax rows


def _softcap(scores: torch.Tensor, cap: float) -> torch.Tensor:
    if cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def _use_fused_attention(qcfg: QuantConfig, q: torch.Tensor) -> bool:
    """Mirror of common._use_fused for the decode-attention kernel."""
    if qcfg.fused_attention == "off":
        return False
    if qcfg.fused_attention == "on" and q.device.type != "cuda":
        raise ValueError("fused_attention='on' needs CUDA tensors (there is "
                         f"no kernel off the GPU); got {q.device}")
    return True


def _einsum_f64(eq: str, a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """einsum summed in f64 and rounded once to `dtype`: exact far below
    f32's ulp whatever order the library sums in, so a row's bits do not
    depend on how many rows share the call (the engine's stream contract).
    JAX sums these in f32; the two differ by rounding only."""
    return torch.einsum(eq, a.to(torch.float64), b.to(torch.float64)).to(dtype)


def _grouped_scores(q: torch.Tensor, k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, C, H, D) x un-repeated (B, T, Hkv, D) -> (B, H, C, T) f32 scores
    (JAX's preferred_element_type=f32). GQA regroups queries as
    (B, C, Hkv, q_per_kv, D); no repeat_kv."""
    b, c, h, d = q.shape
    hkv = k.shape[2]
    q5 = q.reshape(b, c, hkv, h // hkv, d)
    s = _einsum_f64("bqhgd,bthd->bhgqt", q5, k, torch.float32)
    return s.reshape(b, h, c, k.shape[1])


def _grouped_pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, H, C, T) probs x un-repeated (B, T, Hkv, D) -> (B, C, H, D), in
    the operands' promoted dtype."""
    b, h, c, t = p.shape
    hkv = v.shape[2]
    p5 = p.reshape(b, hkv, h // hkv, c, t)
    o = _einsum_f64("bhgqt,bthd->bqhgd", p5, v,
                    torch.promote_types(p.dtype, v.dtype))
    return o.reshape(b, c, h, v.shape[3])


def _chunk_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A training-attention product, f32: on the CPU summed in f64 and
    rounded once (`_einsum_f64`), because torch's CPU f32 kernels sum in an
    order that depends on the batching (a GQA group's g query rows against
    one kv head, or one row each against repeated heads); on the card
    summed in f32, as JAX sums it."""
    if a.device.type == "cpu":
        return _einsum_f64(eq, a, b, torch.float32)
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _chunk_attend(qi, kt, vt, mask, softcap: float):
    """One query chunk: qi (B, Hkv, g, nq, D) against kt (B, Hkv, D, Sk) and
    vt (B, Hkv, Sk, D) under mask (nq, Sk). Scores are f32 from queries
    pre-scaled by D**-0.5 in f32 and cast back; P is cast to V's dtype and
    the PV product rounded to f32, then to V's dtype (`_chunk_product`)."""
    d = qi.shape[-1]
    qs = (qi.to(torch.float32) * d ** -0.5).to(qi.dtype)
    s = _chunk_product("bhgqd,bhdk->bhgqk", qs, kt)
    s = _softcap(s, softcap)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _chunk_product("bhgqk,bhkd->bhgqd", p.to(vt.dtype), vt)
    return o.to(vt.dtype)


def _query_chunks(sq: int, chunk_q: int) -> int:
    nq = max(1, min(chunk_q, sq))
    while sq % nq:
        nq //= 2
    return nq


def attend_full(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool, window: int, softcap: float,
                q_positions: torch.Tensor, k_positions: torch.Tensor,
                chunk_q: int = 512, q_per_kv: int = 1) -> torch.Tensor:
    """Softmax attention over query chunks of at most `chunk_q` rows.

    q: (B, Sq, H, D); k, v: (B, Sk, Hkv, D) un-repeated (GQA as a grouped
    einsum over (Hkv, q_per_kv)); q_positions (Sq,), k_positions (Sk,)
    absolute positions for masking; window > 0 limits attention to k_pos
    in (q_pos - window, q_pos]. Returns (B, Sq, H, D) in v's dtype.
    """
    b, sq, h, d = q.shape
    hkv = h // q_per_kv
    if k.shape[2] != hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} vs q_per_kv {q_per_kv}")
    nq = _query_chunks(sq, chunk_q)
    qc = q.reshape(b, sq // nq, nq, hkv, q_per_kv, d).permute(1, 0, 3, 4, 2, 5)
    kt = k.permute(0, 2, 3, 1)  # (B, Hkv, D, Sk)
    vt = v.permute(0, 2, 1, 3)  # (B, Hkv, Sk, D)
    outs = []
    for ci in range(sq // nq):
        qpos = q_positions[ci * nq:(ci + 1) * nq]
        mask = torch.ones((nq, k_positions.shape[0]), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= k_positions[None, :] <= qpos[:, None]
        if window > 0:
            mask &= k_positions[None, :] > (qpos[:, None] - window)
        outs.append(_chunk_attend(qc[ci], kt, vt, mask, softcap))
    out = torch.stack(outs)  # (C, B, Hkv, g, nq, D)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, d)


def attend_local_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         window: int, softcap: float, chunk_q: int = 512,
                         q_per_kv: int = 1) -> torch.Tensor:
    """Sliding-window causal attention with kv-span slicing (positions
    0..S-1 on both sides): each query chunk attends to a span of at most
    window + chunk keys, so compute and memory are O(S * (window + chunk))."""
    b, s, h, d = q.shape
    hkv = h // q_per_kv
    if k.shape[2] != hkv:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} vs q_per_kv {q_per_kv}")
    nq = _query_chunks(s, chunk_q)
    span = min(s, window + nq)
    qc = q.reshape(b, s // nq, nq, hkv, q_per_kv, d).permute(1, 0, 3, 4, 2, 5)
    kp = k.permute(0, 2, 1, 3)  # (B, Hkv, Sk, D)
    vp = v.permute(0, 2, 1, 3)
    outs = []
    for ci in range(s // nq):
        start = min(max(ci * nq + nq - span, 0), s - span)
        ks = kp[:, :, start:start + span]
        vs = vp[:, :, start:start + span]
        qpos = ci * nq + torch.arange(nq, device=q.device)
        kpos = start + torch.arange(span, device=q.device)
        mask = ((kpos[None, :] <= qpos[:, None])
                & (kpos[None, :] > qpos[:, None] - window))
        outs.append(_chunk_attend(qc[ci], ks.transpose(2, 3), vs, mask,
                                  softcap))
    out = torch.stack(outs)
    return out.permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, d)


# ---------------------------------------------------------------------------
# KV cache (decode), optional int-quantized storage
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Either fp (k, v) or quantized (k/v codes + per-(b,t,h) scales).

    At kv_cache_bits <= 4 with an even head_dim, codes are nibble-packed
    two-per-byte along head_dim (k/v carry (B, T, Hkv, D/2) int8 bytes,
    quantizer.pack_int4 interleave); odd head_dim keeps one byte a code.
    """
    k: torch.Tensor               # fp (B,T,Hkv,D) or int8 code bytes
    v: torch.Tensor
    k_scale: Optional[torch.Tensor]  # (B,T,Hkv,1) f32, None for fp cache
    v_scale: Optional[torch.Tensor]
    pos: torch.Tensor             # (B,T) int32 positions stored (-1 = empty)


def kv_packed(qcfg: QuantConfig, head_dim: int) -> bool:
    """True when the cache stores nibble-packed KV bytes."""
    spec = kv_cache_spec(qcfg)
    return spec is not None and spec.bits <= 4 and head_dim % 2 == 0


def init_kv_cache(qcfg: QuantConfig, batch: int, max_len: int, n_kv: int,
                  head_dim: int, cdtype=torch.bfloat16, device=None) -> KVCache:
    device = resolve_device(device)
    spec = kv_cache_spec(qcfg)
    pos = torch.full((batch, max_len), -1, dtype=torch.int32, device=device)
    if spec is None:
        shape = (batch, max_len, n_kv, head_dim)
        return KVCache(torch.zeros(shape, dtype=cdtype, device=device),
                       torch.zeros(shape, dtype=cdtype, device=device),
                       None, None, pos)
    ds = head_dim // 2 if kv_packed(qcfg, head_dim) else head_dim
    zc = (batch, max_len, n_kv, ds)
    zs = (batch, max_len, n_kv, 1)
    return KVCache(torch.zeros(zc, dtype=torch.int8, device=device),
                   torch.zeros(zc, dtype=torch.int8, device=device),
                   torch.zeros(zs, dtype=torch.float32, device=device),
                   torch.zeros(zs, dtype=torch.float32, device=device), pos)


def _quantize_kv(x: torch.Tensor, spec) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-(batch, token, head) symmetric quantization."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax / spec.q_p, min=1e-9)
    codes = torch.clamp(torch.round(xf / scale), -spec.q_n, spec.q_p)
    return codes.to(torch.int8), scale


def _store_codes(codes: torch.Tensor, qcfg: QuantConfig) -> torch.Tensor:
    """Pack fresh int codes into the cache's storage layout."""
    if kv_packed(qcfg, codes.shape[-1]):
        return pack_int4(codes, axis=-1)
    return codes


def _load_codes(stored: torch.Tensor, qcfg: QuantConfig,
                head_dim: int) -> torch.Tensor:
    """Inverse of _store_codes: cache bytes -> (..., head_dim) int codes."""
    if kv_packed(qcfg, head_dim):
        return unpack_int4(stored, axis=-1)
    return stored


def append_rows(pos: torch.Tensor, t: int, ring: bool):
    """Where a chunk's tokens land in a cache of t rows: (batch index, chunk
    index, cache row) of the kept entries. Entries with pos < 0 are dropped;
    a ring keeps only the last t chunk positions (earlier ones would be
    overwritten by the ring anyway, and dropping them keeps the scatter free
    of duplicate rows). Finding the kept entries costs one host sync, so a
    step computes this once per cache shape and reuses it for every layer."""
    pos = pos.to(torch.int64)
    if ring:
        keep = (pos >= 0) & (pos > torch.amax(pos, dim=1, keepdim=True) - t)
    else:  # a position past the cache is dropped, as JAX's mode="drop" does
        keep = (pos >= 0) & (pos < t)
    bi, ci = keep.nonzero(as_tuple=True)
    kept = pos[bi, ci]
    return bi, ci, torch.remainder(kept, t) if ring else kept


def local_rows(rows, lo: int, t: int):
    """The `append_rows` entries whose cache row lies in [lo, lo + t), with
    the row made local (a sequence-sharded cache's own rows)."""
    bi, ci, si = rows
    mine = ((si >= lo) & (si < lo + t)).nonzero(as_tuple=True)[0]
    return bi[mine], ci[mine], si[mine] - lo


def cache_write_rows(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                     pos: torch.Tensor, rows, qcfg: QuantConfig) -> KVCache:
    """Write the chunk's kept tokens (rows from `append_rows`) in place."""
    bi, ci, si = rows
    spec = kv_cache_spec(qcfg)
    cache.pos[bi, si] = pos[bi, ci].to(cache.pos.dtype)
    if spec is None:
        cache.k[bi, si] = k_new[bi, ci].to(cache.k.dtype)
        cache.v[bi, si] = v_new[bi, ci].to(cache.v.dtype)
        return cache
    kc, ks = _quantize_kv(k_new, spec)
    vc, vs = _quantize_kv(v_new, spec)
    kc, vc = _store_codes(kc, qcfg), _store_codes(vc, qcfg)
    cache.k[bi, si] = kc[bi, ci]
    cache.v[bi, si] = vc[bi, ci]
    cache.k_scale[bi, si] = ks[bi, ci]
    cache.v_scale[bi, si] = vs[bi, ci]
    return cache


def cache_append_chunk(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: torch.Tensor, qcfg: QuantConfig, *,
                       ring: bool = False, window: int = 0) -> KVCache:
    """Write a chunk of tokens per batch row, in place (ring-buffered for
    local attention); returns the same cache.

    k_new/v_new: (B, C, Hkv, D); pos: (B, C) absolute positions. Entries with
    pos < 0 (padding rows of a partial prefill chunk, or idle serving slots)
    are dropped — no cache row is touched for them (see `append_rows`).
    """
    rows = append_rows(pos, cache.k.shape[1], ring)
    return cache_write_rows(cache, k_new, v_new, pos, rows, qcfg)


def cache_kv(cache: KVCache, qcfg: QuantConfig, cdtype=torch.bfloat16,
             head_dim: Optional[int] = None):
    """Dequantized (k, v) views of the cache (head_dim disambiguates packed
    storage from the odd-head_dim unpacked fallback)."""
    spec = kv_cache_spec(qcfg)
    if spec is None:
        return cache.k.to(cdtype), cache.v.to(cdtype)
    if head_dim is None:
        ds = cache.k.shape[-1]
        head_dim = 2 * ds if spec.bits <= 4 else ds
    kc = _load_codes(cache.k, qcfg, head_dim)
    vc = _load_codes(cache.v, qcfg, head_dim)
    k = (kc.to(torch.float32) * cache.k_scale).to(cdtype)
    v = (vc.to(torch.float32) * cache.v_scale).to(cdtype)
    return k, v


def storage_roundtrip(x: torch.Tensor, qcfg: QuantConfig, store_dtype,
                      cdtype) -> torch.Tensor:
    """Pass fresh K/V through the cache's storage semantics, so a chunked
    prefill step attends to its in-chunk keys exactly as a later step reads
    them back from the cache."""
    spec = kv_cache_spec(qcfg)
    if spec is None:
        return x.to(store_dtype).to(cdtype)
    codes, scale = _quantize_kv(x, spec)
    return (codes.to(torch.float32) * scale).to(cdtype)


def _fused_cache_attention(q, cache: KVCache, *, q_per_kv: int, q_pos,
                           window: int, softcap: float, parts: bool = False):
    """Cache side via the flash-decode kernel: returns the unnormalized
    (acc, m, l) online-softmax triple, each (B, C, H[, D]) f32 (with
    `parts`, each key split's triple on a leading axis)."""
    return pooled_decode_attention(
        q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.pos, q_pos,
        q_per_kv=q_per_kv, window=window, softcap=softcap, parts=parts)


def merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """Online-softmax merge of P partial (acc, m, l) triples stacked on a
    leading axis, in order, with the decode kernel's arithmetic for its key
    splits (csrc/decode_attention.cu merge_rows): m the max over the parts;
    a part whose m is NEG_INF adds nothing, the others add acc exp(m_p - m)
    and l exp(m_p - m), each product rounded and then added; where every
    part is masked the row keeps part 0's triple."""
    mx = torch.amax(m, dim=0)
    acc_o = torch.zeros_like(acc[0])
    l_o = torch.zeros_like(l[0])
    for i in range(m.shape[0]):
        live = m[i] != NEG_INF
        f = torch.exp(m[i] - mx)
        l_o = l_o + torch.where(live, l[i] * f, 0.0)
        acc_o = acc_o + torch.where(live[..., None], acc[i] * f[..., None], 0.0)
    none = mx == NEG_INF
    return (torch.where(none[..., None], acc[0], acc_o), mx,
            torch.where(none, l[0], l_o))


def _seq_merge(seq, acc, m, l):
    """The key splits' triples (S, ...) of every model rank (one
    all-gather), merged in one pass in rank order: where each rank holds a
    whole number of the kernel's key splits, exactly the kernel's merge over
    the whole cache."""
    d = acc.shape[-1]
    packed = torch.cat([acc, m[..., None], l[..., None]], dim=-1)
    parts = seq.all_gather(packed, 0)
    return merge_partials(parts[..., :d], parts[..., d], parts[..., d + 1])


def attend_chunk(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 cache: KVCache, qcfg: QuantConfig, *, q_per_kv: int,
                 pos: torch.Tensor, window: int, softcap: float,
                 seq=None) -> torch.Tensor:
    """Chunk attention against cache ∪ current chunk (pre-append).

    q: (B, C, H, D); k_new/v_new: (B, C, Hkv, D) un-repeated, un-cached;
    pos: (B, C) absolute positions of the chunk tokens (-1 = padding: the
    query sees nothing and its K/V are invisible to every other query).
    Valid keys per query: position in [max(0, p-window+1) .. p] (window=0
    => everything up to p), from cache.pos for cached rows and from `pos`
    for in-chunk keys. With the kernel route on, the cached side is one
    flash-decode call and the in-chunk keys merge with one more
    online-softmax step; the concatenated dequantized cache never exists.
    seq: this rank's part of a sequence-sharded cache (module docstring).
    """
    b, c, h, d = q.shape
    k_c = storage_roundtrip(k_new, qcfg, cache.k.dtype, q.dtype)
    v_c = storage_roundtrip(v_new, qcfg, cache.v.dtype, q.dtype)
    if _use_fused_attention(qcfg, q):
        acc, m_k, l_k = _fused_cache_attention(
            q, cache, q_per_kv=q_per_kv, q_pos=pos, window=window,
            softcap=softcap, parts=seq is not None)
        if seq is not None:
            acc, m_k, l_k = _seq_merge(seq, acc, m_k, l_k)
        qs = (q.to(torch.float32) * d ** -0.5).to(q.dtype)
        s_c = _grouped_scores(qs, k_c, q_per_kv)  # (B, H, C, C)
        s_c = _softcap(s_c, softcap)
        valid = (pos[:, None, :] >= 0) & (pos[:, None, :] <= pos[:, :, None])
        if window > 0:
            valid &= pos[:, None, :] > (pos[:, :, None] - window)
        s_c = torch.where(valid[:, None], s_c, NEG_INF)
        # merge the chunk keys into the kernel's running (m, l, acc)
        m_k = m_k.permute(0, 2, 1)              # (B, H, C)
        l_k = l_k.permute(0, 2, 1)
        m_t = torch.maximum(m_k, torch.amax(s_c, dim=-1))
        alpha = torch.exp(m_k - m_t)
        p_c = torch.exp(s_c - m_t[..., None])
        l_t = l_k * alpha + torch.sum(p_c, dim=-1)
        pv = _grouped_pv(p_c.to(v_c.dtype).to(torch.float32), v_c)
        acc = acc * alpha.permute(0, 2, 1)[..., None] + pv
        return (acc / l_t.permute(0, 2, 1)[..., None]).to(q.dtype)
    k_old, v_old = cache_kv(cache, qcfg, q.dtype, d)
    cpos = cache.pos
    if seq is not None:  # every rank's rows, in order
        k_old, v_old, cpos = (seq.all_gather(t, 1) for t in (k_old, v_old, cpos))
    k_all = torch.cat([k_old, k_c], dim=1)
    v_all = torch.cat([v_old, v_c], dim=1)
    kpos = torch.cat([cpos, pos.to(cpos.dtype)], dim=1)  # (B, T + C)
    s = _grouped_scores((q.to(torch.float32) * d ** -0.5).to(q.dtype),
                        k_all, q_per_kv)
    s = _softcap(s, softcap)
    valid = (kpos[:, None, :] >= 0) & (kpos[:, None, :] <= pos[:, :, None])
    if window > 0:
        valid &= kpos[:, None, :] > (pos[:, :, None] - window)
    s = torch.where(valid[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _grouped_pv(p.to(v_all.dtype), v_all)


def attend_decode(q: torch.Tensor, cache: KVCache, qcfg: QuantConfig, *,
                  q_per_kv: int, pos: torch.Tensor, window: int,
                  softcap: float) -> torch.Tensor:
    """One-token attention against the cache (token already appended).

    q: (B, 1, H, D); pos: (B,) current absolute positions. With the kernel
    route on, the whole step is one flash-decode call.
    """
    b, _, h, d = q.shape
    if _use_fused_attention(qcfg, q):
        acc, _, l = _fused_cache_attention(
            q, cache, q_per_kv=q_per_kv, q_pos=pos[:, None], window=window,
            softcap=softcap)
        return (acc / l[..., None]).to(q.dtype)
    k, v = cache_kv(cache, qcfg, q.dtype, d)
    s = _grouped_scores((q.to(torch.float32) * d ** -0.5).to(q.dtype), k,
                        q_per_kv)
    s = _softcap(s, softcap)
    valid = (cache.pos >= 0) & (cache.pos <= pos[:, None])
    if window > 0:
        valid &= cache.pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _grouped_pv(p.to(v.dtype), v)
