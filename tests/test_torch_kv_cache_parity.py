"""Quantized-KV decode parity over the ring-buffered sliding-window cache,
on the port (`repro_torch.models.attention`): the twin of
tests/test_kv_cache_parity.py, with each case's cache also held against the
JAX package's on the same inputs.

Chunked appends, token-by-token appends (one-token chunks) and
attend-before-append must agree exactly at every storage width (fp / int8 /
int4): the engine's chunked prefill and the decode step share these
primitives, and the sequence-sharded decode splits them (each rank appends
the rows it holds and attends over them before the merge). Also: ring
wraparound leaves exactly the state of a fresh cache fed only the window,
pos = -1 rows never touch storage, int4 codes are nibble-packed along
head_dim, and an odd head_dim keeps one byte a code.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.policy import QuantConfig as JQuantConfig
from repro.models import attention as JA

torch = pytest.importorskip("torch")

from repro_torch.core.policy import QuantConfig, kv_cache_spec  # noqa: E402
from repro_torch.core.quantizer import unpack_int4  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

KV_BITS = pytest.mark.parametrize("kv_bits", [0, 8, 4], ids=["fp", "int8", "int4"])
B, HKV, D = 2, 2, 4


def _qcfg(kv_bits):
    return QuantConfig(w_bits=8, a_bits=32, mode="mdq", kv_cache_bits=kv_bits)


def _jqcfg(kv_bits):
    return JQuantConfig(w_bits=8, a_bits=32, mode="mdq", kv_cache_bits=kv_bits)


def _stream(seed, n, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n, HKV, d)).astype(np.float32),
            rng.standard_normal((B, n, HKV, d)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _arrays(c):
    return [x.float().numpy() if isinstance(x, torch.Tensor) else
            np.asarray(x, np.float32) for x in c if x is not None]


def _feed_tokens(cache, k, v, positions, qcfg, **kw):
    for i, p in enumerate(positions):
        pos = torch.full((B, 1), p, dtype=torch.int32)
        cache = A.cache_append_chunk(cache, _t(k[:, i:i + 1]), _t(v[:, i:i + 1]),
                                     pos, qcfg, **kw)
    return cache


def _j_feed_tokens(cache, k, v, positions, qcfg, **kw):
    for i, p in enumerate(positions):
        cache = JA.cache_append(cache, jnp.asarray(k[:, i:i + 1]),
                                jnp.asarray(v[:, i:i + 1]),
                                jnp.full((B,), p, jnp.int32), qcfg, **kw)
    return cache


def _same_as_reference(cache, jcache):
    for a, b in zip(_arrays(cache), _arrays(jcache)):
        np.testing.assert_array_equal(a, b)


@KV_BITS
def test_chunked_append_equals_token_append(kv_bits):
    qcfg = _qcfg(kv_bits)
    n, t = 20, 8  # 2.5x wraparound of the ring
    k, v = _stream(0, n)
    tok = _feed_tokens(A.init_kv_cache(qcfg, B, t, HKV, D, device="cpu"), k, v,
                       range(n), qcfg, ring=True, window=t)
    chk = A.init_kv_cache(qcfg, B, t, HKV, D, device="cpu")
    for s in range(0, n, 5):
        e = min(s + 5, n)
        pos = torch.arange(s, e, dtype=torch.int32)[None].expand(B, e - s)
        chk = A.cache_append_chunk(chk, _t(k[:, s:e]), _t(v[:, s:e]), pos, qcfg,
                                   ring=True, window=t)
    for a, b in zip(_arrays(tok), _arrays(chk)):
        np.testing.assert_array_equal(a, b)
    jq = _jqcfg(kv_bits)
    _same_as_reference(tok, _j_feed_tokens(JA.init_kv_cache(jq, B, t, HKV, D), k, v,
                                           range(n), jq, ring=True, window=t))


@KV_BITS
def test_attend_chunk_then_append_equals_append_then_decode(kv_bits):
    """The C=1 decode contract: attending BEFORE the append (the chunk K/V
    through storage_roundtrip) equals appending first and attending the
    cache, for global (window 0) and sliding-window layers."""
    qcfg = _qcfg(kv_bits).replace(fused_attention="off")
    t = 8
    k, v = _stream(2, t)
    cache = _feed_tokens(A.init_kv_cache(qcfg, B, t, HKV, D, device="cpu"), k, v,
                         range(5), qcfg, ring=True, window=t)
    q = _t(np.random.default_rng(9).standard_normal((B, 1, HKV, D)).astype(np.float32))
    kn, vn = _t(k[:, 5:6]), _t(v[:, 5:6])
    pos1 = torch.full((B, 1), 5, dtype=torch.int32)
    for window in (0, 4):
        pre = A.attend_chunk(q, kn, vn, cache, qcfg, q_per_kv=1, pos=pos1,
                             window=window, softcap=0.0)
        appended = A.cache_append_chunk(
            A.KVCache(*(None if x is None else x.clone() for x in cache)),
            kn, vn, pos1, qcfg, ring=True, window=t)
        post = A.attend_decode(q, appended, qcfg, q_per_kv=1, pos=pos1[:, 0],
                               window=window, softcap=0.0)
        # the same key set; the in-chunk key sits at the concatenation's
        # tail instead of its ring slot (the reference's bar)
        np.testing.assert_allclose(pre.numpy(), post.numpy(), atol=1e-6, rtol=0)


@KV_BITS
def test_ring_wraparound_equals_window_only_cache(kv_bits):
    qcfg = _qcfg(kv_bits)
    n, t = 11, 4
    k, v = _stream(4, n)
    full = _feed_tokens(A.init_kv_cache(qcfg, B, t, HKV, D, device="cpu"), k, v,
                        range(n), qcfg, ring=True, window=t)
    tail = _feed_tokens(A.init_kv_cache(qcfg, B, t, HKV, D, device="cpu"),
                        k[:, n - t:], v[:, n - t:], range(n - t, n), qcfg,
                        ring=True, window=t)
    for a, b in zip(_arrays(full), _arrays(tail)):
        np.testing.assert_array_equal(a, b)


@KV_BITS
def test_padding_rows_touch_nothing(kv_bits):
    qcfg = _qcfg(kv_bits)
    t = 6
    k, v = _stream(6, 4)
    cache = _feed_tokens(A.init_kv_cache(qcfg, B, t, HKV, D, device="cpu"), k, v,
                         range(3), qcfg, ring=True, window=t)
    before = _arrays(cache)
    junk_k, junk_v = _stream(7, 2)
    pad = torch.full((B, 2), -1, dtype=torch.int32)
    after = A.cache_append_chunk(cache, _t(junk_k), _t(junk_v), pad, qcfg,
                                 ring=True, window=t)
    for a, b in zip(before, _arrays(after)):
        np.testing.assert_array_equal(a, b)


def test_int4_codes_packed_and_in_range():
    qcfg = _qcfg(4)
    k, v = _stream(8, 6)
    cache = _feed_tokens(A.init_kv_cache(qcfg, B, 6, HKV, D, device="cpu"), k, v,
                         range(6), qcfg, ring=True, window=6)
    assert tuple(cache.k.shape) == (B, 6, HKV, D // 2)  # 0.5 byte an element
    for packed in (cache.k, cache.v):
        codes = unpack_int4(packed, axis=-1)
        assert tuple(codes.shape) == (B, 6, HKV, D)
        assert int(codes.abs().max()) <= 7
    qcfg8 = _qcfg(8)
    cache8 = _feed_tokens(A.init_kv_cache(qcfg8, B, 6, HKV, D, device="cpu"), k, v,
                          range(6), qcfg8, ring=True, window=6)
    assert tuple(cache8.k.shape) == (B, 6, HKV, D)
    assert int(cache8.k.abs().max()) > 7  # int8 uses the range


def test_packed_kv_roundtrip_and_odd_head_dim_fallback():
    qcfg = _qcfg(4)
    spec = kv_cache_spec(qcfg)
    k, v = _stream(12, 6)
    cache = _feed_tokens(A.init_kv_cache(qcfg, B, 6, HKV, D, device="cpu"), k, v,
                         range(6), qcfg, ring=True, window=6)
    kd, _ = A.cache_kv(cache, qcfg, torch.float32, D)
    kc, ks = A._quantize_kv(_t(k), spec)
    np.testing.assert_array_equal(kd.numpy(), (kc.to(torch.float32) * ks).numpy())
    kd2, _ = A.cache_kv(cache, qcfg, torch.float32)  # head_dim: packed assumed
    np.testing.assert_array_equal(kd.numpy(), kd2.numpy())

    d_odd = D + 1
    k5, v5 = _stream(3, 6, d_odd)
    codd = A.init_kv_cache(qcfg, B, 6, HKV, d_odd, device="cpu")
    assert tuple(codd.k.shape) == (B, 6, HKV, d_odd)  # the unpacked fallback
    pos = torch.arange(6, dtype=torch.int32)[None].expand(B, 6)
    codd = A.cache_append_chunk(codd, _t(k5), _t(v5), pos, qcfg, ring=True, window=6)
    assert int(codd.k.abs().max()) <= 7
    kodd, _ = A.cache_kv(codd, qcfg, torch.float32, d_odd)
    kc5, ks5 = A._quantize_kv(_t(k5), spec)
    np.testing.assert_array_equal(kodd.numpy(), (kc5.to(torch.float32) * ks5).numpy())
    # and the reference stores the same codes and scales
    jq = _jqcfg(4)
    jodd = JA.cache_append_chunk(JA.init_kv_cache(jq, B, 6, HKV, d_odd),
                                 jnp.asarray(k5), jnp.asarray(v5),
                                 jnp.asarray(pos.numpy()), jq, ring=True, window=6)
    _same_as_reference(codd, jodd)
