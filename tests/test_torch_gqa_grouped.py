"""GQA grouped-einsum parity on the port: attention never materializes
repeated K/V (the twin of tests/test_gqa_grouped.py).

attend_full / attend_local_chunked / attend_chunk / attend_decode run
grouped-query attention as a (Hkv, q_per_kv) grouped einsum over
un-repeated K/V. The reference for each is the same function fed K/V
repeated per query head with q_per_kv = 1: the per-(head, query)
contractions are the same terms. attend_full and attend_local_chunked
match bit for bit; the cache paths are held to 2e-6 (the reference's 1-2
ulp bar on unit-scale outputs). The sequence-sharded decode groups its
queries the same way on every rank.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

B, HKV, G, D, S = 2, 2, 4, 8, 16
H = HKV * G
KV_BITS = pytest.mark.parametrize("kv_bits", [0, 8, 4], ids=["fp", "int8", "int4"])


def _qcfg(kv_bits):
    # the unfused route: the kernel has its own parity suite
    return QuantConfig(w_bits=8, a_bits=32, mode="mdq", kv_cache_bits=kv_bits,
                       fused_attention="off")


def _qkv(seed, s=S):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return f(B, s, H, D), f(B, s, HKV, D), f(B, s, HKV, D)


def repeat_kv(x, n):
    return torch.repeat_interleave(x, n, dim=2)


def _ulp(a, b):
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=0)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 30.0)])
def test_attend_full_grouped_matches_repeat(window, softcap):
    q, k, v = _qkv(0)
    pos = torch.arange(S)
    kw = dict(causal=True, window=window, softcap=softcap, q_positions=pos,
              k_positions=pos, chunk_q=4)
    out = A.attend_full(q, k, v, q_per_kv=G, **kw)
    ref = A.attend_full(q, repeat_kv(k, G), repeat_kv(v, G), q_per_kv=1, **kw)
    assert torch.equal(out, ref)


def test_attend_local_chunked_grouped_matches_repeat():
    q, k, v = _qkv(1)
    kw = dict(window=6, softcap=20.0, chunk_q=4)
    out = A.attend_local_chunked(q, k, v, q_per_kv=G, **kw)
    ref = A.attend_local_chunked(q, repeat_kv(k, G), repeat_kv(v, G), q_per_kv=1, **kw)
    assert torch.equal(out, ref)


def _caches(kv_bits, n_feed):
    """Matched (grouped, repeated) caches: per-head quantization scales of a
    repeated head equal its source head's, so storage is the same bits."""
    qcfg = _qcfg(kv_bits)
    _, k, v = _qkv(2)
    pos = torch.arange(n_feed, dtype=torch.int32)[None].expand(B, n_feed)
    cg = A.cache_append_chunk(A.init_kv_cache(qcfg, B, S, HKV, D, device="cpu"),
                              k[:, :n_feed], v[:, :n_feed], pos, qcfg)
    cr = A.cache_append_chunk(A.init_kv_cache(qcfg, B, S, H, D, device="cpu"),
                              repeat_kv(k[:, :n_feed], G), repeat_kv(v[:, :n_feed], G),
                              pos, qcfg)
    return qcfg, cg, cr, k, v


@KV_BITS
@pytest.mark.parametrize("window", [0, 5])
def test_attend_decode_grouped_matches_repeat(kv_bits, window):
    qcfg, cg, cr, _, _ = _caches(kv_bits, n_feed=10)
    q = _qkv(3, 1)[0]
    pos = torch.full((B,), 9, dtype=torch.int32)
    out = A.attend_decode(q, cg, qcfg, q_per_kv=G, pos=pos, window=window, softcap=0.0)
    ref = A.attend_decode(q, cr, qcfg, q_per_kv=1, pos=pos, window=window, softcap=0.0)
    _ulp(out, ref)


@KV_BITS
@pytest.mark.parametrize("window", [0, 5])
def test_attend_chunk_grouped_matches_repeat(kv_bits, window):
    qcfg, cg, cr, k, v = _caches(kv_bits, n_feed=10)
    c = 3
    q = _qkv(4, c)[0]
    kn, vn = k[:, 10:10 + c], v[:, 10:10 + c]
    pos = torch.arange(10, 10 + c, dtype=torch.int32)[None].expand(B, c)
    out = A.attend_chunk(q, kn, vn, cg, qcfg, q_per_kv=G, pos=pos, window=window,
                         softcap=30.0)
    ref = A.attend_chunk(q, repeat_kv(kn, G), repeat_kv(vn, G), cr, qcfg, q_per_kv=1,
                         pos=pos, window=window, softcap=30.0)
    _ulp(out, ref)
