"""The port's KV cache and cached attention against the JAX package on the
same numpy inputs: the ring-buffered append (drop on pos < 0), chunk
attention with the online-softmax merge, and single-token decode — on the
unfused composition ("off" on both sides) and on the kernel route (the
port's "auto", whose wrapper takes the plain version for CPU tensors,
against JAX's "on", its Pallas kernel in interpret mode)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402

B, T, HKV, D, Q_PER_KV = 3, 8, 2, 16, 2
KV_BITS = [0, 8, 4]
KV_IDS = ["fp", "int8", "int4"]


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if x is not None else None


def _caches(kv_bits, fused="off"):
    jq = JQuantConfig(w_bits=8, a_bits=32, kv_cache_bits=kv_bits,
                      fused_attention=fused)
    tq = QuantConfig(w_bits=8, a_bits=32, kv_cache_bits=kv_bits,
                     fused_attention="auto" if fused == "on" else fused)
    jc = JA.init_kv_cache(jq, B, T, HKV, D, jnp.float32)
    tc = TA.init_kv_cache(tq, B, T, HKV, D, torch.float32, "cpu")
    return jq, tq, jc, tc


def _assert_cache_equal(jc, tc):
    for a, b in zip(jc, tc):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(bridge.to_numpy(b), np.asarray(a))


def _chunks(rng, ring):
    """Two chunks over three rows: a partial prefill (pos -1 padding), a
    second chunk that wraps the ring (positions up to 11 on T = 8), and an
    idle row (all -1)."""
    c = 6
    pos = [np.array([[0, 1, 2, 3, -1, -1], [0, 1, 2, 3, 4, 5],
                     [-1] * 6]),
           np.array([[4, 5, 6, 7, 8, 9] if ring else [4, 5, 6, 7, -1, -1],
                     [6, 7, 8, 9, 10, 11] if ring else [6, 7, -1, -1, -1, -1],
                     [-1] * 6])]
    out = []
    for p in pos:
        k = rng.standard_normal((B, c, HKV, D)).astype(np.float32)
        v = rng.standard_normal((B, c, HKV, D)).astype(np.float32)
        out.append((k, v, p.astype(np.int32)))
    return out


@pytest.mark.parametrize("ring", [False, True], ids=["global", "ring"])
@pytest.mark.parametrize("kv_bits", KV_BITS, ids=KV_IDS)
def test_cache_append_chunk_matches_jax(kv_bits, ring):
    jq, tq, jc, tc = _caches(kv_bits)
    rng = np.random.default_rng(kv_bits + ring)
    for k, v, p in _chunks(rng, ring):
        jc = JA.cache_append_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(p), jq, ring=ring, window=T)
        tc = TA.cache_append_chunk(tc, torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(p), tq, ring=ring, window=T)
        _assert_cache_equal(jc, tc)
    assert (tc.pos[2] == -1).all()  # the idle row was never written


def _filled(kv_bits, fused, ring):
    jq, tq, jc, tc = _caches(kv_bits, fused)
    rng = np.random.default_rng(11)
    for k, v, p in _chunks(rng, ring)[:1]:
        jc = JA.cache_append_chunk(jc, jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(p), jq, ring=ring, window=T)
        tc = TA.cache_append_chunk(tc, torch.from_numpy(k), torch.from_numpy(v),
                                   torch.from_numpy(p), tq, ring=ring, window=T)
    return jq, tq, jc, tc, rng


@pytest.mark.parametrize("route", ["off", "kernel"])
@pytest.mark.parametrize("kv_bits", KV_BITS, ids=KV_IDS)
def test_attend_chunk_matches_jax(kv_bits, route):
    """f32 q; a ring window of 5 and a softcap; padding queries and an idle
    row (fully masked: finite, no NaN). 1e-5: only f32 summation order
    differs."""
    ring = True
    jq, tq, jc, tc, rng = _filled(kv_bits, "on" if route == "kernel" else "off",
                                  ring)
    c = 4
    q = rng.standard_normal((B, c, HKV * Q_PER_KV, D)).astype(np.float32)
    k = rng.standard_normal((B, c, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, c, HKV, D)).astype(np.float32)
    pos = np.array([[4, 5, 6, -1], [6, 7, 8, 9], [-1] * 4], np.int32)
    kw = dict(q_per_kv=Q_PER_KV, window=5, softcap=50.0)
    o_j = JA.attend_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jc,
                          jq, pos=jnp.asarray(pos), **kw)
    o_t = TA.attend_chunk(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), tc, tq,
                          pos=torch.from_numpy(pos), **kw)
    assert torch.isfinite(o_t).all()
    np.testing.assert_allclose(o_t.numpy(), _np(o_j), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kv_bits", KV_BITS, ids=KV_IDS)
def test_attend_decode_matches_jax(kv_bits):
    """Kernel route: the port's acc / l against the JAX kernel's."""
    jq, tq, jc, tc, rng = _filled(kv_bits, "on", ring=False)
    q = rng.standard_normal((B, 1, HKV * Q_PER_KV, D)).astype(np.float32)
    pos = np.array([3, 5, -1], np.int32)
    kw = dict(q_per_kv=Q_PER_KV, window=0, softcap=0.0)
    o_j = JA.attend_decode(jnp.asarray(q), jc, jq, pos=jnp.asarray(pos), **kw)
    o_t = TA.attend_decode(torch.from_numpy(q), tc, tq,
                           pos=torch.from_numpy(pos), **kw)
    live = pos >= 0
    np.testing.assert_allclose(o_t.numpy()[live], _np(o_j)[live], rtol=0,
                               atol=1e-5)
    assert torch.isfinite(o_t).all()
