"""The port's plain kernel versions (repro_torch.kernels.ref) against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs.

The CUDA kernels themselves run only on the card (chip_smoke.py holds them
against these plain versions there); here the wrappers must take the plain
version for CPU tensors and launch nothing.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.quantizer import QuantSpec as JQuantSpec  # noqa: E402
from repro.core.quantizer import pack_int4 as j_pack_int4  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.decode_attention import \
    pooled_decode_attention as j_pooled  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.core.quantizer import QuantSpec, pack_int4  # noqa: E402
from repro_torch.kernels import decode_attention, ops, quant_matmul, ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("mkn", [(3, 70, 45), (17, 130, 200), (1, 64, 257)])
def test_int_matmul_plain_matches_pallas(mkn, packed):
    """Ragged M, K, N (the JAX wrapper pads to its tiles; the port masks).
    Only the f32 summation order differs: <= 1e-5 * max|y|."""
    m, k, n = mkn
    rng = np.random.default_rng(m * 1000 + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    bits = 4 if packed else 8
    codes = rng.integers(-2 ** (bits - 1), 2 ** (bits - 1), (k, n)).astype(np.int8)
    scale = (rng.random(n) * 0.05).astype(np.float32)
    scale[0] = 0.0  # exercises the kernel's max(scale, 1e-9) floor
    w_np = np.array(j_pack_int4(jnp.asarray(codes), 0)) if packed else codes
    y_j = np.asarray(jops.int_matmul(jnp.asarray(x), jnp.asarray(w_np),
                                     jnp.asarray(scale), JQuantSpec(bits=bits),
                                     packed=packed, interpret=True))
    y_t = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w_np),
                         torch.from_numpy(scale), QuantSpec(bits=bits),
                         packed=packed).numpy()
    assert y_t.shape == (m, n) and y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


def _attn_inputs(rng, *, storage, q_per_kv, c, b=3, t=24, d=16, hkv=2):
    h = hkv * q_per_kv
    q = rng.standard_normal((b, c, h, d)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, d)).astype(np.float32)
    pos = np.full((b, t), -1, np.int32)
    pos[0, :20] = np.arange(20)                      # slot 0: 20 tokens
    s = np.arange(t)                                 # slot 1: a ring holding
    pos[1, :] = np.where(s < 6, s + 48, s + 24)      # positions 30..53
    # slot 2 idle: every row -1
    q_pos = np.stack([np.arange(19, 19 + c), np.arange(53, 53 + c),
                      np.full(c, -1)]).astype(np.int32)
    q_pos[0, -1] = -1 if c > 1 else q_pos[0, -1]     # a padding query
    if storage == "fp":
        return q, k, v, None, None, pos, q_pos
    bits = 8 if storage == "int8" else 4
    spec = QuantSpec(bits=bits)
    kc, ks = TA._quantize_kv(torch.from_numpy(k), spec)
    vc, vs = TA._quantize_kv(torch.from_numpy(v), spec)
    if storage == "int4":
        kc, vc = (pack_int4(kc, -1), pack_int4(vc, -1))
    return (q, kc.numpy(), vc.numpy(), ks.numpy(), vs.numpy(), pos, q_pos)


CASES = [  # (q_per_kv, window, softcap, C): together every value of each
    (1, 0, 0.0, 1),
    (4, 8, 50.0, 3),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "g%d-w%d-cap%d-c%d" % c)
@pytest.mark.parametrize("storage", ["fp", "int8", "int4"])
def test_pooled_decode_attention_plain_matches_pallas(storage, case):
    """f32 q; idle slot (pos = -1 everywhere), a padding query, a ring with
    wrapped positions. Bar: acc/l within 1e-5 and m equal (up to f32
    rounding) on rows with a valid key; fully masked rows keep the finite
    NEG_INF max and l > 0 on both sides."""
    q_per_kv, window, softcap, c = case
    rng = np.random.default_rng(7)
    args = _attn_inputs(rng, storage=storage, q_per_kv=q_per_kv, c=c)
    j_args = [None if a is None else jnp.asarray(a) for a in args]
    acc_j, m_j, l_j = (np.asarray(o) for o in j_pooled(
        *j_args, q_per_kv=q_per_kv, window=window, softcap=softcap,
        interpret=True))
    t_args = [None if a is None else torch.from_numpy(np.ascontiguousarray(a))
              for a in args]
    acc_t, m_t, l_t = (o.numpy() for o in ref.pooled_decode_attention(
        *t_args, q_per_kv=q_per_kv, window=window, softcap=softcap))
    assert acc_t.shape == acc_j.shape and m_t.shape == m_j.shape
    live = m_j > ref.NEG_INF / 2                       # row has a valid key
    assert live.any() and (~live).any()
    o_j = acc_j / l_j[..., None]
    o_t = acc_t / l_t[..., None]
    np.testing.assert_allclose(o_t[live], o_j[live], rtol=0, atol=1e-5)
    np.testing.assert_allclose(m_t[live], m_j[live], rtol=1e-6, atol=1e-6)
    assert np.all(m_t[~live] == ref.NEG_INF) and np.all(l_t[~live] > 0)
    assert np.all(np.isfinite(acc_t)) and np.all(np.isfinite(l_t))


def test_pooled_decode_attention_plain_bf16_q():
    """bf16 q (the model's dtype): K, V and P round to bf16 on both sides;
    the summation order of the f32 dots differs, so a P near a bf16 rounding
    boundary may land one bf16 ulp apart: 2**-8 relative to max|out|."""
    rng = np.random.default_rng(3)
    q, kc, vc, ks, vs, pos, q_pos = _attn_inputs(rng, storage="int8",
                                                 q_per_kv=4, c=3)
    acc_j, m_j, l_j = (np.asarray(o) for o in j_pooled(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(pos), jnp.asarray(q_pos),
        q_per_kv=4, window=0, softcap=0.0, interpret=True))
    acc_t, m_t, l_t = (o.numpy() for o in ref.pooled_decode_attention(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(kc),
        torch.from_numpy(vc), torch.from_numpy(ks), torch.from_numpy(vs),
        torch.from_numpy(pos), torch.from_numpy(q_pos), q_per_kv=4, window=0,
        softcap=0.0))
    live = m_j > ref.NEG_INF / 2
    o_j = acc_j / l_j[..., None]
    o_t = acc_t / l_t[..., None]
    np.testing.assert_allclose(o_t[live], o_j[live], rtol=0,
                               atol=2 ** -8 * np.abs(o_j[live]).max())


def test_wrappers_take_plain_version_on_cpu_and_count_nothing():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-8, 8, (8, 4)).astype(np.int8))
    s = torch.full((4,), 0.1)
    y = quant_matmul.int_matmul(x, codes, s)
    torch.testing.assert_close(y, ref.int_matmul(x, codes, s), rtol=0, atol=0)
    packed = pack_int4(codes, 0)
    y4 = quant_matmul.int4_matmul(x, packed, s)
    torch.testing.assert_close(y4, y, rtol=0, atol=0)
    q = torch.zeros((1, 1, 2, 8))
    kv = torch.zeros((1, 4, 1, 8))
    pos = torch.zeros((1, 4), dtype=torch.int32)
    decode_attention.pooled_decode_attention(
        q, kv, kv, None, None, pos, pos[:, :1], q_per_kv=2, window=0,
        softcap=0.0)
    counts = ops.launch_counts()
    assert {"int_matmul", "int4_matmul", "pooled_decode_attention"} <= set(counts)
    assert set(counts.values()) == {0}


def test_fused_on_off_the_gpu_raises():
    qcfg = QuantConfig(w_bits=8, a_bits=32, fused_matmul="on")
    p = {"codes": torch.zeros((8, 4), dtype=torch.int8),
         "w_scale": torch.ones(())}
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.qlinear(p, torch.zeros((1, 2, 8)), "w_in", qcfg, "bsd,df->bsf")
    cache = TA.init_kv_cache(QuantConfig(), 1, 4, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="needs CUDA"):
        TA.attend_decode(torch.zeros((1, 1, 2, 8)), cache,
                         QuantConfig(fused_attention="on"), q_per_kv=2,
                         pos=torch.zeros((1,), dtype=torch.int32), window=0,
                         softcap=0.0)
