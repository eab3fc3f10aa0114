"""The port's serving model (prefill_step / decode_step) against the JAX
package on the same serving weights: reduced granite-8b with GQA (kv heads 2,
untied int8 lm_head) and reduced gemma2-2b (ring-buffered local layers,
attention and final softcaps, sandwich norms, tied head), at w8a8 and w4a4
weights, with fp, int8 and int4 KV caches.

Bars:
  * float32 dtype, fp KV: max |dlogit| <= 1e-4 (only summation order and
    f32 library ulps differ).
  * bfloat16 (the model dtype; XLA compiled with excess precision off so it
    rounds each bf16 op as the port does): the bar of
    tests/test_fused_qat_matmul.py:396-403 — 90th percentile |dlogit| < 1e-3,
    mean < 0.05, max |dp| < 0.02, equal argmax.
  * Quantized KV rounds each K/V value to a code; where a summation order
    moves a value across a rounding boundary the two sides hold codes one
    step apart (amax/127 of that head at 8 bits, amax/7 at 4), and every
    later logit of that row moves with it. f32 is therefore held at fp KV
    only, and int8 / int4 KV at bf16 to the distribution part of the bar:
    mean |dlogit| < 0.05, max |dp| < 0.02, and equal argmax on every row
    whose top-2 logit gap exceeds twice that row's largest |dlogit| (a
    narrower gap is a tie the observed difference can break).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import EXACT_BF16, configs, serving_params  # noqa: E402
from repro.core.policy import get_preset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core.policy import get_preset as t_get_preset  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

B, P, CACHE = 2, 7, 16


def _qcfgs(quant, kv_bits, route, a_bits=32):
    jf = "on" if route == "kernel" else "off"
    tf = "auto" if route == "kernel" else "off"
    jq = get_preset(quant).replace(kv_cache_bits=kv_bits, a_bits=a_bits,
                                   fused_matmul=jf, fused_attention=jf)
    tq = t_get_preset(quant).replace(kv_cache_bits=kv_bits, a_bits=a_bits,
                                     fused_matmul=tf, fused_attention=tf)
    return jq, tq


def _run_both(arch, quant, kv_bits, route, dtype, a_bits=32):
    """Prefill (one row padded with pos = -1) then two decode steps on both
    sides; returns [(jax logits, port logits, valid-row mask)] per step."""
    jc, tc = configs(arch, dtype)
    jq, tq = _qcfgs(quant, kv_bits, route, a_bits)
    jparams, tparams = serving_params(arch, quant, a_bits)
    step = jax.jit(lambda p, c, b: JM.prefill_step(p, c, b, jc, jq))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    pos[1, 5:] = -1
    jcache = JM.init_cache(jc, jq, B, CACHE)
    tcache = TM.init_cache(tc, tq, B, CACHE, "cpu")
    out = []
    batches = [(toks, pos)]
    for s in range(2):
        batches.append((rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32),
                        np.array([[P + s], [5 + s]], np.int32)))
    compiled = {}
    for tk, ps in batches:
        jb = {"tokens": jnp.asarray(tk), "pos": jnp.asarray(ps)}
        if tk.shape not in compiled:
            compiled[tk.shape] = step.lower(jparams, jcache, jb).compile(EXACT_BF16)
        jl, jcache = compiled[tk.shape](jparams, jcache, jb)
        tl, tcache = TM.prefill_step(
            tparams, tcache, {"tokens": torch.from_numpy(tk),
                              "pos": torch.from_numpy(ps)}, tc, tq)
        v = jc.vocab_size
        out.append((np.asarray(jl)[..., :v], tl.numpy()[..., :v], ps >= 0))
    return out


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


F32_CASES = [("granite-8b", "w8a8", "off"), ("granite-8b", "w4a4", "off"),
             ("gemma2-2b", "w8a8", "off"), ("gemma2-2b", "w4a4", "kernel")]


@pytest.mark.parametrize("arch,quant,route", F32_CASES)
def test_logits_match_jax_float32(arch, quant, route):
    for jl, tl, valid in _run_both(arch, quant, 0, route, "float32"):
        assert np.isfinite(tl[valid]).all()
        np.testing.assert_allclose(tl[valid], jl[valid], rtol=0, atol=1e-4)


def test_tied_head_activation_quantizer_matches_jax():
    """gemma2's tied serving head keeps its 8-bit activation quantizer
    (a_scale / a_offset survive the conversion) and applies it with the
    module-wise g factor of the dequantized embedding."""
    for jl, tl, valid in _run_both("gemma2-2b", "w8a8", 0, "off", "float32",
                                   a_bits=8):
        np.testing.assert_allclose(tl[valid], jl[valid], rtol=0, atol=1e-4)


BF16_CASES = [  # (arch, quant, kv_bits, route); "kernel" = the serving route
    ("granite-8b", "w4a4", 8, "kernel"),
    ("granite-8b", "w8a8", 0, "off"),
    ("gemma2-2b", "w8a8", 8, "off"),
    ("gemma2-2b", "w4a4", 0, "off"),
    ("granite-8b", "w4a4", 4, "kernel"),
    ("gemma2-2b", "w8a8", 4, "off"),
]


@pytest.mark.parametrize("arch,quant,kv_bits,route", BF16_CASES)
def test_logits_match_jax_bf16(arch, quant, kv_bits, route):
    decided_rows = []
    for jl, tl, valid in _run_both(arch, quant, kv_bits, route, "bfloat16"):
        j, t = jl[valid], tl[valid]
        assert np.isfinite(t).all()
        d = np.abs(t - j)
        if kv_bits == 0:
            assert np.quantile(d, 0.9) < 1e-3, np.quantile(d, 0.9)
        assert d.mean() < 0.05, d.mean()
        assert np.abs(_softmax(t) - _softmax(j)).max() < 0.02
        same = t.argmax(-1) == j.argmax(-1)
        if kv_bits == 0:
            assert same.all()
        else:
            top2 = np.sort(j, -1)[:, -2:]
            decided = (top2[:, 1] - top2[:, 0]) > 2 * d.max(-1)
            assert same[decided].all()
            decided_rows.extend(decided)
    assert kv_bits == 0 or np.mean(decided_rows) >= 0.5  # not vacuous


def test_cache_matches_jax_after_prefill():
    """The per-layer KV cache the port writes equals the JAX package's at
    f32: positions exactly, K/V values to f32 summation order."""
    from repro_torch import bridge
    jc, tc = configs("granite-8b", "float32")
    jq, tq = _qcfgs("w8a8", 0, "off")
    jparams, tparams = serving_params("granite-8b", "w8a8", 32)
    toks = np.arange(B * P, dtype=np.int32).reshape(B, P) % jc.vocab_size
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    pos[1, 5:] = -1
    _, jcache = jax.jit(lambda p, c, b: JM.prefill_step(p, c, b, jc, jq))(
        jparams, JM.init_cache(jc, jq, B, CACHE),
        {"tokens": jnp.asarray(toks), "pos": jnp.asarray(pos)})
    _, tcache = TM.prefill_step(tparams, TM.init_cache(tc, tq, B, CACHE, "cpu"),
                                {"tokens": torch.from_numpy(toks),
                                 "pos": torch.from_numpy(pos)}, tc, tq)
    j_layers = bridge.cache_to_numpy(bridge.cache_from_jax(
        jax.tree.map(np.asarray, jcache), tc, "cpu"))
    for jl, tl in zip(j_layers, bridge.cache_to_numpy(tcache)):
        jl, tl = jl["kv"], tl["kv"]
        np.testing.assert_array_equal(tl[4], jl[4])                  # pos
        np.testing.assert_allclose(tl[0], jl[0], rtol=0, atol=1e-5)  # k
        np.testing.assert_allclose(tl[1], jl[1], rtol=0, atol=1e-5)  # v
