"""Serving the recurrent families and cross-attention in the port against
the JAX package: reduced xlstm-350m, recurrentgemma-9b and
llama-3.2-vision-11b under w4a4 int codes (fused_matmul off on both sides,
activations unquantized as the serving CLI sets), f32, fp KV cache.

  * a decode step from the reference's cache carried over by
    `bridge.cache_from_jax`: logits within 1e-4 absolute, and every new
    state (mLSTM C / n / m / conv, sLSTM c / n / h / m, RG-LRU h / conv,
    K / V rows, cross K / V) within 1e-4 of its largest value;
  * greedy_generate (one-chunk prefill, then single-token steps): the
    port's token streams equal the reference's.
Both use one jitted reference step per model (prompts of 8 tokens, then
single tokens), so XLA compiles each model twice.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs  # noqa: E402
from test_torch_recurrent_model import ARCHS, close, latent  # noqa: E402
from repro.core.policy import get_preset  # noqa: E402
from repro.launch.serve import greedy_generate as j_greedy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.common import convert_to_serving as j_convert  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.policy import get_preset as t_get_preset  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

B, P, NEW, CACHE = 2, 8, 5, 16


@functools.lru_cache(maxsize=None)
def _serving(arch):
    """(cfgs, qcfgs, the reference's jitted step, its serving tree, the
    port's bridged one)."""
    jc, tc = configs(arch, "float32")
    kw = dict(kv_cache_bits=0, a_bits=32, fused_matmul="off",
              fused_attention="off")
    jq, tq = get_preset("w4a4").replace(**kw), t_get_preset("w4a4").replace(**kw)
    jp = jax.jit(j_convert, static_argnums=(1,))(
        jax.tree.map(jnp.asarray, latent(arch, "w4a4", "float32")), jq)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    step = jax.jit(lambda p, c, b: JM.prefill_step(p, c, b, jc, jq))
    return (jc, tc), (jq, tq), step, jp, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_from_bridged_cache_matches_jax(arch):
    """The reference prefills 8 tokens; its cache crosses the bridge; one
    decode step on each side from it: logits and every new state."""
    (jc, tc), (jq, tq), step, jp, tp = _serving(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    _, jcache = step(jp, JM.init_cache(jc, jq, B, CACHE),
                     {"tokens": jnp.asarray(toks), "pos": jnp.asarray(pos)})
    tcache = bridge.cache_from_jax(jax.tree.map(np.asarray, jcache), tc, "cpu")
    nxt = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
    dpos = np.full((B, 1), P, np.int32)
    jl, jcache = step(jp, jcache, {"tokens": jnp.asarray(nxt),
                                   "pos": jnp.asarray(dpos)})
    tl, tcache = TM.decode_step(tp, tcache, {"tokens": torch.from_numpy(nxt),
                                             "pos": torch.from_numpy(dpos[:, 0])},
                                tc, tq)
    v = jc.vocab_size
    np.testing.assert_allclose(tl.numpy()[..., :v], np.asarray(jl)[..., :v],
                               rtol=0, atol=1e-4)
    want = bridge.cache_to_numpy(bridge.cache_from_jax(
        jax.tree.map(np.asarray, jcache), tc, "cpu"))
    got = bridge.cache_to_numpy(tcache)
    kinds = set()
    for w, g in zip(want, got):
        assert set(w) == set(g)
        kinds |= set(w)
        for name in w:
            close(g[name], w[name], 1e-4, name)
    want_kinds = {"xlstm-350m": {"mlstm", "slstm"},
                  "recurrentgemma-9b": {"rglru", "kv"},
                  "llama-3.2-vision-11b": {"kv", "xkv"}}[arch]
    assert kinds == want_kinds, kinds


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_streams_match_jax(arch):
    """greedy_generate (one-chunk prefill, then single-token steps) at f32
    with an fp KV cache: the port's token streams == the reference's."""
    (jc, tc), (jq, tq), step, jp, tp = _serving(arch)
    prompts = np.random.default_rng(6).integers(
        0, jc.vocab_size, (B, P)).astype(np.int32)
    jt, _ = j_greedy(step, jp, JM.init_cache(jc, jq, B, CACHE),
                     jnp.asarray(prompts), NEW)
    tt, _ = t_serve.greedy_generate(
        lambda p, c, b: TM.prefill_step(p, c, b, tc, tq), tp,
        TM.init_cache(tc, tq, B, CACHE, "cpu"), torch.from_numpy(prompts), NEW)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
