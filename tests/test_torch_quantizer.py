"""The port's quantizer and serving conversion against the JAX package, bit
for bit on the same numpy inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs, latent_params  # noqa: E402
from repro.core import quantizer as JQ  # noqa: E402
from repro.core.policy import get_preset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.common import convert_to_serving as j_convert  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import policy as TP  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import convert_to_serving  # noqa: E402


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quantize_int_matches_jax(bits):
    """Includes exact .5 ties (half-to-even on both sides) and clipping."""
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((64, 48)) * 3).astype(np.float32)
    x[0, :8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5],
                        np.float32)
    for scale in (np.float32(1.0), np.float32(0.3),
                  (rng.random((1, 48)) + 0.1).astype(np.float32)):
        j = np.asarray(JQ.quantize_int(jnp.asarray(x), jnp.asarray(scale),
                                       JQ.QuantSpec(bits=bits)))
        t = TQ.quantize_int(torch.from_numpy(x), torch.as_tensor(scale),
                            TQ.QuantSpec(bits=bits)).numpy()
        assert t.dtype == np.int8
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_pack_int4_full_range_matches_jax(axis):
    """Every int4 code in every nibble position; bytes equal JAX's and the
    unpack (int32 shifts, arithmetic sign extension) round-trips."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    pairs = np.stack([lo.reshape(-1), hi.reshape(-1)], 1)  # (256, 2)
    codes = pairs.reshape(16, 32).astype(np.int8)            # row pairs along -1
    codes = np.stack([codes, -codes - 1, codes[::-1]], 0)    # (3, 16, 32)
    if axis == 0:
        codes = np.concatenate([codes, codes[:1]], 0)        # even along 0
    j = np.asarray(JQ.pack_int4(jnp.asarray(codes), axis))
    t = TQ.pack_int4(torch.from_numpy(codes), axis)
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(TQ.unpack_int4(t, axis).numpy(), codes)
    np.testing.assert_array_equal(
        TQ.unpack_int4(t, axis).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(j), axis)))


@pytest.mark.parametrize("group_axes", [(), (1,), (0,)])
def test_init_scale_matches_jax(group_axes):
    """Bit-equal on inputs whose sums are exact in f32 (multiples of 2**-12
    below 2**10), so the result does not depend on the order XLA and torch
    sum in; on gaussian inputs the two agree to a few ulp."""
    rng = np.random.default_rng(len(group_axes))
    shape = (64, 4, 16)
    for bits in (4, 8):
        spec_j = JQ.QuantSpec(bits=bits, granularity="per_head" if group_axes
                              else "per_tensor")
        spec_t = TQ.QuantSpec(bits=bits, granularity=spec_j.granularity)
        w = (rng.integers(-4096, 4096, shape) * 2.0 ** -12).astype(np.float32)
        j = np.asarray(JQ.init_scale(jnp.asarray(w), spec_j, group_axes))
        t = TQ.init_scale(torch.from_numpy(w), spec_t, group_axes).numpy()
        assert t.shape == j.shape
        np.testing.assert_array_equal(t, j)
        g = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        j = np.asarray(JQ.init_scale(jnp.asarray(g), spec_j, group_axes))
        t = TQ.init_scale(torch.from_numpy(g), spec_t, group_axes).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


_j_init = jax.jit(JM.init_params, static_argnums=(1, 2))
_j_convert = jax.jit(j_convert, static_argnums=(1,))


@pytest.mark.parametrize("arch,quant", [("granite-8b", "w4a4"),
                                        ("granite-8b", "w8a8"),
                                        ("gemma2-2b", "w4a4")])
def test_convert_to_serving_bit_equal(arch, quant):
    """Bridged latent JAX params through the port's convert_to_serving give
    the same codes / codes4 / w_scale (and bf16 leaves) as JAX's
    convert_to_serving, layer by layer."""
    jc, tc = configs(arch)
    jq = get_preset(quant)
    latent = latent_params(jc, jq)
    j_serv = bridge.params_from_jax(
        jax.tree.map(np.asarray, _j_convert(latent, jq)), tc, "cpu")
    t_serv = convert_to_serving(
        bridge.params_from_jax(jax.tree.map(np.asarray, latent), tc, "cpu"),
        TP.get_preset(quant))

    def walk(a, b, path):
        assert type(a) is type(b), path
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                walk(a[k], b[k], path + (k,))
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, path + (i,))
        else:
            assert a.dtype == b.dtype, path
            torch.testing.assert_close(a, b.reshape(a.shape), rtol=0, atol=0,
                                       msg=str(path))
    walk(t_serv, j_serv, ())
    n_packed = sum("codes4" in lay[k] for lay in t_serv["layers"]
                   for k in lay if isinstance(lay[k], dict))
    assert (n_packed > 0) == (quant == "w4a4")


def test_init_serving_params_matches_distribution():
    """init_serving_params builds the serving tree directly; it must have
    the layout of JAX's convert_to_serving(init_params(...)) and the same
    distributions (different RNG, so values differ)."""
    jc, tc = configs("granite-8b")
    jc = jc.replace(d_model=128, d_ff=256)
    tc = tc.replace(d_model=128, d_ff=256)
    jq, tq = get_preset("w4a4"), TP.get_preset("w4a4")
    j_serv = bridge.params_from_jax(jax.tree.map(
        np.asarray, _j_convert(_j_init(jax.random.PRNGKey(0), jc, jq), jq)),
        tc, "cpu")
    t_serv = TM.init_serving_params(tc, tq, torch.Generator().manual_seed(0),
                                    "cpu")
    for name in ("wq", "wo", "w_in", "w_out"):
        a, b = t_serv["layers"][0][name], j_serv["layers"][0][name]
        assert sorted(a) == sorted(b)
        ca = TQ.unpack_int4(a["codes4"], 0 if name != "wo" else 1)
        cb = TQ.unpack_int4(b["codes4"], 0 if name != "wo" else 1)
        ha = np.bincount(ca.numpy().ravel() + 8, minlength=16) / ca.numel()
        hb = np.bincount(cb.numpy().ravel() + 8, minlength=16) / cb.numel()
        np.testing.assert_allclose(ha, hb, atol=0.02)
        assert a["w_scale"].numel() == b["w_scale"].numel()
        np.testing.assert_allclose(a["w_scale"].mean().item(),
                                   b["w_scale"].mean().item(), rtol=0.05)
    emb_a, emb_b = t_serv["embed"], j_serv["embed"]
    assert emb_a["codes"].shape == emb_b["codes"].shape
    np.testing.assert_allclose(emb_a["w_scale"].item(), emb_b["w_scale"].item(),
                               rtol=0.05)
    assert t_serv["final_norm"]["g"].dtype == torch.bfloat16
