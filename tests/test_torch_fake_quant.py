"""Port parity: `repro_torch.kernels.ops.fake_quant` / `fake_quant_grouped`
(the plain versions of csrc/fake_quant.cu on CPU tensors) against the JAX
package's Pallas kernels in interpret mode, bit for bit (the sweep of
tests/test_kernels.py)."""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.quantizer import QuantSpec as JSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core.quantizer import QuantSpec  # noqa: E402
from repro_torch.kernels import fake_quant as fq  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _bits(a: np.ndarray) -> np.ndarray:
    """The raw bits of an f32 / bf16 array, so -0 and +0 differ."""
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint16)


def _jax_np(y) -> np.ndarray:
    a = np.asarray(y)
    return a if a.dtype == np.float32 else a.view(np.uint16)


def _torch_np(y: torch.Tensor) -> np.ndarray:
    return (y.numpy() if y.dtype == torch.float32
            else y.view(torch.int16).numpy().view(np.uint16))


def _inputs(rng, shape, dt):
    x = rng.standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[dt][1])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(DTYPES[dt][2])
    return jx, tx


def _assert_bit_equal(got: torch.Tensor, want) -> None:
    g, w = _torch_np(got), _jax_np(want)
    assert g.shape == w.shape
    diff = np.flatnonzero(_bits(g) != _bits(w))
    assert diff.size == 0, (diff.size, g.reshape(-1)[diff[:5]], w.reshape(-1)[diff[:5]])


@pytest.mark.parametrize("shape", [(8, 16), (300, 700), (257, 129), (1, 640)])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fake_quant_sweep_bit_equal(rng, shape, bits, dt):
    jx, tx = _inputs(rng, shape, dt)
    want = jops.fake_quant(jx, 0.07, JSpec(bits=bits), interpret=True)
    got = ops.fake_quant(tx, 0.07, QuantSpec(bits=bits))
    assert got.dtype == tx.dtype
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("shape", [(64, 96), (300, 700)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fake_quant_offset_is_one_rounding(rng, bits, shape, dt):
    """With an offset the reference kernel rounds q*s + b once (a fused
    multiply-add): the port equals it bit for bit, and is within one f32 ulp
    of the jnp oracle, which rounds the product and the sum apart."""
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[dt][1])
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(DTYPES[dt][2])
    jspec = JSpec(bits=bits, signed=False, offset=True)
    want = jops.fake_quant(jx, 0.0731, jspec, offset=0.05, interpret=True)
    got = ops.fake_quant(tx, 0.0731, QuantSpec(bits=bits, signed=False,
                                                 offset=True), offset=0.05)
    _assert_bit_equal(got, want)
    if dt == "f32":
        oracle = np.asarray(jref.fake_quant_2d(jx, 0.0731, 0.05, q_n=jspec.q_n,
                                               q_p=jspec.q_p))
        g = got.numpy()
        assert np.all(np.abs(g - oracle) <= np.spacing(np.abs(oracle)))


@pytest.mark.parametrize("groups", [2, 6])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("inner", [(40, 24), (5, 7)])
def test_fake_quant_grouped_bit_equal(rng, groups, dt, inner):
    jx, tx = _inputs(rng, (groups,) + inner, dt)
    sc = (np.abs(rng.standard_normal(groups)) * 0.1 + 0.02).astype(np.float32)
    spec = JSpec(bits=4, granularity="per_head")
    want = jops.fake_quant_grouped(jx, jnp.asarray(sc), spec, interpret=True)
    got = ops.fake_quant_grouped(tx, torch.from_numpy(sc),
                                 QuantSpec(bits=4, granularity="per_head"))
    assert got.shape == tx.shape
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("shape", [(700,), (3, 5, 130)])
def test_fake_quant_any_rank(rng, shape):
    jx, tx = _inputs(rng, shape, "f32")
    want = jops.fake_quant(jx, 0.05, JSpec(bits=3), offset=-0.01, interpret=True)
    got = ops.fake_quant(tx, 0.05, QuantSpec(bits=3), offset=-0.01)
    assert got.shape == shape
    _assert_bit_equal(got, want)


def test_negative_zero_kept_without_offset():
    """-0 quantizes to -0 with no offset (the reference drops its "+ 0"),
    and to +0 with an offset of 0 (q * s + 0 in one rounding)."""
    x = torch.tensor([[-0.01, 0.01, -0.0]])
    spec = QuantSpec(bits=4)
    y = ops.fake_quant(x, 0.5, spec)
    assert torch.equal(torch.signbit(y), torch.tensor([[True, False, True]]))
    y0 = ops.fake_quant(x, 0.5, spec, offset=0.0)
    assert not torch.signbit(y0).any()


def _round_f32(v: Fraction) -> np.float32:
    """v correctly rounded to f32 (nearest, ties to even)."""
    c = np.float32(float(v))
    cands = [c, np.nextafter(c, np.float32(np.inf)),
             np.nextafter(c, np.float32(-np.inf))]
    best = min(abs(Fraction(float(k)) - v) for k in cands)
    near = [k for k in cands if abs(Fraction(float(k)) - v) == best]
    return min(near, key=lambda k: int(np.array(k).view(np.uint32)) & 1)


def test_fma_rounds_once_where_f64_would_tie(rng):
    """q * s lands on an f32 midpoint and b is far below it: an f64 sum
    rounds back onto the midpoint (and f32's ties-to-even then picks the
    wrong side); the round-to-odd step picks the side of the exact value."""
    s = np.float32(1 + 2.0 ** -23)
    cases = [(3.0, s, np.float32(-2.0 ** -60)), (3.0, s, np.float32(2.0 ** -60)),
             (-5.0, s, np.float32(2.0 ** -70))]
    for _ in range(200):
        cases.append((float(rng.integers(-128, 256)),
                      np.float32(rng.uniform(1e-3, 1.0)),
                      np.float32(rng.standard_normal() * 10.0 ** rng.integers(-30, 1))))
    q = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    sv = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    bv = torch.tensor([c[2] for c in cases], dtype=torch.float32)
    got = ref._fma_f32(q, sv, bv).numpy()
    want = np.array([_round_f32(Fraction(qq) * Fraction(float(ss)) + Fraction(float(bb)))
                     for qq, ss, bb in cases], np.float32)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # the first case is the one a plain f64 sum gets wrong
    naive = (np.float64(3.0) * np.float64(s) + np.float64(-2.0 ** -60)).astype(np.float32)
    assert naive != want[0]


def test_wrappers_count_no_launch_on_cpu(rng):
    fq.fake_quant_2d.launches = fq.fake_quant_rows.launches = 0
    x = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    fq.fake_quant_2d(x, 0.1, q_n=8, q_p=7)
    fq.fake_quant_rows(x, torch.full((4, 1), 0.1), q_n=8, q_p=7)
    assert fq.fake_quant_2d.launches == 0 and fq.fake_quant_rows.launches == 0
    counts = ops.launch_counts()
    assert "fake_quant_2d" in counts and "fake_quant_rows" in counts
