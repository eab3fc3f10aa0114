"""Hypothesis property tests for the port's quantizer invariants
(`repro_torch.core.quantizer`): twin of tests/test_property_quantizer.py,
case for case, with the same strategies and settings."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# hypothesis is a dev-only extra (requirements-dev.txt); degrade to skip
# rather than a collection error when it isn't installed.
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.core.quantizer import (QuantSpec, fake_quant, init_scale,  # noqa: E402
                                        quantize_int)

SETTINGS = dict(max_examples=40, deadline=None)

arrays = st.lists(st.floats(-100, 100, allow_nan=False),
                  min_size=1, max_size=64)
bits = st.integers(2, 8)
scales = st.floats(0.0001220703125, 10.0, allow_nan=False)  # 2^-13: f32-exact


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


@given(arrays, bits, scales)
@settings(**SETTINGS)
def test_output_on_grid(vals, b, s):
    """Every output is an integer multiple of s within [-Q_N s, Q_P s]."""
    spec = QuantSpec(bits=b, grad_scale_mode="none")
    q = fake_quant(_f32(vals), _f32(s), spec).numpy()
    codes = q / s
    assert np.all(np.abs(codes - np.round(codes)) < 1e-3)
    assert np.all(q >= -spec.q_n * s - 1e-4)
    assert np.all(q <= spec.q_p * s + 1e-4)


@given(arrays, bits, scales)
@settings(**SETTINGS)
def test_level_count(vals, b, s):
    spec = QuantSpec(bits=b, grad_scale_mode="none")
    q = fake_quant(_f32(vals), _f32(s), spec).numpy()
    assert len(np.unique(q)) <= 2 ** b


@given(arrays, bits, scales)
@settings(**SETTINGS)
def test_idempotency(vals, b, s):
    spec = QuantSpec(bits=b, grad_scale_mode="none")
    s = _f32(s)
    q1 = fake_quant(_f32(vals), s, spec)
    q2 = fake_quant(q1, s, spec)
    assert_allclose(q2.numpy(), q1.numpy(), rtol=1e-5, atol=1e-6)


@given(arrays, bits, scales)
@settings(**SETTINGS)
def test_monotone(vals, b, s):
    """Quantization preserves (non-strict) order."""
    spec = QuantSpec(bits=b, grad_scale_mode="none")
    x = torch.sort(_f32(vals)).values
    q = fake_quant(x, _f32(s), spec).numpy()
    assert np.all(np.diff(q) >= -1e-6)


@given(arrays, bits, scales)
@settings(**SETTINGS)
def test_error_bound(vals, b, s):
    """|x - q(x)| <= s/2 inside the representable range."""
    spec = QuantSpec(bits=b, grad_scale_mode="none")
    x = np.asarray(vals, np.float32)
    q = fake_quant(torch.from_numpy(x), _f32(s), spec).numpy()
    inside = (x > -spec.q_n * s) & (x < spec.q_p * s)
    assert np.all(np.abs(x - q)[inside] <= s / 2 + 1e-5)


@given(arrays, bits)
@settings(**SETTINGS)
def test_codes_in_range(vals, b):
    spec = QuantSpec(bits=b)
    x = _f32(vals)
    s = init_scale(x, spec)
    codes = quantize_int(x, s, spec).numpy()
    assert codes.min() >= -spec.q_n and codes.max() <= spec.q_p


@given(arrays, bits, scales)
@settings(**SETTINGS)
def test_grad_defined_everywhere(vals, b, s):
    """STE gradients are finite for any input/scale."""
    spec = QuantSpec(bits=b)
    x = _f32(vals).requires_grad_()
    gx, = torch.autograd.grad(torch.sum(fake_quant(x, _f32(s), spec)), [x])
    ss = _f32(s).requires_grad_()
    gs, = torch.autograd.grad(torch.sum(fake_quant(_f32(vals), ss, spec)), [ss])
    assert bool(torch.all(torch.isfinite(gx))) and bool(torch.isfinite(gs))
