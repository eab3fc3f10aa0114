"""The port's training-side quantizer (STE gradients, Eq. 6-7) against the
JAX package on the same numpy inputs (f32): forward values bit-equal; the
gradient wrt x (element-wise, no sums) within 1e-6 of its largest value;
the scale and offset gradients, which are sums over each scale group,
within 1e-6 of the group's sum of |summands| (the two frameworks reduce in
other orders, and a sum with cancellation can be far smaller than its
terms). Inputs include exact clip boundaries and .5 rounding ties (a tie
at a clip boundary splits the gradient in both frameworks)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import quantizer as JQ  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402

TOL = 1e-6


def _inputs(case, rng):
    """(x, scale, offset or None, spec kwargs, grad_scale_ref or None)."""
    if case == "per_tensor":
        x = (rng.standard_normal((8, 32)) * 0.5).astype(np.float32)
        x[0, :4] = [0.875, -1.0, 0.125, 1.125]   # clip edges, .5 ties at s=0.25
        return x, np.float32(0.25), None, dict(bits=4), None
    if case == "per_head":
        x = (rng.standard_normal((16, 3, 8)) * 0.1).astype(np.float32)
        sc = (rng.random((1, 3, 1)) * 0.03 + 0.01).astype(np.float32)
        return x, sc, None, dict(bits=4, granularity="per_head"), None
    if case == "offset":
        x = rng.standard_normal((6, 24)).astype(np.float32)
        w = (rng.standard_normal((24, 10)) * 0.2).astype(np.float32)
        return (x, np.float32(0.2), np.float32(-0.1),
                dict(bits=4, signed=False, offset=True), w)
    if case == "sign":
        x = rng.standard_normal((12, 20)).astype(np.float32)
        return x, np.float32(0.7), None, dict(bits=1), None
    if case == "lsq":
        x = (rng.standard_normal((10, 30)) * 0.3).astype(np.float32)
        return x, np.float32(0.05), None, dict(bits=3, grad_scale_mode="lsq"), None
    raise ValueError(case)


CASES = ["per_tensor", "per_head", "offset", "sign", "lsq"]


def _summand_l1(x, sc, off, spec, wgt, ref):
    """Per scale group, the sum of |ct_i * dy_i/d(param)| for the scale and
    the offset: fake_quant's body with the parameters expanded to x's shape
    (so autograd keeps one partial per element), times the g factor."""
    xt = torch.from_numpy(x)
    g = TQ.scale_grad_factor(spec, torch.from_numpy(x if ref is None else ref),
                             np.shape(sc) if ref is None else ())
    s_full = torch.tensor(np.broadcast_to(sc, x.shape).copy(), requires_grad=True)
    b_full = torch.tensor(np.broadcast_to(0.0 if off is None else off,
                                          x.shape).astype(np.float32),
                          requires_grad=True)
    xs = (xt - b_full) / s_full
    if spec.bits == 1:
        y = TQ.sign_ste(xs) * s_full
    else:
        y = TQ.round_ste(TQ._clip(xs, -float(spec.q_n), float(spec.q_p))) * s_full
    y = y + b_full
    ds, db = torch.autograd.grad((y * torch.from_numpy(wgt)).sum(), [s_full, b_full])
    axes = tuple(i for i, n in enumerate(np.shape(sc)) if n == 1) if np.ndim(sc) \
        else tuple(range(x.ndim))
    keep = bool(np.ndim(sc))
    gn = g.numpy()
    return [np.sum(np.abs(d.numpy()), axis=axes, keepdims=keep) * np.max(gn)
            for d in (ds, db)]


@pytest.mark.parametrize("case", CASES)
def test_fake_quant_value_and_grads_match_jax(case):
    rng = np.random.default_rng(CASES.index(case))
    x, sc, off, spec_kw, ref = _inputs(case, rng)
    wgt = np.cos(np.arange(x.size, dtype=np.float32) * 0.1).reshape(x.shape)
    jspec, tspec = JQ.QuantSpec(**spec_kw), TQ.QuantSpec(**spec_kw)
    argnums = (0, 1, 2) if off is not None else (0, 1)

    def jloss(x, s, b=None):
        y = JQ.fake_quant(x, s, jspec, offset=b,
                          grad_scale_ref=None if ref is None else jnp.asarray(ref))
        return jnp.sum(y * wgt), y

    jargs = [jnp.asarray(x), jnp.asarray(sc)] + ([jnp.asarray(off)] if off is not None else [])
    (_, jy), jg = jax.value_and_grad(jloss, argnums=argnums, has_aux=True)(*jargs)

    targs = [torch.tensor(np.asarray(a), requires_grad=True)
             for a in [x, sc] + ([off] if off is not None else [])]
    ty = TQ.fake_quant(targs[0], targs[1], tspec,
                       offset=targs[2] if off is not None else None,
                       grad_scale_ref=None if ref is None else torch.from_numpy(ref))
    (ty * torch.from_numpy(wgt)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    jx = np.asarray(jg[0])
    np.testing.assert_allclose(targs[0].grad.numpy(), jx, rtol=0,
                               atol=TOL * np.abs(jx).max())
    l1 = _summand_l1(x, sc, off, tspec, wgt, ref)
    for t, j, norm in zip(targs[1:], jg[1:], l1):
        assert np.all(np.abs(t.grad.numpy() - np.asarray(j)) <= TOL * norm), (
            t.grad.numpy(), np.asarray(j), norm)


@pytest.mark.parametrize("fn", ["round_ste", "sign_ste"])
def test_ste_primitives_match_jax(fn):
    x = np.array([-2.5, -1.5, -0.5, -0.3, 0.0, 0.5, 0.7, 1.0, 1.5, 2.5],
                 np.float32)
    jy, jvjp = jax.vjp(getattr(JQ, fn), jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = getattr(TQ, fn)(tx)
    g = np.linspace(-1, 1, x.size).astype(np.float32)
    ty.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jvjp(jnp.asarray(g))[0]))


def test_grad_scale_identity_forward_scaled_gradient():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    g = (rng.random((1, 7)) + 0.01).astype(np.float32)
    jy, jvjp = jax.vjp(lambda v: JQ.grad_scale(v, jnp.asarray(g)), jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ty = TQ.grad_scale(tx, torch.from_numpy(g))
    ct = np.cos(np.arange(x.size, dtype=np.float32)).reshape(x.shape)
    ty.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jvjp(jnp.asarray(ct))[0]))


@pytest.mark.parametrize("mode", ["module_l1", "lsq", "none"])
@pytest.mark.parametrize("scale_shape", [(), (1, 3, 1)])
def test_scale_grad_factor_matches_jax(mode, scale_shape):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((16, 3, 8)) * 0.1).astype(np.float32)
    spec_kw = dict(bits=4, grad_scale_mode=mode)
    j = np.asarray(JQ.scale_grad_factor(JQ.QuantSpec(**spec_kw), jnp.asarray(w),
                                        scale_shape))
    t = TQ.scale_grad_factor(TQ.QuantSpec(**spec_kw), torch.from_numpy(w),
                             scale_shape).numpy()
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


@pytest.mark.parametrize("group_axes", [(), (1,), (0,)])
def test_init_offset_matches_jax(group_axes):
    w = np.zeros((4, 3, 5), np.float32)
    spec_kw = dict(bits=4, signed=False, offset=True)
    j = np.asarray(JQ.init_offset(jnp.asarray(w), JQ.QuantSpec(**spec_kw), group_axes))
    t = TQ.init_offset(torch.from_numpy(w), TQ.QuantSpec(**spec_kw), group_axes)
    assert t.dtype == torch.float32 and tuple(t.shape) == j.shape
    np.testing.assert_array_equal(t.numpy(), j)
