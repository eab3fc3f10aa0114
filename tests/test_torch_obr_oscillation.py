"""The port's OBR (Eq. 10), KURE and oscillation telemetry (Eq. 11-12):
the nine behaviours of tests/test_obr_oscillation.py on the port, and the
port against the JAX package on the same numpy inputs.

Bars against the reference: Eq. 10's value within 1e-5 relative and its
gradient within 1e-5 of max|g| (f32 reductions over up to 12k elements in
another order; the bin memberships are integer codes, identical on both
sides, which the test asserts); KURE within 1e-5 relative; the oscillation
state over a 5-step sequence: int8 codes and directions exactly, the f32
EMA within one ulp (compiled, XLA contracts its multiply-add into one FMA
rounding; the port rounds the multiply and the add).
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import obr as JO  # noqa: E402
from repro.core import oscillation as JOsc  # noqa: E402
from repro.core import quantizer as JQ  # noqa: E402
from repro_torch.core.obr import (kure_loss, obr_lambda_schedule, obr_loss,  # noqa: E402
                                  per_bin_moments, total_obr_loss)
from repro_torch.core.oscillation import (OscState, dampen_oscillating,  # noqa: E402
                                          init_osc_state, oscillation_fraction,
                                          update_osc_state)
from repro_torch.core.quantizer import QuantSpec, quantize_int  # noqa: E402

SPEC = QuantSpec(bits=3, grad_scale_mode="none")


def _t(v):
    return torch.tensor(np.asarray(v, np.float32))


# --- the nine behaviours of tests/test_obr_oscillation.py -------------------

def test_obr_zero_at_bin_centers():
    w = _t([-0.4, -0.2, 0.0, 0.1, 0.3])  # exact centers
    assert float(obr_loss(w, _t(0.1), SPEC)) < 1e-5


def test_obr_positive_off_center():
    w = _t(np.random.default_rng(0).standard_normal(100) * 0.2)
    assert float(obr_loss(w, _t(0.1), SPEC)) > 0.01


def test_obr_gradient_pulls_to_center():
    w = _t([0.13]).requires_grad_(True)  # bin 1 (center 0.1), above center
    obr_loss(w, _t(0.1), SPEC).backward()
    assert float(w.grad[0]) > 0  # descent moves w down toward 0.1


def test_obr_bin_variance_term():
    """Bins with <= 2 elements contribute no variance (Eq. 10)."""
    s = _t(1.0)
    w = _t([0.1, -0.1])
    count, _, _ = per_bin_moments(w, torch.tensor([0, 0], dtype=torch.int8), (), SPEC)
    assert float(count[SPEC.q_n]) == 2.0
    l2 = float(torch.sqrt(torch.sum(w ** 2) + 1e-12))
    assert_allclose(float(obr_loss(w, s, SPEC)), l2, rtol=1e-5)
    w4 = _t([0.1, -0.1, 0.2, -0.2])
    l2_4 = float(torch.sqrt(torch.sum(w4 ** 2) + 1e-12))
    assert float(obr_loss(w4, s, SPEC)) > l2_4


def test_lambda_schedule_cosine():
    assert float(obr_lambda_schedule(torch.tensor(0), 100, 0.1)) == 0.0
    assert_allclose(float(obr_lambda_schedule(torch.tensor(100), 100, 0.1)), 0.1,
                    rtol=1e-6)
    assert 0.04 < float(obr_lambda_schedule(torch.tensor(50), 100, 0.1)) < 0.06
    for step in (0, 1, 7, 50, 99, 100, 150):
        assert float(obr_lambda_schedule(torch.tensor(step), 100, 0.1)) == \
            float(JO.obr_lambda_schedule(jnp.asarray(step), 100, 0.1))


def test_oscillation_detects_flip_flop():
    """A weight ping-ponging across a bin boundary trips Eq. 11."""
    s = _t(1.0)
    st = init_osc_state(_t([0.4]), s, SPEC)  # bin 0
    m, f = 0.01, 0.0
    for i, v in enumerate([0.6, 0.4, 0.6, 0.4, 0.6]):  # codes 1,0,1,0,1
        st = update_osc_state(st, _t([v]), s, SPEC, momentum=m)
        # the first change has no previous direction: no oscillation
        f = m * (1.0 if i >= 1 else 0.0) + (1 - m) * f
        assert_allclose(float(st.freq[0]), f, rtol=1e-6)
    assert float(st.freq[0]) > 0


def test_no_oscillation_on_monotone_drift():
    s = _t(1.0)
    st = init_osc_state(_t([0.1]), s, SPEC)
    for v in (0.6, 1.2, 1.7, 2.3):  # codes 1, 1, 2, 2: always upward
        st = update_osc_state(st, _t([v]), s, SPEC)
    assert float(st.freq[0]) == 0.0


def test_oscillation_fraction_threshold():
    st = OscState(prev_int=torch.zeros((2, 2), dtype=torch.int8),
                  prev_dir=torch.zeros((2, 2), dtype=torch.int8),
                  freq=_t([[0.01, 0.001], [0.2, 0.0]]))
    assert_allclose(float(oscillation_fraction(st, 0.005)), 0.5)


def test_obr_per_head_groups():
    spec = QuantSpec(bits=3, granularity="per_head", grad_scale_mode="none")
    w = _t(np.random.default_rng(1).standard_normal((8, 2, 4)))
    s = _t([0.05, 0.5]).reshape(1, 2, 1)
    loss = obr_loss(w, s, spec)
    assert np.isfinite(float(loss)) and float(loss) > 0


# --- against the JAX package ---------------------------------------------

# scale shapes: per tensor, per head (wq-like (d, H, hd) with (1, H, 1)),
# per expert ((E, d, f) with (E, 1, 1))
GROUPS = {"tensor": ((24, 40), ()), "head": ((16, 4, 12), (1, 4, 1)),
          "expert": ((3, 16, 20), (3, 1, 1))}


@pytest.mark.parametrize("bits", [2, 3])
@pytest.mark.parametrize("group", sorted(GROUPS))
def test_obr_value_and_gradient_match_jax(group, bits):
    shape, sshape = GROUPS[group]
    spec_kw = dict(bits=bits, grad_scale_mode="none",
                   granularity="per_tensor" if not sshape else "per_head")
    rng = np.random.default_rng(bits * 10 + len(shape))
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    s = np.asarray(rng.random(sshape) * 0.04 + 0.03, np.float32)
    j_spec, t_spec = JQ.QuantSpec(**spec_kw), QuantSpec(**spec_kw)
    j_val, j_g = jax.jit(jax.value_and_grad(
        lambda ww: JO.obr_loss(ww, jnp.asarray(s), j_spec)))(jnp.asarray(w))
    np.testing.assert_array_equal(
        quantize_int(torch.from_numpy(w), torch.from_numpy(s), t_spec).numpy(),
        np.asarray(JQ.quantize_int(jnp.asarray(w), jnp.asarray(s), j_spec)))
    wt = torch.from_numpy(w).requires_grad_(True)
    st = torch.from_numpy(s).requires_grad_(True)
    t_val = obr_loss(wt, st, t_spec)
    t_val.backward()
    t_val = t_val.detach()
    assert st.grad is None or float(st.grad.abs().max()) == 0.0  # scale: constant
    assert_allclose(float(t_val), float(j_val), rtol=1e-5)
    j_g = np.asarray(j_g)
    assert np.abs(wt.grad.numpy() - j_g).max() <= 1e-5 * np.abs(j_g).max()
    # the sum over leaves, as the train step takes it
    both = [(torch.from_numpy(w), torch.from_numpy(s), t_spec)] * 2
    assert_allclose(float(total_obr_loss(both, torch.tensor(0.5))),
                    float(j_val), rtol=1e-5)


@pytest.fixture(scope="module")
def edge8():
    """An 8-bit edge leaf and the reference's Eq. 10 value and gradient."""
    w = (np.random.default_rng(3).standard_normal((97, 16)) * 0.02).astype(np.float32)
    s = np.float32(2 * np.abs(w).mean() / np.sqrt(127))
    j_val, j_g = jax.jit(jax.value_and_grad(lambda ww: JO.obr_loss(
        ww, jnp.asarray(s), JQ.QuantSpec(bits=8, grad_scale_mode="none"))))(
        jnp.asarray(w))
    return w, s, float(j_val), np.asarray(j_g)


@pytest.mark.parametrize("route", ["levels-at-once", "loop"])
def test_obr_of_an_8bit_edge(edge8, route, monkeypatch):
    """256 levels (an 8-bit edge), with the same value and gradient as the
    reference whether the moments of all levels come from one set of
    reductions (a small leaf) or from a loop over the levels (a large one,
    such as the full-width embedding; the threshold is lowered to take that
    route at this size); either way the backward pass keeps w and its codes
    (1 byte each), not a mask or a masked product per level."""
    from repro_torch.core import obr as TO
    if route == "loop":
        monkeypatch.setattr(TO, "VEC_BYTES", 0)
    w, s, j_val, j_g = edge8
    wt = torch.from_numpy(w).requires_grad_(True)
    saved = {}  # storage -> bytes of every tensor the graph keeps

    def pack(t):
        saved[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        v = obr_loss(wt, torch.tensor(s), QuantSpec(bits=8, grad_scale_mode="none"))
    v.backward()
    # w, its codes, w - w_q and six 256-bin tables, not 256 levels' worth
    # of weight-sized masks (~3 MB here)
    assert sum(saved.values()) <= 4 * 4 * w.size + 6 * 4 * 256, sum(saved.values())
    assert_allclose(float(v.detach()), j_val, rtol=1e-5)
    assert np.abs(wt.grad.numpy() - j_g).max() <= 1e-5 * np.abs(j_g).max()


def test_moments_backward_is_autograds():
    """`_Moments`' written-out backward equals autograd through the masked
    reductions, bit for bit, for per-tensor and grouped scales."""
    from repro_torch.core import obr as TO
    rng = np.random.default_rng(6)
    for shape, sshape in (((12, 10), ()), ((3, 8, 5), (3, 1, 1)), ((6, 4, 5), (1, 4, 1))):
        w = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        codes = torch.clamp(torch.round(w * 3), -4, 3).to(torch.int8)
        g = [torch.from_numpy(rng.standard_normal((8,) + (sshape or ()))
                              .astype(np.float32)) for _ in range(3)]
        dims = tuple(range(w.dim())) if not sshape else tuple(
            i for i, n in enumerate(sshape) if n == 1)
        keep = bool(sshape)
        a = w.clone().requires_grad_(True)
        outs = TO.per_bin_moments(a, codes, sshape, SPEC)
        sum((o * gg).sum() for o, gg in zip(outs, g)).backward()
        b = w.clone().requires_grad_(True)
        parts = [TO._level_moments(b, codes, lvl, dims, keep) for lvl in range(-4, 4)]
        ref_outs = [torch.stack(t) for t in zip(*parts)]
        for o, r in zip(outs, ref_outs):
            assert torch.equal(o.detach(), r.detach())
        sum((o * gg).sum() for o, gg in zip(ref_outs, g)).backward()
        assert torch.equal(a.grad, b.grad)


def test_kure_matches_jax():
    w = (np.random.default_rng(4).standard_normal((32, 24)) ** 3).astype(np.float32)
    assert_allclose(float(kure_loss(torch.from_numpy(w))),
                    float(JO.kure_loss(jnp.asarray(w))), rtol=1e-5)


def test_osc_sequence_matches_jax():
    """Five Eq. 12 updates of a (per-head) 3-bit weight random-walking
    around its bin edges: codes, directions and EMA equal the reference's
    after each step, and so does the oscillating fraction; dampening snaps
    the same weights."""
    spec_kw = dict(bits=3, granularity="per_head", grad_scale_mode="none")
    rng = np.random.default_rng(5)
    s = np.array([0.05, 0.1, 0.2], np.float32).reshape(1, 3, 1)
    w = (rng.standard_normal((10, 3, 6)) * 0.15).astype(np.float32)
    j_spec, t_spec = JQ.QuantSpec(**spec_kw), QuantSpec(**spec_kw)
    j_st = JOsc.init_osc_state(jnp.asarray(w), jnp.asarray(s), j_spec)
    t_st = init_osc_state(torch.from_numpy(w), torch.from_numpy(s), t_spec)
    upd = jax.jit(lambda st, ww: JOsc.update_osc_state(st, ww, jnp.asarray(s),
                                                       j_spec, momentum=0.3))
    for _ in range(5):
        w = w + (rng.standard_normal(w.shape) * 0.06).astype(np.float32)
        j_st = upd(j_st, jnp.asarray(w))
        t_st = update_osc_state(t_st, torch.from_numpy(w), torch.from_numpy(s),
                                t_spec, momentum=0.3)
        for name, a, b in zip(t_st._fields, t_st, j_st):
            b = np.asarray(b)
            assert a.dtype == {np.dtype("int8"): torch.int8,
                               np.dtype("float32"): torch.float32}[b.dtype]
            if name == "freq":  # XLA fuses m * o + (1 - m) * f into an FMA
                assert np.all(np.abs(a.numpy() - b) <= np.spacing(b)), name
            else:
                np.testing.assert_array_equal(a.numpy(), b)
        assert float(oscillation_fraction(t_st, 0.05)) == \
            float(JOsc.oscillation_fraction(j_st, 0.05))
    assert float(t_st.freq.max()) > 0.05  # the sequence did oscillate
    np.testing.assert_array_equal(
        dampen_oscillating(torch.from_numpy(w), torch.from_numpy(s), t_spec,
                           t_st, 0.2).numpy(),
        np.asarray(JOsc.dampen_oscillating(jnp.asarray(w), jnp.asarray(s),
                                           j_spec, j_st, 0.2)))
