"""One QAT train step of the port against the JAX package's on MoE with
OBR and oscillation tracking: reduced granite-moe (4 experts, top 2, tied
head) cut to one layer, w3a3 (MDQ, OBR lambda 0.1 on its cosine ramp) with
track_oscillation and the sentinel on, f32, unfused, from step 5 of 10
(lambda(t) = 0.05), on the same latent params (`_torch_parity`), batch and
MCKD labels. The reference runs its own jitted train step with its forward
without remat, its layer unrolled (see tests/test_torch_train_step.py on
what XLA's scan and jax.checkpoint change).

Two cuts keep the file under 30 s: one layer (the layer sum of the MoE aux
losses is held by tests/test_torch_moe.py's two-layer forward), and 4-bit
edges and router instead of 8 (XLA takes ~15 s to compile the 256 OBR
levels of each 8-bit leaf; tests/test_torch_obr_oscillation.py holds those
against the reference).

Bars: the loss, loss_obr, lb_loss and the KD loss within 1e-5 relative;
lambda, drop_frac and the health bits equal; the updated params within 1e-6
on the elements whose gradient exceeds 1e-3 of the leaf's largest (the bar
of test_adamw_update_matches_jax), the first moments of weights, biases and
norms within 1e-4 of their largest value; the oscillation state per leaf
(codes and directions exactly, the EMA within one f32 ulp: XLA's FMA) but
on weights moved across a bin edge by a different ulp (at most 1e-4 of
them), and osc_frac within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import train_batch, train_states  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from test_torch_train_step import (TRAIN, _leaves_jax, _leaves_jax_layout,  # noqa: E402
                                   _torch_batch)
from repro_torch.train import train_step as TT  # noqa: E402

MOE = "granite-moe-1b-a400m"


def _no_remat_forward(*args, **kw):
    kw["remat"] = False
    return JM.forward(*args, **kw)


def _calibrated(latent):
    """Routers calibrated as in tests/test_torch_moe.py, and every other
    activation quantizer given an offset of -0.03 (as training moves it).
    At init every LSQ+ offset is 0, so the lower clip edge sits at x = 0;
    at 3-bit weights an attention output or projection is often a sum of
    small-integer multiples of one scale that cancels to exactly 0 in one
    summation order and to a few ulps either side of it in another: a
    clip-edge tie in one framework and not in the other, which moves the
    gradient of that element by half or all of it (ROADMAP Queue 3)."""
    from test_torch_moe import calibrate_routers

    def shift(node, name=""):
        if isinstance(node, dict):
            return {k: shift(v, k) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(shift(v, name) for v in node)
        return np.full(np.shape(node), -0.03, np.float32) if name == "a_offset" else node

    return calibrate_routers(shift(latent))


@pytest.fixture(scope="module")
def moe_stepped():
    """Both sides' step (module docstring). Routers and offsets are calibrated (`_calibrated`: at init the
    routers' logits tie and activations sit on the clip edge). The
    oscillation state starts from the params' codes with random
    directions and EMAs, so Eq. 11 has changes to compare."""
    from repro.core.oscillation import OscState as JOscState
    from repro.train import train_step as jts
    (jc, tc), (jq, tq), (jt, tt), jstate, tstate = train_states(
        MOE, "w3a3", unrolled=True, step=5, params_fn=_calibrated, layers=1,
        qcfg_kw={"track_oscillation": True, "edge_bits": 4,
                                 "router_bits": 4}, **TRAIN)
    assert jc.n_groups == 0 and jc.n_tail == 1 and jq.obr_lambda == 0.1
    rng = np.random.default_rng(7)
    osc = tuple(JOscState(st.prev_int,
                          jnp.asarray(rng.integers(-1, 2, st.prev_dir.shape), jnp.int8),
                          jnp.asarray(rng.random(st.freq.shape) * 0.006, jnp.float32))
                for st in jstate["osc"])
    jstate = dict(jstate, osc=osc)
    tstate["osc"] = bridge.osc_from_jax(jax.tree.map(np.asarray, osc),
                                        tstate["params"], tq, tc, "cpu")
    b = train_batch(jc)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jts, "forward", _no_remat_forward)
        j_new, j_m = jax.jit(jts.make_train_step(jc, jq, jt))(
            jstate, {k: jnp.asarray(v) for k, v in b.items()})
    t_new, t_m = TT.make_train_step(tc, tq, tt)(tstate, _torch_batch(b))
    return dict(tc=tc, tq=tq, j_new=j_new, t_new=t_new,
                j_m={k: np.asarray(v) for k, v in j_m.items()},
                t_m={k: v.numpy() if hasattr(v, "numpy") else v
                     for k, v in t_m.items()})


def test_moe_step_losses_match_jax(moe_stepped):
    """loss (KD + lambda * OBR + lb_coef * lb_loss), loss_obr (Eq. 10 over
    the 9 quantized leaves) and lb_loss within 1e-5 relative; lambda and
    the health bits equal."""
    j, t = moe_stepped["j_m"], moe_stepped["t_m"]
    assert float(j["obr_lambda"]) > 0
    assert float(t["obr_lambda"]) == float(j["obr_lambda"])
    for k in ("loss", "loss_obr", "lb_loss", "loss_main"):
        assert abs(float(t[k]) - float(j[k])) <= 1e-5 * abs(float(j[k])), k
    assert float(t["drop_frac"]) == float(j["drop_frac"])
    assert int(t["health"]) == int(j["health"]) == 0


def test_moe_step_params_match_jax(moe_stepped):
    """The updated params within 1e-6 absolute on the elements whose
    gradient (the reference's first moment, (1 - b1) * c * g: OBR's
    lambda * dL_OBR/dw included) exceeds 1e-3 of the leaf's largest, the
    bar of test_adamw_update_matches_jax (Adam's first moves are ~lr *
    sign(g), so a near-zero gradient whose sign differs moves by up to
    2 * lr); the moments within 1e-4 of their largest value."""
    tc = moe_stepped["tc"]
    got = _leaves_jax_layout(moe_stepped["t_new"]["params"], tc)
    want = _leaves_jax(moe_stepped["j_new"]["params"])
    mu = _leaves_jax(moe_stepped["j_new"]["mu"])
    assert any("moe/moe_in" in k for k in want)
    for k in want:
        live = np.abs(mu[k]) > 1e-3 * np.abs(mu[k]).max()
        err = np.abs(got[k] - want[k])[live]
        assert err.size == 0 or err.max() <= 1e-6, (k, err.max())
    t_mu = _leaves_jax_layout(moe_stepped["t_new"]["mu"], tc)
    for k in mu:  # the quantizer scales' gradients are sums with much
        # cancellation (see _w_scale_norms); weights, biases and norms here
        if k.rsplit("/", 1)[-1] in ("w", "b", "g"):
            assert np.abs(t_mu[k] - mu[k]).max() <= 1e-4 * np.abs(mu[k]).max(), k


def test_moe_step_oscillation_matches_jax(moe_stepped):
    """The Eq. 12 update on the post-update weights: osc_frac and every
    leaf's codes, directions and EMA equal the reference's, but on the
    weights whose code differs because the update moved them across a
    bin edge by a different f32 ulp (held to 1e-4 of the elements); the
    EMA within one ulp elsewhere (XLA's FMA, see
    tests/test_torch_obr_oscillation.py)."""
    tc, tq = moe_stepped["tc"], moe_stepped["tq"]
    t_osc = bridge.osc_to_jax(moe_stepped["t_new"]["osc"],
                              moe_stepped["t_new"]["params"], tq, tc)
    j_osc = jax.tree.map(np.asarray, moe_stepped["j_new"]["osc"])
    assert len(t_osc) == len(j_osc) == 9
    n = bad = 0
    changed = 0
    for t_st, j_st in zip(t_osc, j_osc):
        same = t_st.prev_int == j_st.prev_int
        n += same.size
        bad += int((~same).sum())
        np.testing.assert_array_equal(t_st.prev_dir[same], j_st.prev_dir[same])
        d = np.abs(t_st.freq - j_st.freq)[same]
        assert np.all(d <= np.spacing(j_st.freq[same]))
        changed += int((j_st.prev_dir != 0).sum())
    assert bad <= 1e-4 * n, (bad, n)
    j_frac, t_frac = float(moe_stepped["j_m"]["osc_frac"]), float(moe_stepped["t_m"]["osc_frac"])
    assert j_frac > 0 and abs(t_frac - j_frac) <= 1e-6, (t_frac, j_frac)
