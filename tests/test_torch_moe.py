"""The port's MoE FFN (repro_torch.models.moe) and its batched QAT linear
against the JAX package's, on the same numpy inputs: reduced granite-moe
(4 experts, top 2, d_model 64, d_ff 96), w4a4, bf16.

Routing. The router is an f32 einsum whose sums the two frameworks take in
other orders. At init its 8-bit activation quantizer has scale 1 and offset
0, so its input holds small integers and the reference's logits often tie
exactly between two experts; the port's may then differ by an ulp and
select the other one (lax.top_k and the port both take the lower index on
an exact tie). `test_router_ties_at_init` holds that case to where it
belongs: every token whose selected experts differ holds a tie at the k-th
place in the reference's probabilities (equal, or two f32 ulps apart where
the reference's own sums rounded a tie apart). Every other test gives
the routers a calibrated activation quantizer (scale 1/16, offset -4), as
training makes it, where no logits tie, and then asks for equal expert
indices and keep masks.

Bars. With equal routing, XLA compiled with excess precision off rounds
every bf16 op as the port does, and the MoE output and aux losses are
compared exactly or to the f32 ulps of their sums: the output bit for bit
on both of the port's routes against both of the reference's (the kernel
route's f32 sums, rounded to bf16, land on the unfused bf16 einsum's value
at these sizes), lb_loss within 1e-6 relative (an f32 mean over tokens in
another order), drop_frac exactly. The batched linear's five gradients meet
the bars of tests/test_torch_fused_qat.py (1e-4 of max(max|g|, 1), one bf16
ulp on at most 1% of dX / dW). The two-layer forward meets the bf16 logits
bar of tests/test_torch_train_step.py, against the reference's fused and
unfused routes, which are bit-equal here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import EXACT_BF16, bf16_ulp, configs, latent_params  # noqa: E402
from repro.configs.base import ArchConfig as JArchConfig  # noqa: E402
from repro.configs.base import BlockDef as JBlockDef  # noqa: E402
from repro.core.policy import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.policy import get_preset  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMoe  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ArchConfig, BlockDef  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.core.policy import get_preset as t_get_preset  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoe  # noqa: E402

ARCH = "granite-moe-1b-a400m"
ROUTES = {"on": "auto", "off": "off"}  # the reference's route -> the port's


def calibrate_routers(tree):
    """Give every router a calibrated 8-bit activation quantizer (scale
    1/16, offset -4: a step well below the spread of its normalized input,
    so its logits do not tie)."""
    if isinstance(tree, dict):
        out = {k: calibrate_routers(v) for k, v in tree.items()}
        if "router" in out:
            r = dict(out["router"])
            r["a_scale"] = np.full(np.shape(r["a_scale"]), 1 / 16, np.float32)
            r["a_offset"] = np.full(np.shape(r["a_offset"]), -4.0, np.float32)
            out["router"] = r
        return out
    if isinstance(tree, tuple):
        return tuple(calibrate_routers(v) for v in tree)
    return tree


def _moe_params(jc, jq, calibrated=True):
    lat = latent_params(jc, jq)
    if calibrated:
        lat = calibrate_routers(lat)
    return jax.tree.map(lambda a: np.asarray(a)[0], lat["groups"][0]["moe"])


def _x(jc, seed=0, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape + (jc.d_model,)).astype(np.float32)


def _jax_moe(p, x, jc, jq):
    pj = jax.tree.map(jnp.asarray, p)
    xb = jnp.asarray(x, jnp.bfloat16)
    f = jax.jit(lambda pp, xx: JMoe.moe_ffn(pp, xx, jc, jq, jnp.bfloat16))
    y, aux = f.lower(pj, xb).compile(EXACT_BF16)(pj, xb)
    return np.asarray(y.astype(jnp.float32)), {k: float(v) for k, v in aux.items()}


def _port_moe(p, x, tc, tq):
    y, aux = TMoe.moe_ffn(bridge._convert(p, "cpu"),
                          torch.from_numpy(x).to(torch.bfloat16), tc, tq,
                          torch.bfloat16)
    return y.float().numpy(), {k: float(v) for k, v in aux.items()}


def _routing(p, x, jc, jq, tc, tq):
    """Both sides' router probabilities, top-k expert indices and keep masks."""
    k, e = jc.moe_top_k, jc.n_experts
    pj = jax.tree.map(jnp.asarray, p)
    xt = jnp.asarray(x, jnp.bfloat16).reshape(-1, jc.d_model)

    def jroute(pp, xx):
        lg = JC.qlinear(pp["router"], xx, "router", jq, "td,de->te",
                        cdtype=jnp.float32)
        probs = jax.nn.softmax(lg, -1)
        _, idx = jax.lax.top_k(probs, k)
        c = JMoe.capacity(xx.shape[0], jc)
        _, _, keep = JMoe._route_group(xx, None, idx, c, e, k, jnp.bfloat16)
        return probs, idx, keep

    jp, ji, jk = (np.asarray(v) for v in
                  jax.jit(jroute).lower(pj, xt).compile(EXACT_BF16)(pj, xt))
    pt = bridge._convert(p, "cpu")
    xtt = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, tc.d_model)
    lg = TC.qlinear(pt["router"], xtt, "router", tq, "td,de->te",
                    cdtype=torch.float32)
    probs = torch.softmax(lg, -1)
    ti = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    _, _, tk = TMoe._route_group(xtt, ti, TMoe.capacity(xtt.shape[0], tc), e,
                                 k, torch.bfloat16)
    return jp, ji, jk, probs.numpy(), ti.numpy(), tk.numpy()


@pytest.mark.parametrize("route", ["on", "off"])
def test_moe_ffn_matches_jax(route):
    jc, tc = configs(ARCH)
    jq = get_preset("w4a4").replace(fused_matmul=route)
    tq = t_get_preset("w4a4").replace(fused_matmul=ROUTES[route])
    p = _moe_params(jc, jq)
    x = _x(jc)
    _, ji, jk, _, ti, tk = _routing(p, x, jc, jq, tc, tq)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tk, jk)
    y_j, aux_j = _jax_moe(p, x, jc, jq)
    for t_route in ("auto", "off"):
        y_t, aux_t = _port_moe(p, x, tc, tq.replace(fused_matmul=t_route))
        np.testing.assert_array_equal(y_t, y_j)
        assert abs(aux_t["lb_loss"] - aux_j["lb_loss"]) <= 1e-6 * abs(aux_j["lb_loss"])
        assert aux_t["drop_frac"] == aux_j["drop_frac"]


def test_router_ties_at_init():
    """At init (router activation scale 1) the reference's logits tie; the
    tokens routed otherwise are among the tied ones."""
    jc, tc = configs(ARCH)
    jq, tq = get_preset("w4a4"), t_get_preset("w4a4")
    p = _moe_params(jc, jq, calibrated=False)
    x = _x(jc, seed=0, shape=(4, 16))
    jp, ji, _, tp, ti, _ = _routing(p, x, jc, jq, tc, tq)
    k = jc.moe_top_k
    differ = np.where((np.sort(ji, -1) != np.sort(ti, -1)).any(-1))[0]
    srt = -np.sort(-jp, -1)
    # a tie of the exact sums may already sit an ulp apart in the reference
    tied = srt[:, k - 1] - srt[:, k] <= 2 * np.spacing(srt[:, k - 1])
    assert tied.any()  # the case this test is about
    assert np.all(tied[differ]), differ[~tied[differ]]
    # the port's probabilities are the reference's to f32 sum order
    assert np.abs(tp - jp).max() <= 1e-6
    # off the ties, the selections are equal
    np.testing.assert_array_equal(ti[~tied], ji[~tied])


def _drop_cfgs():
    common = dict(name="moe-drop", family="moe", n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=2, d_ff=16, vocab_size=64,
                  n_experts=4, moe_top_k=2, capacity_factor=0.1,
                  ffn_gated=False, act="gelu")
    return (JArchConfig(pattern=(JBlockDef(ffn="moe"),), **common),
            ArchConfig(pattern=(BlockDef(ffn="moe"),), **common))


def test_moe_capacity_drops():
    """Mirror of tests/test_recurrent_moe.py::test_moe_capacity_drops, full
    precision and f32: a capacity factor of 0.1 drops (token, slot) pairs
    (to the dump row), the output stays finite, and the port's output,
    lb_loss and drop_frac equal the reference's (output within 1e-5 of its
    largest value: f32 sums in other orders)."""
    jc, tc = _drop_cfgs()
    jq, tq = JQuantConfig(mode="off"), QuantConfig(mode="off")
    p = jax.tree.map(np.asarray, JMoe.moe_init(jax.random.PRNGKey(0), jc, jq))
    x = np.random.default_rng(1).standard_normal((4, 64, 32)).astype(np.float32)
    y_j, aux_j = jax.jit(lambda pp, xx: JMoe.moe_ffn(pp, xx, jc, jq, jnp.float32))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    y_t, aux_t = TMoe.moe_ffn(bridge._convert(p, "cpu"), torch.from_numpy(x),
                              tc, tq, torch.float32)
    assert float(aux_t["drop_frac"]) > 0.0
    assert bool(torch.isfinite(y_t).all())
    assert float(aux_t["drop_frac"]) == float(aux_j["drop_frac"])
    assert abs(float(aux_t["lb_loss"]) - float(aux_j["lb_loss"])) <= 1e-6 * float(aux_j["lb_loss"])
    y_j = np.asarray(y_j)
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())
    assert TMoe.capacity(256, tc) == JMoe.capacity(256, jc) == 16


# name, weight shape, x shape, eq (tests/test_fused_qat_matmul.py:119-121)
EXPERT_LINEARS = {
    "moe_in": ((3, 32, 40), (2, 3, 6, 32), "gecd,edf->gecf"),
    "moe_out": ((3, 40, 32), (2, 3, 6, 40), "gecf,efd->gecd"),
}


def _grad_close(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    err = np.abs(a - b)
    ok = err <= tol * scale
    if not ok.all():  # one bf16 ulp on at most 1% of the elements
        assert np.mean(~ok) <= 0.01, (what, np.mean(~ok))
        ulp = bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
        assert np.all(ok | (err <= 1.01 * ulp)), (what, err.max())


@pytest.mark.parametrize("mode", ["mdq", "lsq"])
@pytest.mark.parametrize("name", sorted(EXPERT_LINEARS))
def test_batched_linear_gradients_match_jax(name, mode):
    """The five cotangents of the batched QAT linear (x, w, w_scale,
    a_scale, a_offset), per-expert scales (mdq) and per-tensor (lsq), on
    the port's kernel route and unfused route, against the reference's
    fused (interpret mode) and unfused routes."""
    shape, xshape, eq = EXPERT_LINEARS[name]
    jq = JQuantConfig(w_bits=4, a_bits=4, mode=mode)
    p = JC.linear_init(jax.random.PRNGKey(3), name, jq, shape, std=0.1,
                       group_axes=(0,))
    assert p["w_scale"].shape == ((3, 1, 1) if mode == "mdq" else ())
    p["a_scale"], p["a_offset"] = jnp.float32(0.3), jnp.float32(0.02)
    p_np = jax.tree.map(np.asarray, p)
    x = np.asarray(jnp.asarray(np.random.default_rng(4).standard_normal(xshape),
                               jnp.bfloat16).astype(jnp.float32))
    ct = np.cos(np.arange(int(np.prod(xshape[:3])) * shape[2])).reshape(
        xshape[:3] + (shape[2],)).astype(np.float32)

    def j_grads(route):
        q = jq.replace(fused_matmul=route)
        def f(pp, xx):
            y = JC.qlinear(pp, xx, name, q, eq)
            return jnp.sum(y.astype(jnp.float32) * ct)
        y = jax.jit(lambda pp, xx: JC.qlinear(pp, xx, name, q, eq)).lower(
            p, jnp.asarray(x, jnp.bfloat16)).compile(EXACT_BF16)(
            p, jnp.asarray(x, jnp.bfloat16))
        g = jax.jit(jax.grad(f, argnums=(0, 1))).lower(
            p, jnp.asarray(x, jnp.bfloat16)).compile(EXACT_BF16)(
            p, jnp.asarray(x, jnp.bfloat16))
        return np.asarray(y.astype(jnp.float32)), jax.tree.map(
            lambda v: np.asarray(v.astype(jnp.float32)), g)

    def t_grads(route):
        q = QuantConfig(w_bits=4, a_bits=4, mode=mode, fused_matmul=route)
        pt = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in p_np.items()}
        xt = torch.from_numpy(np.array(x)).to(torch.bfloat16).requires_grad_(True)
        y = TC.qlinear(pt, xt, name, q, eq)
        (y.float() * torch.from_numpy(ct)).sum().backward()
        return (y.float().detach().numpy(),
                ({k: v.grad.numpy() for k, v in pt.items()},
                 xt.grad.float().numpy()))

    for j_route in ("on", "off"):
        y_j, (gp_j, gx_j) = j_grads(j_route)
        for t_route in ("auto", "off"):
            y_t, (gp_t, gx_t) = t_grads(t_route)
            np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5)
            _grad_close(gx_t, gx_j, 1e-4, (j_route, t_route, "x"))
            for k in gp_j:
                _grad_close(gp_t[k], gp_j[k], 1e-4, (j_route, t_route, k))


def test_batched_linear_takes_the_kernels():
    """Eligibility: per-expert (E,1,1) and per-tensor scales take the
    batched kernels; a K-side expert group and a 1-bit quantizer do not."""
    q = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    w = torch.zeros((3, 32, 40))
    x = torch.zeros((2, 3, 6, 32))
    aspec = TC.act_spec(q, "moe_in")
    wspec = TC.weight_spec(q, "moe_in")
    ok = lambda ss, qq=q, a=aspec, wsp=wspec: TC._fused_eligible_batched(
        qq, a, wsp, "gecd,edf->gecf", {"w_scale": torch.ones(ss), "a_scale": 1}, w, x)
    assert ok((3, 1, 1)) and ok(()) and ok((1, 1, 40)) and ok((3, 1, 40))
    assert not ok((3, 32, 1))
    assert not ok((3, 1, 1), q.replace(fused_matmul="off"))
    q1 = QuantConfig(w_bits=1, a_bits=1, mode="mdq")
    assert not ok((3, 1, 1), q1, TC.act_spec(q1, "moe_in"), TC.weight_spec(q1, "moe_in"))
    assert "td,de->te" not in TC.FUSED_EQS and "td,de->te" not in TC.FUSED_BATCHED_EQS


def test_two_layer_forward_matches_both_jax_routes():
    """Reduced granite-moe (2 layers, tied head) at bf16, calibrated
    routers: the reference's fused and unfused routes give bit-equal logits
    under EXACT_BF16, and the port's kernel route meets the bf16 logits bar
    of tests/test_torch_train_step.py against both."""
    jc, tc = configs(ARCH)
    assert jc.n_layers == 2 and jc.tie_embeddings
    lat = calibrate_routers(latent_params(jc, get_preset("w4a4")))
    tokens = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    params = jax.tree.map(jnp.asarray, lat)
    lg = {}
    for route in ("on", "off"):
        jq = get_preset("w4a4").replace(fused_matmul=route)
        fwd = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jc, jq)[0])
        lg[route] = np.asarray(fwd.lower(params, jnp.asarray(tokens)).compile(
            EXACT_BF16)(params, jnp.asarray(tokens)))
    np.testing.assert_array_equal(lg["on"], lg["off"])
    tparams = bridge.params_from_jax(lat, tc, "cpu")
    with torch.no_grad():
        lg_t = TM.forward(tparams, {"tokens": torch.from_numpy(tokens)}, tc,
                          t_get_preset("w4a4"))[0].numpy()
    assert np.isfinite(lg_t).all()
    for route in ("on", "off"):
        d = np.abs(lg_t - lg[route])
        assert np.quantile(d, 0.9) < 1e-3, np.quantile(d, 0.9)
        assert d.mean() < 0.05, d.mean()
        assert (lg_t.argmax(-1) == lg[route].argmax(-1)).all()


def test_moe_serving_still_refused():
    _, tc = configs(ARCH)
    with pytest.raises(NotImplementedError, match="MoE serving"):
        TM.init_serving_params(tc, t_get_preset("w4a4"),
                               torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="MoE serving"):
        TM.init_cache(tc, t_get_preset("w4a4"), 1, 8, "cpu")
