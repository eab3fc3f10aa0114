"""One QAT train step of the port against the JAX package's, on the same
latent params (`_torch_parity.latent_params`), batch and MCKD labels:
reduced qwen1.5-0.5b (tied head, QKV bias), reduced granite-8b with GQA
(kv heads 2, untied head) and, for the step itself, reduced gemma2-2b
(local layers, sandwich norms, softcaps, gelu), w4a4.

Bars, at fused_matmul="off" and cfg.dtype="float32" on both sides (only
summation orders differ):
  * loss within 1e-5 relative;
  * every gradient leaf (w_scale / a_scale / a_offset included) within 1e-4
    of its largest |g|; the lm head's weight gradient (the embedding's, when
    tied) leaves the head's bf16 einsum rounded to bf16 from f32 sums taken
    in other orders, so up to 1% of its elements may differ by one bf16 ulp; a weight scale's gradient is a sum over its group
    with much cancellation (a per-tensor 8-bit edge scale sums ~17k terms
    to ~1e-4 of their magnitude), so it is normalized by the larger of
    itself and its sum of |summands| g * sum |dL/dw * (q - w/s)|;
  * after AdamW, mu and sqrt(nu) (the quantity the update divides by; it
    scales with |g| as mu does) within 1e-4 of their largest value, with
    the weight-scale normalizer and the head's ulp carried through, and the
    updated params within 1e-6 absolute on the elements whose gradient
    exceeds 1e-3 * max|g| of the leaf (Adam's first step is ~lr * sign(g),
    so a near-zero gradient whose sign differs moves by up to 2 * lr).
For this comparison the reference's loss (its `make_loss_fn`: MCKD
sparse soft-CE + lb_coef * lb_loss) is taken without remat and with its two
layers unrolled (a three-block pattern of the same block puts them in its
"tail" instead of a lax.scan): compiled with a scan or with jax.checkpoint,
XLA resolves exact clip-edge ties (u = -Q_N, where the 8-bit embedding
holds code 0 and the offsets start at 0) otherwise than the same code run
eagerly, moving reduced qwen's first-token embedding gradient by up to ~2%
of max|g|. Eager, unrolled without remat, the reference is fast to compile
and the port (remat on or off, bit-equal) equals it. At bf16 the forward logits meet the bar of
tests/test_fused_qat_matmul.py:396-403 (XLA compiled with excess precision
off). Inside the port: the
kernel route against the unfused route, remat on vs off (bit-equal),
grad_accum=2 against one full batch, and the sentinel skipping a
NaN-poisoned step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import EXACT_BF16, bf16_ulp, train_batch, train_states  # noqa: E402
from repro.core import kd as j_kd  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import schedule as j_schedule  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import quantizer as TQ  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import sentinel as TS  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "granite-8b"]
# + gemma2: local (sliding-window) layers through attend_local_chunked,
# sandwich norms, attention and final softcaps, gelu
STEP_ARCHS = ARCHS + ["gemma2-2b"]
TRAIN = dict(kd="mckd", total_steps=10, warmup_steps=0)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves_jax_layout(tree, cfg):
    """Flatten a port tree in the JAX layout, keyed by path."""
    return {T.path_str(p): v for p, v in T.flatten(bridge.tree_to_jax_layout(tree, cfg))}


def _leaves_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32) for p, v in flat}


def _normalized_close(got: dict, want: dict, tol: float, what: str,
                      norms: dict = None, allow: dict = None):
    """Each leaf within tol of its largest |value| (or of norms[k] where
    given); allow[k], where given, is an element-wise allowance that at most
    1% of the leaf's elements may use instead."""
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        scale = float(np.abs(want[k]).max())
        if norms and k in norms:
            scale = np.maximum(np.abs(want[k]), norms[k])
        err = np.abs(got[k] - want[k])
        ok = err <= tol * np.maximum(scale, 1e-30)
        if allow and k in allow:
            assert np.mean(~ok) <= 0.01, (what, k, np.mean(~ok))
            ok |= err <= allow[k]
        assert np.all(ok), (what, k, err.max())


HEAD_LEAVES = ("lm_head/w", "embed/w")  # the head's dW leaves this einsum in bf16


def _w_scale_norms(params: dict, grads: dict, qcfg) -> dict:
    """For every w_scale leaf (JAX layout, numpy), the sum over its scale
    group of |summands| of its gradient: g * sum |dL/dw * (q - w/s)| with
    g = 1 / sqrt(Q_P * ||w||_1) per group (module_l1)."""
    out = {}
    for k, s in params.items():
        if not k.endswith("/w_scale"):
            continue
        w, dw = params[k[:-len("w_scale")] + "w"], grads[k[:-len("w_scale")] + "w"]
        stacked = k.startswith("groups/")
        edge = k.split("/")[0] in ("embed", "lm_head")
        bits = 8 if edge else qcfg.w_bits
        q_n, q_p = 2 ** (bits - 1), 2 ** (bits - 1) - 1
        sb = s.reshape(s.shape + (1,) * (w.ndim - s.ndim)) if s.ndim < w.ndim else s
        axes = tuple(i for i in range(int(stacked), w.ndim) if sb.shape[i] == 1)
        u = w / np.maximum(sb, 1e-9)
        q = np.clip(np.round(u), -q_n, q_p)
        g = 1.0 / np.sqrt(q_p * np.sum(np.abs(w), axis=axes, keepdims=True))
        l1 = g * np.sum(np.abs(dw * (q - u)), axis=axes, keepdims=True)
        out[k] = l1.reshape(s.shape)
    return out


@pytest.fixture(scope="module", params=STEP_ARCHS)
def stepped(request):
    """Both sides' loss, grads and one updated state, f32, unfused."""
    arch = request.param
    (jc, tc), (jq, tq), (jt, tt), jstate, tstate = train_states(
        arch, unrolled=True, **TRAIN)
    assert jc.n_groups == 0 and jc.n_tail == 2
    b = train_batch(jc)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    def j_loss_fn(params):  # the reference's loss_fn, without remat (docstring)
        logits, aux = JM.forward(params, jb, jc, jq, remat=False)
        return (j_kd.sparse_soft_ce(logits, jb["kd_idx"], jb["kd_p"])
                + jt.lb_coef * aux["lb_loss"])

    j_loss, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(jstate["params"])
    # the rest of the reference's train_step on a healthy step: its AdamW
    # update at its scheduled learning rate
    lr = j_schedule.warmup_cosine(jstate["step"], peak=jt.adamw.lr_peak,
                                  warmup_steps=jt.warmup_steps,
                                  total_steps=jt.total_steps)
    j_params, j_opt, j_m = jax.jit(j_adamw.update, static_argnums=5)(
        j_grads, j_adamw.AdamWState(jstate["mu"], jstate["nu"]),
        jstate["params"], jstate["step"], lr, jt.adamw)
    j_new = {"params": j_params, "mu": j_opt.mu, "nu": j_opt.nu}
    j_m["loss"] = j_loss
    t_loss, _, t_grads = TT.make_grad_fn(tc, tq, tt)(tstate["params"],
                                                     _torch_batch(b),
                                                     tstate["step"])
    old = T.map_tree(torch.clone, tstate["params"])
    t_new, t_m = TT.make_train_step(tc, tq, tt)(tstate, _torch_batch(b))
    j_grads = _leaves_jax(j_grads)
    norms = _w_scale_norms(_leaves_jax(jstate["params"]), j_grads, jq)
    t_flat = _leaves_jax_layout(t_grads, tc)
    head_ulps = {k: bf16_ulp(np.maximum(np.abs(j_grads[k]), np.abs(t_flat[k])))
                 for k in HEAD_LEAVES if k in j_grads}
    return dict(arch=arch, tc=tc, j_loss=float(j_loss), t_loss=float(t_loss),
                j_grads=j_grads, w_scale_norms=norms, head_ulps=head_ulps,
                t_grads=t_flat, j_new=j_new,
                t_new=t_new, old=old, j_m=j_m, t_m=t_m)


def test_loss_matches_jax(stepped):
    assert abs(stepped["t_loss"] - stepped["j_loss"]) <= 1e-5 * abs(stepped["j_loss"])
    assert abs(float(stepped["t_m"]["loss"]) - float(stepped["j_m"]["loss"])) \
        <= 1e-5 * abs(float(stepped["j_m"]["loss"]))


def test_every_gradient_matches_jax(stepped):
    got, want = stepped["t_grads"], stepped["j_grads"]
    assert any(k.endswith("w_scale") for k in want)
    assert any(k.endswith("a_offset") for k in want)
    _normalized_close(got, want, 1e-4, "grads", stepped["w_scale_norms"],
                      stepped["head_ulps"])


def test_adamw_update_matches_jax(stepped):
    tc = stepped["tc"]
    # mu = (1 - b1) c g and nu = (1 - b2) c^2 g^2 after one step (c: the
    # global-norm clip factor): a weight scale's normalizer carries over
    c = min(1.0, 1.0 / max(float(stepped["j_m"]["grad_norm"]), 1e-9))
    g, s_ = stepped["j_grads"], stepped["w_scale_norms"]
    # nu is compared as sqrt(nu) (what the update divides by), which scales
    # with |g| as mu does
    r = np.sqrt(1e-3)
    norms = {"mu": {k: 0.1 * c * v for k, v in s_.items()},
             "nu": {k: r * c * v for k, v in s_.items()}}
    u = {k: 1.01 * v for k, v in stepped["head_ulps"].items()}  # + f32 ops
    allow = {"mu": {k: 0.1 * c * v for k, v in u.items()},
             "nu": {k: r * c * v for k, v in u.items()}}
    for key in ("mu", "nu"):
        got = _leaves_jax_layout(stepped["t_new"][key], tc)
        want = _leaves_jax(stepped["j_new"][key])
        if key == "nu":
            got = {k: np.sqrt(v) for k, v in got.items()}
            want = {k: np.sqrt(v) for k, v in want.items()}
        _normalized_close(got, want, 1e-4, key, norms[key], allow[key])
    got = _leaves_jax_layout(stepped["t_new"]["params"], tc)
    want = _leaves_jax(stepped["j_new"]["params"])
    grads = stepped["j_grads"]
    for k in want:
        live = np.abs(grads[k]) > 1e-3 * np.abs(grads[k]).max()
        err = np.abs(got[k] - want[k])[live]
        assert err.size == 0 or err.max() <= 1e-6, (k, err.max())
    assert int(stepped["t_new"]["step"]) == 1
    assert int(stepped["t_m"]["health"]) == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_logits_match_jax(arch):
    (jc, tc), (jq, tq), _, jstate, tstate = train_states(arch, dtype="bfloat16",
                                                         sentinel=False)
    b = train_batch(jc)
    fwd = jax.jit(lambda p, t: JM.forward(p, {"tokens": t}, jc, jq)[0])
    lg_j = np.asarray(fwd.lower(jstate["params"], jnp.asarray(b["tokens"]))
                      .compile(EXACT_BF16)(jstate["params"], jnp.asarray(b["tokens"])))
    with torch.no_grad():
        lg_t = TM.forward(tstate["params"], _torch_batch(b), tc, tq)[0].numpy()
    v = tc.vocab_size
    d = np.abs(lg_t - lg_j)
    assert np.isfinite(lg_t).all()
    assert np.quantile(d, 0.9) < 1e-3, np.quantile(d, 0.9)
    assert d.mean() < 0.05, d.mean()
    p_t = torch.softmax(torch.from_numpy(np.array(lg_t[..., :v])), -1)
    p_j = torch.softmax(torch.from_numpy(np.array(lg_j[..., :v])), -1)
    assert float((p_t - p_j).abs().max()) < 0.02
    assert (lg_t.argmax(-1) == lg_j.argmax(-1)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_matches_unfused_route(arch, monkeypatch):
    """The port's fused QAT route (plain kernel versions on the CPU) against
    its unfused composition, at init and at bf16 (the route's dtype: the
    kernels round the dequantized tiles to bf16 as the unfused bf16 einsum
    does), at the bars of the JAX comparison above. At init the forward is
    exact (scales 1, offsets 0: integer codes times bf16 weights sum without
    rounding), so the routes differ only where a quantizer input sits
    exactly on the clip edge (u = -Q_N: exact zeros from the 8-bit
    embedding's code 0, from bf16 underflow in silu), where the reference's
    kernels pass the whole gradient and its unfused clip half (the test
    below). The unfused route is therefore run with the kernels' edge rule
    (torch.clamp passes the whole gradient at the edge, with the same
    forward): what remains is summation order."""
    (_, tc), (_, tq), (_, tt), _, tstate = train_states(arch, dtype="bfloat16",
                                                        **TRAIN)
    b = _torch_batch(train_batch(tc))
    out = {}
    for route in ("auto", "off"):
        if route == "off":
            monkeypatch.setattr(TQ, "_clip", torch.clamp)
        grad_fn = TT.make_grad_fn(tc, tq.replace(fused_matmul=route), tt)
        loss, _, grads = grad_fn(tstate["params"], b, tstate["step"])
        out[route] = (float(loss), _leaves_jax_layout(grads, tc))
    assert abs(out["auto"][0] - out["off"][0]) <= 1e-5 * abs(out["off"][0])
    want = out["off"][1]
    norms = _w_scale_norms(_leaves_jax_layout(tstate["params"], tc), want, tq)
    _normalized_close(out["auto"][1], want, 1e-4, "kernel vs off", norms)


@pytest.mark.parametrize("framework", ["jax", "port"])
def test_routes_differ_at_the_clip_edge(framework):
    """A reference property the port keeps: where u = (x - b) / s lies
    exactly on the lower clip edge -Q_N (x == b for unsigned activations),
    the fused kernels' Eq. 6 mask passes the whole gradient (u >= -Q_N),
    while the unfused composition's clip (maximum then minimum) splits it,
    passing half."""
    x = np.array([[0.0, 0.5, -0.25, 3.0]], np.float32)
    w = np.full((4, 2), 0.25, np.float32)
    p = {"w": w, "w_scale": np.float32(0.125), "a_scale": np.float32(1.0),
         "a_offset": np.float32(0.0)}
    grads = {}
    for route in ("on", "off"):
        if framework == "jax":
            from repro.core.policy import QuantConfig as JQC
            from repro.models import common as JC
            q = JQC(w_bits=4, a_bits=4, mode="mdq", fused_matmul=route)
            g = jax.grad(lambda xx: jnp.sum(JC.qlinear(
                {k: jnp.asarray(v) for k, v in p.items()}, xx, "w_in", q,
                "bsd,df->bsf", jnp.float32)))(jnp.asarray(x)[None])
            grads[route] = np.asarray(g)[0]
        else:
            from repro_torch.core.policy import QuantConfig as TQC
            from repro_torch.models import common as TCm
            q = TQC(w_bits=4, a_bits=4, mode="mdq",
                    fused_matmul="auto" if route == "on" else "off")
            xx = torch.tensor(x)[None].requires_grad_(True)
            TCm.qlinear({k: torch.tensor(v) for k, v in p.items()}, xx, "w_in",
                        q, "bsd,df->bsf", torch.float32).sum().backward()
            grads[route] = xx.grad.numpy()[0]
    np.testing.assert_array_equal(grads["on"][0, 1:], grads["off"][0, 1:])
    assert grads["on"][0, 0] == 2 * grads["off"][0, 0] != 0


def test_remat_is_bit_equal():
    (_, tc), (_, tq), _, _, tstate = train_states("qwen1.5-0.5b",
                                                  dtype="bfloat16")
    b = _torch_batch(train_batch(tc))
    res = []
    for remat in (True, False):
        leaves = [p.detach().requires_grad_(True) for p in T.leaves(tstate["params"])]
        params = T.unflatten(tstate["params"], leaves)
        logits, _ = TM.forward(params, b, tc, tq.replace(fused_matmul="auto"),
                               remat=remat)
        loss = (logits.float() * torch.cos(torch.arange(logits.shape[-1]).float())).sum()
        res.append((logits.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(res[0][0], res[1][0])
    for a, b_ in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b_)


def test_grad_accum_equals_full_batch():
    """grad_accum=2 against one batch of 4 (granite: untied head), loss and
    every gradient within 1e-5 normalized (weight scales as above)."""
    (_, tc), (_, tq), (_, tt), _, tstate = train_states("granite-8b", **TRAIN)
    b = _torch_batch(train_batch(tc, batch=4))
    full = TT.make_grad_fn(tc, tq, tt)(tstate["params"], b, tstate["step"])
    acc = TT.make_grad_fn(tc, tq, tt.replace(grad_accum=2))(
        tstate["params"], b, tstate["step"])
    assert abs(float(acc[0]) - float(full[0])) <= 1e-5 * abs(float(full[0]))
    want = _leaves_jax_layout(full[2], tc)
    got = _leaves_jax_layout(acc[2], tc)
    norms = _w_scale_norms(_leaves_jax_layout(tstate["params"], tc), want, tq)
    # the lm head's weight gradient comes out of its bf16 einsum rounded to
    # bf16, once per microbatch and once for the full batch: each element
    # within half a bf16 ulp of each of the three; every other leaf is
    # summed in f32
    head = want.pop("lm_head/w")
    d = np.abs(got.pop("lm_head/w") - head)
    halves = [TT.make_grad_fn(tc, tq, tt)(
        tstate["params"], {k: v[i * 2:(i + 1) * 2] for k, v in b.items()},
        tstate["step"])[2]["lm_head"]["w"].numpy() for i in range(2)]
    bound = 0.5 * (bf16_ulp(head) + bf16_ulp(halves[0]) + bf16_ulp(halves[1]))
    assert np.all(d <= np.maximum(1e-5 * np.abs(head).max(), bound))
    _normalized_close(got, want, 1e-5, "accum", norms)


def test_nan_poisoned_step_is_skipped():
    (_, tc), (_, tq), (_, tt), _, tstate = train_states("qwen1.5-0.5b", **TRAIN)
    tstate["params"]["final_norm"]["g"][0] = float("nan")
    before = T.map_tree(torch.clone, {k: tstate[k] for k in ("params", "mu", "nu")})
    new, m = TT.make_train_step(tc, tq, tt)(tstate, _torch_batch(train_batch(tc)))
    health = int(m["health"])
    assert health & TS.NONFINITE_LOSS and health & TS.NONFINITE_GRAD
    assert int(new["sent"].skipped) == 1 and int(new["sent"].obs) == 0
    for k, tree in before.items():
        for a, b_ in zip(T.leaves(tree), T.leaves(new[k])):
            assert torch.equal(a, b_) or (torch.isnan(a) == torch.isnan(b_)).all() \
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b_))


def _warm(ema=1.0, var=0.01, obs=100):
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    i = lambda v: torch.tensor(v, dtype=torch.int32)
    return TS.SentinelState(loss_ema=f(ema), loss_sq=f(var + ema ** 2),
                            obs=i(obs), lr_scale=f(1.0), skipped=i(0))


GRADS = {"a": torch.ones((3,)), "b": (torch.zeros((2, 2)),)}


def _scale_leaves(scale):
    return [(torch.ones((4, 4)), torch.full((), scale), None)]


def test_sentinel_nonfinite_loss_detected():
    """Mirror of tests/test_sentinel.py::test_nonfinite_loss_detected."""
    bits, fatal, st = TS.health_check(torch.tensor(float("nan")), GRADS,
                                      _scale_leaves(0.1), None, _warm(),
                                      TS.SentinelConfig())
    assert int(bits) & TS.NONFINITE_LOSS and bool(fatal)
    assert int(st.skipped) == 1
    assert float(st.loss_ema) == 1.0 and int(st.obs) == 100


def test_sentinel_scale_collapse_and_explode():
    """Mirror of tests/test_sentinel.py::test_scale_collapse_and_explode."""
    cfg = TS.SentinelConfig()
    for scale, bit in ((0.0, TS.SCALE_COLLAPSE), (1e6, TS.SCALE_EXPLODE),
                       (float("nan"), TS.SCALE_COLLAPSE)):
        bits, fatal, _ = TS.health_check(torch.tensor(1.0), GRADS,
                                         _scale_leaves(scale), None, _warm(), cfg)
        assert int(bits) & bit and bool(fatal)
