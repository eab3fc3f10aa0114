"""The port's recurrent blocks (`repro_torch.models.recurrent`) on their
own and against the JAX package's (`repro.models.recurrent`) on the same
numpy inputs and the same parameters (the reference's init, carried over
leaf by leaf).

The first five tests mirror tests/test_recurrent_moe.py:22-90 on the port,
with the reference's bars: chunked (L = 8) against sequential (L = 1)
mLSTM within 2e-3, mLSTM state continuity within 2e-3, sLSTM state
continuity within 1e-4, the RG-LRU scan against single-token decode steps
within 1e-4, the conv state within 1e-5.

Against the reference (every bar relative to the largest |value| of the
reference's tensor):
  * `causal_conv`: bit-equal at bf16, within 1e-6 at f32 (its test says
    why);
  * fp weights at f32, with and without a carried state: the block output
    and every state leaf within 1e-5 (only f32 summation orders differ:
    einsums, the cumulative sum, and the f64 sums the port takes with a
    carried state, `recurrent._ein`);
  * `assoc_scan` against jax.lax.associative_scan: the same recursion, so
    the same products: within 1e-6;
  * w4a4 MDQ at bf16, the reference compiled with excess precision off
    (tests/_torch_parity.py's EXACT_BF16), both sides unfused: the bar of
    tests/test_fused_qat_matmul.py:396-403 on the block output (90th
    percentile |d| < 1e-3, mean < 0.05: the bulk bit-equal, a bf16 ulp
    crossing a quantizer's rounding boundary now and then moving one
    code), and the carried f32 states within 1e-2 of their largest
    value.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import EXACT_BF16  # noqa: E402
from repro.configs.base import ArchConfig as JArch  # noqa: E402
from repro.core.policy import QuantConfig as JQ  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArch  # noqa: E402
from repro_torch.core.policy import QuantConfig as TQ  # noqa: E402
from repro_torch.models import recurrent as TR  # noqa: E402

FP = dict(mode="off")
W4A4 = dict(w_bits=4, a_bits=4, mode="mdq", fused_matmul="off")


def _cfgs(dtype="float32", **kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab_size=64, dtype=dtype,
                lru_width=32, conv_kernel=4)
    base.update(kw)
    return JArch(**base), TArch(**base)


def _to_t(node):
    if isinstance(node, dict):
        return {k: _to_t(v) for k, v in node.items()}
    return bridge.to_torch(np.asarray(node), "cpu")


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return bridge.to_numpy(x)
    return np.asarray(x, np.float32)


def _calibrated(p):
    """Activation quantizers at scale 0.1, offset -0.5 (the init's 1 and 0
    would clip every normalized input to a handful of codes)."""
    if isinstance(p, dict):
        out = {k: _calibrated(v) for k, v in p.items()}
        if "a_scale" in out:
            out["a_scale"] = jnp.full((), 0.1, jnp.float32)
        if "a_offset" in out:
            out["a_offset"] = jnp.full((), -0.5, jnp.float32)
        return out
    return p


def _params(kind, jcfg, jq):
    init = {"mlstm": JR.mlstm_init, "slstm": JR.slstm_init,
            "rglru": JR.rglru_init}[kind]
    p = _calibrated(init(jax.random.PRNGKey(3), jcfg, jq))
    return p, _to_t(jax.tree.map(np.asarray, p))


def _close(got, want, tol, what=""):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}/{k}")
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


def _x(shape, seed=0, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the reference's own five cases, on the port
# ---------------------------------------------------------------------------

def _tparams(kind, tcfg, seed=0):
    init = {"mlstm": TR.mlstm_init, "slstm": TR.slstm_init,
            "rglru": TR.rglru_init}[kind]
    return init(torch.Generator().manual_seed(seed), tcfg, TQ(**FP))


def test_mlstm_chunk_invariance():
    """Chunked (L = 8) == fully sequential (L = 1) mLSTM."""
    _, cfg = _cfgs()
    p = _tparams("mlstm", cfg)
    x = torch.from_numpy(_x((2, 16, 32)))
    y8, _ = TR.mlstm_block(p, x, cfg, TQ(**FP), torch.float32, chunk=8)
    y1, _ = TR.mlstm_block(p, x, cfg, TQ(**FP), torch.float32, chunk=1)
    np.testing.assert_allclose(y8.numpy(), y1.numpy(), rtol=2e-3, atol=2e-3)


def test_mlstm_state_continuity():
    """Processing [a; b] == processing a then b with the carried state."""
    _, cfg = _cfgs()
    q = TQ(**FP)
    p = _tparams("mlstm", cfg)
    x = torch.from_numpy(_x((1, 16, 32)))
    y_full, st_full = TR.mlstm_block(p, x, cfg, q, torch.float32, collect=True,
                                     chunk=4)
    st = TR.mlstm_fresh_state(cfg, 1)
    y1, st = TR.mlstm_block(p, x[:, :8], cfg, q, torch.float32, state=st, chunk=4)
    y2, st = TR.mlstm_block(p, x[:, 8:], cfg, q, torch.float32, state=st, chunk=4)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(st["C"].numpy(), st_full["C"].numpy(),
                               rtol=2e-3, atol=2e-3)


def test_slstm_state_continuity():
    _, cfg = _cfgs()
    q = TQ(**FP)
    p = _tparams("slstm", cfg)
    x = torch.from_numpy(_x((2, 12, 32)))
    y_full, st_full = TR.slstm_block(p, x, cfg, q, torch.float32, collect=True)
    st = TR.slstm_state_init(2, cfg.n_heads, cfg.d_model // cfg.n_heads)
    y1, st = TR.slstm_block(p, x[:, :5], cfg, q, torch.float32, state=st)
    y2, st = TR.slstm_block(p, x[:, 5:], cfg, q, torch.float32, state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st["c"].numpy(), st_full["c"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_rglru_assoc_scan_vs_loop():
    """The associative scan == single-token decode steps."""
    _, cfg = _cfgs()
    q = TQ(**FP)
    p = _tparams("rglru", cfg)
    x = torch.from_numpy(_x((1, 10, 32)))
    y, st = TR.rglru_block(p, x, cfg, q, torch.float32, collect=True)
    st_d = TR.rglru_state_init(1, 32, 4)
    ys = []
    for t in range(10):
        yt, st_d = TR.rglru_block(p, x[:, t:t + 1], cfg, q, torch.float32,
                                  state=st_d)
        ys.append(yt)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y.numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st_d["h"].numpy(), st["h"].numpy(), rtol=1e-4,
                               atol=1e-4)


def test_causal_conv_state():
    w = torch.from_numpy(_x((8, 4), 1, 1.0))
    x = torch.from_numpy(_x((2, 10, 8), 2, 1.0))
    y_full, _ = TR.causal_conv(x, w)
    y1, st = TR.causal_conv(x[:, :6], w)
    y2, _ = TR.causal_conv(x[:, 6:], w, state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stateful", [False, True])
def test_causal_conv_matches_jax(dtype, stateful):
    """The same products summed in the same order (j = 0..K-1), each op
    rounded to the input's dtype: bit-equal at bf16; at f32 within 1e-6 of
    the largest |y| (XLA's CPU code fuses a multiply and the add after it
    into one fused multiply-add, rounding once where the port rounds
    twice)."""
    w = _x((8, 4), 1, 1.0)
    x = _x((2, 10, 8), 2, 1.0)
    st = _x((2, 3, 8), 3, 1.0) if stateful else None
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    fn = jax.jit(lambda x, w, s: JR.causal_conv(x, w, s))
    jx = jnp.asarray(x, jd)
    args = (jx, jnp.asarray(w), None if st is None else jnp.asarray(st))
    jy, js = fn.lower(*args).compile(EXACT_BF16)(*args)
    ty, ts = TR.causal_conv(torch.from_numpy(x).to(td), torch.from_numpy(w),
                            None if st is None else torch.from_numpy(st))
    assert ty.dtype == td and ts.dtype == td
    np.testing.assert_array_equal(_np(ts), _np(js))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(ty), _np(jy))
    else:
        _close(ty, jy, 1e-6)


def test_assoc_scan_matches_jax():
    a = np.random.default_rng(4).uniform(0.5, 1.0, (2, 37, 5)).astype(np.float32)
    b = _x((2, 37, 5), 5, 1.0)

    def combine(e1, e2):
        return e1[0] * e2[0], e2[0] * e1[1] + e2[1]

    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(b))
    ta, tb = TR.assoc_scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(ta, ja, 1e-6)
    _close(tb, jb, 1e-6)


def _state_args(kind, jcfg, b, seed):
    """A carried state with live values: the block run over 6 tokens from
    its fresh state, on the reference."""
    d = jcfg.d_model
    if kind == "mlstm":
        st = JR.mlstm_fresh_state(jcfg, b)
    elif kind == "slstm":
        st = JR.slstm_state_init(b, jcfg.n_heads, d // jcfg.n_heads)
    else:
        st = JR.rglru_state_init(b, jcfg.lru_width, jcfg.conv_kernel)
    return st, _x((b, 6, d), seed)


def _block(kind, pkg):
    mod = JR if pkg == "jax" else TR
    return {"mlstm": mod.mlstm_block, "slstm": mod.slstm_block,
            "rglru": mod.rglru_block}[kind]


def _run_pair(kind, quant, dtype, stateful, seq=16):
    jcfg, tcfg = _cfgs(dtype)
    jq, tq = JQ(**quant), TQ(**quant)
    jp, tp = _params(kind, jcfg, jq)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = _x((2, seq, jcfg.d_model), 7)
    kw = {"chunk": 8} if kind == "mlstm" else {}
    jfn = jax.jit(lambda p, x, st: _block(kind, "jax")(
        p, x, jcfg, jq, jd, state=st, collect=st is None, **kw))
    st = None
    if stateful:
        st, warm = _state_args(kind, jcfg, 2, 8)
        wargs = (jp, jnp.asarray(warm, jd), st)
        _, st = jfn.lower(*wargs).compile(EXACT_BF16)(*wargs)
    args = (jp, jnp.asarray(x, jd), st)
    jy, jst = jfn.lower(*args).compile(EXACT_BF16)(*args)
    tst = None if st is None else _to_t(jax.tree.map(np.asarray, st))
    ty, tnew = _block(kind, "port")(tp, torch.from_numpy(x).to(td), tcfg, tq,
                                    td, state=tst, collect=tst is None, **kw)
    return (jy, jst), (ty, tnew)


@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_block_matches_jax_fp32(kind, stateful):
    (jy, jst), (ty, tst) = _run_pair(kind, FP, "float32", stateful)
    assert ty.dtype == torch.float32
    _close(ty, jy, 1e-5, "y")
    _close(tst, jst, 1e-5, "state")


@pytest.mark.parametrize("stateful", [False, True])
@pytest.mark.parametrize("kind", ["mlstm", "slstm", "rglru"])
def test_block_matches_jax_w4a4_bf16(kind, stateful):
    (jy, jst), (ty, tst) = _run_pair(kind, W4A4, "bfloat16", stateful)
    assert ty.dtype == torch.bfloat16
    t, j = _np(ty), _np(jy)
    d = np.abs(t - j)
    assert np.isfinite(t).all()
    assert np.quantile(d, 0.9) < 1e-3, np.quantile(d, 0.9)
    assert d.mean() < 0.05, d.mean()
    _close(tst, jst, 1e-2, "state")


def test_quantized_recurrent_mix_matches_jax():
    """The sLSTM's s_r read through quantized_weight at w4a4 (fake-quant)
    and as serving int codes: the same (4, h, dh, dh) weight on both
    sides."""
    from repro.models.common import convert_to_serving as j_convert
    from repro.models.common import quantized_weight as j_qw
    from repro_torch.models.common import quantized_weight as t_qw
    jcfg, _ = _cfgs()
    jq, tq = JQ(**W4A4), TQ(**W4A4)
    jp, tp = _params("slstm", jcfg, jq)
    np.testing.assert_array_equal(_np(t_qw(tp["s_r"], "s_r", tq)),
                                  _np(j_qw(jp["s_r"], "s_r", jq)))
    js = j_convert(jp, jq)["s_r"]
    assert "codes4" in js
    ts = _to_t(jax.tree.map(np.asarray, js))
    np.testing.assert_array_equal(_np(t_qw(ts, "s_r", tq)),
                                  _np(j_qw(js, "s_r", jq)))
