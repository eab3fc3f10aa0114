"""The plain versions of the QAT kernels (repro_torch.kernels.ref, which the
wrappers take for CPU tensors) against the JAX package's Pallas kernels in
interpret mode, on the same numpy inputs, at ragged M/K/N (the JAX side is
padded to its tiles as its `ops` does; the port masks), both weight-scale
sides and both cotangent roundings.

Bars: the forward within 1e-5 * max|y| (only the f32 summation order
differs). dX and dW are rounded through bf16 from f32 accumulators summed in
other orders, so an element may land on a neighbouring bf16 value: each
element within one bf16 ulp plus the order-independent bound on two f32
sums of the same L products (2 * L * 2**-24 * sum|products|), and at most 1%
of the elements differing at all. The scale sums dsa, dba and dws within
1e-4 of the sum of |summands| of each.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bf16_ulp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

QS = dict(q_n_a=0, q_p_a=15, q_n_w=8, q_p_w=7)  # 4-bit LSQ+ acts, 4-bit weights


def _inputs(m, k, n, k_side, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    ws = (rng.random((k, 1) if k_side else (1, n)) * 0.05 + 0.02).astype(np.float32)
    ws.flat[0] = 0.0  # exercises the max(scale, 1e-9) floor
    dy = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, np.float32(0.3), np.float32(-0.2), ws, dy


def _jax_kernel(fn, dy, x, w, a_s, a_b, ws, k_side, **kw):
    """A Pallas kernel on operands padded as the JAX package's ops pads
    them (x to (bm, bk), w to (bk, bn), dy to (bm, bn); scales with 1)."""
    m, k = x.shape
    n = w.shape[1]
    bm, bn, bk = jqmm.DEFAULT_TILES
    xp, _, _ = jops._pad2d(jnp.asarray(x), bm, bk)
    wp, _, _ = jops._pad2d(jnp.asarray(w), bk, bn)
    wsp = jops._pad_w_scale(jnp.asarray(ws).reshape(-1), k_side, k, n,
                            wp.shape[0], wp.shape[1])
    args = (xp, wp, a_s, a_b, wsp)
    if dy is not None:
        dyp, _, _ = jops._pad2d(jnp.asarray(dy), bm, bn)
        args = (dyp,) + args
    out = fn(*args, interpret=True, **kw)
    return out


def _assert_bf16_close(t, j, abs_products, length):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    tol = bf16_ulp(np.maximum(np.abs(t), np.abs(j))) + 2 * length * 2.0 ** -24 * abs_products
    assert np.all(np.abs(t - j) <= tol), np.max(np.abs(t - j) - tol)
    assert np.mean(t != j) <= 0.01, np.mean(t != j)


def _parts(x, w, a_s, a_b, ws, dy, round_cot):
    """The plain version's intermediates, for the bars' normalizers."""
    tx, tw, tws = (torch.from_numpy(v) for v in (x, w, ws))
    _, _, xd = ref._act_codes(tx, torch.tensor(a_s), torch.tensor(a_b),
                              QS["q_n_a"], QS["q_p_a"])
    _, _, wd = ref._weight_codes(tw, tws, QS["q_n_w"], QS["q_p_w"])
    cot = ref._cotangent(torch.from_numpy(dy), round_cot)
    return xd, wd, cot


SHAPES = [(37, 130, 90), (5, 700, 130), (130, 64, 257)]


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_side", [False, True], ids=["cols", "rows"])
@pytest.mark.parametrize("mkn", SHAPES)
def test_forward_plain_matches_pallas(mkn, k_side, xdtype):
    x, w, a_s, a_b, ws, _ = _inputs(*mkn, k_side, seed=sum(mkn))
    xj = jnp.asarray(x, dtype=xdtype)
    m, n = mkn[0], mkn[2]
    y_j = np.asarray(_jax_kernel(jqmm.quant_matmul, None, xj, w, a_s, a_b, ws,
                                 k_side, **QS))[:m, :n]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if xdtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    y_t = qmm.quant_matmul(xt, torch.from_numpy(w), torch.tensor(a_s),
                           torch.tensor(a_b), torch.from_numpy(ws), **QS).numpy()
    assert y_t.shape == (m, n) and y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


BWD_CASES = [((37, 130, 90), False, True), ((37, 130, 90), True, False),
             ((5, 700, 130), True, True), ((130, 64, 257), False, False)]


@pytest.mark.parametrize("mkn,k_side,round_cot", BWD_CASES,
                         ids=["cols-bf16cot", "rows-f32cot", "rows-bf16cot",
                              "cols-f32cot"])
def test_backward_plain_matches_pallas(mkn, k_side, round_cot):
    """quant_matmul_dx and quant_matmul_dw (the split route) and the
    combined quant_matmul_bwd, each against its Pallas kernel."""
    m, k, n = mkn
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, k_side, seed=m + k + n + 1)
    kw = dict(round_cot=round_cot, **QS)
    j_dx, j_dsa, j_dba = _jax_kernel(jqmm.quant_matmul_dx, dy, x, w, a_s, a_b,
                                     ws, k_side, **kw)
    j_dw, j_dws = _jax_kernel(jqmm.quant_matmul_dw, dy, x, w, a_s, a_b, ws,
                              k_side, **kw)
    j_all = _jax_kernel(jqmm.quant_matmul_bwd, dy, x, w, a_s, a_b, ws, k_side,
                        **kw)
    targs = [torch.from_numpy(v) if isinstance(v, np.ndarray) else torch.tensor(v)
             for v in (dy, x, w, a_s, a_b, ws)]
    t_dx, t_dsa, t_dba = qmm.quant_matmul_dx(*targs, **kw)
    t_dw, t_dws = qmm.quant_matmul_dw(*targs, **kw)
    t_all = qmm.quant_matmul_bwd(*targs, **kw)

    xd, wd, cot = _parts(x, w, a_s, a_b, ws, dy, round_cot)
    dx_abs = (cot.abs() @ wd.abs().T).numpy()
    dw_abs = (xd.abs().T @ cot.abs()).numpy()
    u_x, q_x, _ = ref._act_codes(torch.from_numpy(x), torch.tensor(a_s),
                                 torch.tensor(a_b), QS["q_n_a"], QS["q_p_a"])
    mf_x = ref._in_range(u_x, QS["q_n_a"], QS["q_p_a"])
    dxd = ref._bf16(cot @ wd.T)
    l1_dsa = float(torch.sum(torch.abs(dxd * (q_x - mf_x * u_x))))
    l1_dba = float(torch.sum(torch.abs(dxd * (1 - mf_x))))
    u_w, q_w, _ = ref._weight_codes(torch.from_numpy(w), torch.from_numpy(ws),
                                    QS["q_n_w"], QS["q_p_w"])
    mf_w = ref._in_range(u_w, QS["q_n_w"], QS["q_p_w"])
    part = torch.abs(ref._bf16(xd.T @ cot) * (q_w - mf_w * u_w))
    l1_dws = torch.sum(part, dim=1 if k_side else 0, keepdim=True).numpy()

    for got in ((t_dx, t_dsa, t_dba, t_dw, t_dws), t_all):
        for want_dx, want_dsa, want_dba in ((j_dx, j_dsa, j_dba), j_all[:3]):
            _assert_bf16_close(got[0].numpy(), np.asarray(want_dx)[:m, :k],
                               dx_abs, n)
            assert abs(float(got[1]) - float(want_dsa)) <= 1e-4 * l1_dsa
            assert abs(float(got[2]) - float(want_dba)) <= 1e-4 * l1_dba
        for want_dw, want_dws in ((j_dw, j_dws), j_all[3:]):
            _assert_bf16_close(got[3].numpy(), np.asarray(want_dw)[:k, :n],
                               dw_abs, m)
            want = np.asarray(want_dws)[:k] if k_side else np.asarray(want_dws)[:, :n]
            assert got[4].shape == want.shape
            assert np.all(np.abs(got[4].numpy() - want) <= 1e-4 * l1_dws)


def test_split_route_equals_combined():
    """scratch_budget=0 forces the split dx / dw kernels; the five
    cotangents are the combined route's, bit for bit."""
    x, w, a_s, a_b, ws, dy = _inputs(37, 130, 90, False, seed=5)
    targs = [torch.from_numpy(v) if isinstance(v, np.ndarray) else torch.tensor(v)
             for v in (dy, x, w, a_s, a_b, ws)]
    assert qmm.bwd_uses_combined(*qmm.padded_dims(37, 130, 90))
    assert not qmm.bwd_uses_combined(*qmm.padded_dims(37, 130, 90),
                                     scratch_budget=0)
    comb = qmm.quant_matmul_bwd(*targs, **QS)
    split = qmm.quant_matmul_bwd(*targs, scratch_budget=0, **QS)
    for a, b in zip(comb, split):
        assert torch.equal(a, b)


QWEN_TOKENS = 8 * 512
ROUTE_SHAPES = [  # (M, K, N): qwen1.5-0.5b's seven linears and its tied head
    (QWEN_TOKENS, 1024, 1024),      # wq / wk / wv (16 heads x 64)
    (QWEN_TOKENS, 1024, 1024),      # wo
    (QWEN_TOKENS, 1024, 2816),      # w_gate / w_in
    (QWEN_TOKENS, 2816, 1024),      # w_out
    (QWEN_TOKENS, 1024, 152064),    # tied lm head (padded vocab)
    (512, 1024, 152064), (512, 1024, 2816), (32, 64, 96), (32, 96, 64),
    (37, 130, 90), (4096, 4096, 14336), (4096, 14336, 4096), (5, 700, 3967),
]


@pytest.mark.parametrize("mkn", ROUTE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_route_matches_reference(mkn):
    """Combined or split: the port decides on the reference's padded shape
    with the reference's tiles and budget, so both take the same route."""
    m, k, n = mkn
    x2 = jax.ShapeDtypeStruct((m, k), jnp.float32)
    bm, bn, bk = jqmm.DEFAULT_TILES
    xp = jax.eval_shape(lambda a: jops._pad2d(a, bm, bk)[0], x2)
    wp = jax.eval_shape(lambda a: jops._pad2d(a, bk, bn)[0],
                        jax.ShapeDtypeStruct((k, n), jnp.float32))
    want = jqmm.bwd_uses_combined(xp.shape[0], xp.shape[1], wp.shape[1])
    assert qmm.bwd_uses_combined(*qmm.padded_dims(m, k, n)) == want
    assert qmm.DEFAULT_TILES == jqmm.DEFAULT_TILES
    assert qmm.BWD_SCRATCH_BUDGET_BYTES == jqmm.BWD_SCRATCH_BUDGET_BYTES
