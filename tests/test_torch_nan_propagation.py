"""NaN and ±Inf through the quantizer kernels: the plain versions
(`repro_torch.kernels.ref`, which the wrappers take for CPU tensors and which
`chip_smoke.py` holds the CUDA kernels to) against the JAX package's Pallas
kernels in interpret mode, with NaN / ±Inf in x, w and the scales.

In the reference a NaN passes through every quantizer: the code is
`jnp.clip(jnp.round(u), ...)` and the scale floor `jnp.maximum(s, 1e-9)`,
both of which keep NaN, while ±Inf clips to the range's end. The inputs lie
on power-of-two grids (x on 2^-3, w on 2^-6, dY on 2^-3, scales 2^-2 and
2^-5), so every product and every partial sum is exact in f32: each finite
output element is then independent of the summation order, and the bar is
bit-equality of every element that is not NaN, with NaN at the same
positions, but for the sign of a zero: the port masks by multiplying with
the 0/1 Eq. 6 mask, as the reference's kernels are written, and XLA turns
that product into a select, so a masked negative cotangent is -0 in the
port and +0 in the reference (the CUDA kernels multiply as the port's plain
versions do, so `chip_smoke.py` holds them bit for bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.quantizer import QuantSpec as JSpec  # noqa: E402
from repro.core.quantizer import pack_int4 as j_pack_int4  # noqa: E402
from repro.kernels import bin_stats as jbs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro_torch.core.quantizer import QuantSpec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

QS = dict(q_n_a=0, q_p_a=15, q_n_w=8, q_p_w=7)  # 4-bit LSQ+ acts, 4-bit weights
A_S, A_B, W_S = 0.25, -0.5, 2.0 ** -5


def _same(got, want, what=""):
    """NaN where want is NaN, every other element bit-equal (a zero of
    either sign equal to a zero)."""
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    gn, wn = np.isnan(g), np.isnan(w)
    assert np.array_equal(gn, wn), (what, int(gn.sum()), int(wn.sum()))
    diff = np.flatnonzero((g.view(np.uint32) != w.view(np.uint32)) & ~wn
                          & ~((g == 0) & (w == 0)))
    assert diff.size == 0, (what, diff.size, g.reshape(-1)[diff[:4]],
                            w.reshape(-1)[diff[:4]])


def _inputs(m, k, n, case, seed=0, k_side=False):
    """Grid inputs (module docstring) with the case's non-finite values."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-16, 17, (m, k)) * 2.0 ** -3).astype(np.float32)
    w = (rng.integers(-20, 21, (k, n)) * 2.0 ** -6).astype(np.float32)
    ws = np.full((k, 1) if k_side else (1, n), W_S, np.float32)
    dy = (rng.integers(-8, 9, (m, n)) * 2.0 ** -3).astype(np.float32)
    a_s = np.float32(A_S)
    if case in ("x", "all"):
        x[1, 2] = x[5, k - 1] = x[m - 1, 0] = np.nan
        x[2, 3], x[3, 4] = np.inf, -np.inf
    if case in ("w", "all"):
        w[0, 1] = w[7, n - 2] = w[k - 1, 5] = np.nan
    if case == "w":
        w[4, 4], w[6, 2] = np.inf, -np.inf
    if case in ("w_scale", "all"):
        ws.flat[3] = np.nan
    if case == "a_scale":
        a_s = np.float32(np.nan)
    if case == "dy":
        dy[2, 5] = np.nan
        dy[4, 1] = np.inf
    return x, w, a_s, np.float32(A_B), ws, dy


def _pallas(fn, dy, x, w, a_s, a_b, ws, k_side, **kw):
    """A 2D Pallas kernel on operands padded as the JAX package's ops pads
    them (the pads are zeros and unit scales: nothing non-finite)."""
    m, k = x.shape
    n = w.shape[1]
    bm, bn, bk = jqmm.DEFAULT_TILES
    xp, _, _ = jops._pad2d(jnp.asarray(x), bm, bk)
    wp, _, _ = jops._pad2d(jnp.asarray(w), bk, bn)
    wsp = jops._pad_w_scale(jnp.asarray(ws).reshape(-1), k_side, k, n,
                            wp.shape[0], wp.shape[1])
    args = (xp, wp, a_s, a_b, wsp)
    if dy is not None:
        args = (jops._pad2d(jnp.asarray(dy), bm, bn)[0],) + args
    return fn(*args, interpret=True, **kw)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray)
            else torch.tensor(a) for a in arrays]


CASES = ["x", "w", "w_scale", "a_scale", "all"]
MKN = (40, 96, 72)


@pytest.mark.parametrize("case", CASES)
def test_forward_nan_matches_pallas(case):
    m, k, n = MKN
    x, w, a_s, a_b, ws, _ = _inputs(m, k, n, case)
    want = np.asarray(_pallas(jqmm.quant_matmul, None, x, w, a_s, a_b, ws,
                              False, **QS))[:m, :n]
    got = ref.quant_matmul(*_t(x, w, a_s, a_b, ws), **QS).numpy()
    assert np.isnan(want).any() or case == "none"
    _same(got, want, "y")


@pytest.mark.parametrize("round_cot", [True, False], ids=["bf16cot", "f32cot"])
@pytest.mark.parametrize("k_side", [False, True], ids=["cols", "rows"])
@pytest.mark.parametrize("case", CASES + ["dy"])
def test_backward_nan_matches_pallas(case, k_side, round_cot):
    """The combined backward's five outputs; the split kernels' (dx, dw) in
    the reference compute the same values (tests/test_torch_qat_kernels_ref.py)."""
    m, k, n = MKN
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, case, seed=1, k_side=k_side)
    kw = dict(round_cot=round_cot, **QS)
    j = _pallas(jqmm.quant_matmul_bwd, dy, x, w, a_s, a_b, ws, k_side, **kw)
    t = ref.quant_matmul_bwd(*_t(dy, x, w, a_s, a_b, ws), **kw)
    j_dx, j_dsa, j_dba, j_dw, j_dws = (np.asarray(v) for v in j)
    _same(t[0].numpy(), j_dx[:m, :k], "dx")
    _same(t[1].numpy().reshape(()), j_dsa.reshape(()), "dsa")
    _same(t[2].numpy().reshape(()), j_dba.reshape(()), "dba")
    _same(t[3].numpy(), j_dw[:k, :n], "dw")
    dws = j_dws.reshape(-1)[:k] if k_side else j_dws.reshape(-1)[:n]
    _same(t[4].numpy().reshape(-1), dws, "dws")


@pytest.mark.parametrize("case", ["all", "w_scale"])
def test_batched_nan_matches_pallas(case):
    """Per expert: expert 1 carries the case's non-finite values, experts 0
    and 2 none, so their outputs stay finite in both packages."""
    e, (m, k, n) = 3, MKN
    xs, ws_, dys, wsc = [], [], [], []
    for i in range(e):
        x, w, _, _, sc, dy = _inputs(m, k, n, case if i == 1 else "none", seed=i)
        xs.append(x), ws_.append(w), dys.append(dy), wsc.append(sc.reshape(-1))
    x, w, dy, ws = (np.stack(v) for v in (xs, ws_, dys, wsc))
    a_s = np.full((e, 1), A_S, np.float32)
    a_b = np.full((e, 1), A_B, np.float32)
    bm, bn, bk = jqmm.DEFAULT_TILES
    xp = jops._pad3d(jnp.asarray(x), bm, bk)
    wp = jops._pad3d(jnp.asarray(w), bk, bn)
    wsp = jnp.pad(jnp.asarray(ws), ((0, 0), (0, wp.shape[-1] - n)),
                  constant_values=1.0)
    dyp = jops._pad3d(jnp.asarray(dy), bm, bn)
    y_j = np.asarray(jqmm.quant_matmul_batched(
        xp, wp, jnp.asarray(a_s), jnp.asarray(a_b), wsp, interpret=True,
        **QS))[:, :m, :n]
    y_t = ref.quant_matmul_batched(*_t(x, w, a_s, a_b, ws), **QS).numpy()
    _same(y_t, y_j, "y")
    assert np.isnan(y_t[1]).any() and np.isfinite(y_t[[0, 2]]).all()
    j = jqmm.quant_matmul_bwd_batched(dyp, xp, wp, jnp.asarray(a_s),
                                      jnp.asarray(a_b), wsp, interpret=True,
                                      round_cot=True, **QS)
    t = ref.quant_matmul_bwd_batched(*_t(dy, x, w, a_s, a_b, ws),
                                     round_cot=True, **QS)
    j = [np.asarray(v) for v in j]
    _same(t[0].numpy(), j[0][:, :m, :k], "dx")
    _same(t[1].numpy(), j[1], "dsa")
    _same(t[2].numpy(), j[2], "dba")
    _same(t[3].numpy(), j[3][:, :k, :n], "dw")
    _same(t[4].numpy(), j[4][:, :n], "dws")


def _fq_input(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x[0, 3] = x[5, 0] = np.nan
    x[1, 1], x[2, 7] = np.inf, -np.inf
    return x


@pytest.mark.parametrize("scale", [0.07, float("nan")], ids=["finite", "nan"])
@pytest.mark.parametrize("offset", [None, 0.05], ids=["none", "offset"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_fake_quant_2d_nan_matches_pallas(scale, offset, dt):
    x = _fq_input((37, 200))
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16,
                                                                  torch.bfloat16)
    want = jops.fake_quant(jnp.asarray(x, jdt), scale, JSpec(bits=4), offset,
                           interpret=True)
    got = ops.fake_quant(torch.from_numpy(x).to(tdt), scale, QuantSpec(bits=4),
                         offset)
    _same(got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32)),
          "fake_quant")


def test_fake_quant_rows_nan_matches_pallas():
    x = _fq_input((6, 300))
    sc = np.asarray([0.05, np.nan, 0.1, 0.02, 0.0, np.inf], np.float32)
    want = jops.fake_quant_grouped(jnp.asarray(x), jnp.asarray(sc),
                                   JSpec(bits=3), interpret=True)
    got = ops.fake_quant_grouped(torch.from_numpy(x), torch.from_numpy(sc),
                                 QuantSpec(bits=3))
    _same(got.numpy(), np.asarray(want), "fake_quant_rows")
    assert np.isnan(got.numpy()[1]).all()


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("case", ["scale", "x"])
def test_int_matmul_nan_matches_pallas(case, packed):
    """A NaN column scale makes its column NaN; NaN in x its row; ±Inf in x
    gives ±Inf, or NaN where a code is 0 or signs meet."""
    m, k, n = 9, 130, 70
    rng = np.random.default_rng(3)
    bits = 4 if packed else 8
    x = (rng.integers(-4, 5, (m, k)) * 2.0 ** -3).astype(np.float32)
    codes = rng.integers(-2 ** (bits - 1), 2 ** (bits - 1), (k, n)).astype(np.int8)
    scale = np.full(n, 2.0 ** -6, np.float32)
    if case == "scale":
        scale[5] = np.nan
        scale[6] = 0.0
    else:
        x[1, 2] = np.nan
        x[3, 4], x[4, 0] = np.inf, -np.inf
        codes[0, :] = np.where(codes[0, :] == 0, 1, codes[0, :])  # row 4: ±Inf
    w_np = np.array(j_pack_int4(jnp.asarray(codes), 0)) if packed else codes
    want = np.asarray(jops.int_matmul(jnp.asarray(x), jnp.asarray(w_np),
                                      jnp.asarray(scale), JSpec(bits=bits),
                                      packed=packed, interpret=True))
    got = ops.int_matmul(torch.from_numpy(x), torch.from_numpy(w_np),
                         torch.from_numpy(scale), QuantSpec(bits=bits),
                         packed=packed).numpy()
    assert np.isnan(want).any()
    _same(got, want, "int_matmul")


@pytest.mark.parametrize("scale", [0.05, float("nan"), float("inf")],
                         ids=["finite", "nan", "inf"])
@pytest.mark.parametrize("case", ["nan", "inf", "nan_inf", "square_overflow"])
def test_bin_stats_nonfinite_matches_pallas(case, scale):
    """The reference's one-hot contraction: a NaN code counts nowhere, and a
    bin's sum (sum of squares) is NaN when an element outside it holds a
    non-finite w (w * w); ±Inf lands in an edge bin. Counts equal; sums
    equal in their NaN and ±Inf positions and within 1e-6 elsewhere (the
    reference sums in f32, the port in f64 rounded once)."""
    w = (np.random.default_rng(4).standard_normal((300, 24)) * 0.1).astype(np.float32)
    if case in ("nan", "nan_inf"):
        w[1, 2] = np.nan
    if case in ("inf", "nan_inf"):
        w[3, 4], w[7, 7] = np.inf, -np.inf
    if case == "square_overflow":
        w[0, 0] = 3e19
    want = np.asarray(jbs.bin_stats_2d(jnp.asarray(w), scale, q_n=4, q_p=3,
                                       interpret=True))
    got = ref.bin_stats_2d(torch.from_numpy(w), scale, q_n=4, q_p=3).numpy()
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)
