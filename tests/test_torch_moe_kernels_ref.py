"""The plain versions of the batched (MoE expert) QAT kernels against the JAX
package's Pallas kernels `quant_matmul_batched` / `quant_matmul_bwd_batched`
in interpret mode, on the same numpy inputs: E = 3 experts at the ragged
per-expert shapes of tests/test_fused_qat_matmul.py's MoE case (the JAX side
padded to its tiles as its `ops` does; the port masks), 2-, 3- and 4-bit
quantizers, both cotangent roundings; the combined-vs-split route rule on the
per-expert shape, and the split fallback (expert by expert through the 2D
dx / dw kernels) against the combined kernel.

Bars, as for the 2D kernels (tests/test_torch_qat_kernels_ref.py): the
forward within 1e-5 * max|y| (only the f32 summation order differs); dX and
dW are rounded through bf16 from f32 sums taken in other orders, so each
element within one bf16 ulp plus the order-independent bound on two f32 sums
of the same L products (2 * L * 2**-24 * sum|products|), at most 1% of the
elements differing at all; the per-expert scale sums dsa, dba and dws within
1e-4 of their sum of |summands|.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import bf16_ulp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def _qs(w_bits: int, a_bits: int) -> dict:
    """Signed weight codes, unsigned (LSQ+) activation codes."""
    return dict(q_n_a=0, q_p_a=2 ** a_bits - 1, q_n_w=2 ** (w_bits - 1),
                q_p_w=2 ** (w_bits - 1) - 1)


def _inputs(e, m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((e, m, k)) * 2).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32)
    a_s = (rng.random((e, 1)) * 0.3 + 0.2).astype(np.float32)
    a_b = (rng.standard_normal((e, 1)) * 0.1).astype(np.float32)
    ws = (rng.random((e, n)) * 0.1 + 0.05).astype(np.float32)
    ws[0, 0] = 0.0  # exercises the max(scale, 1e-9) floor
    dy = rng.standard_normal((e, m, n)).astype(np.float32)
    return x, w, a_s, a_b, ws, dy


def _jax_kernel(fn, dy, x, w, a_s, a_b, ws, **kw):
    """A batched Pallas kernel on operands padded as the JAX package's
    `_qmm3d_forward` / `_fused_qmm3d_bwd` pad them."""
    bm, bn, bk = jqmm.DEFAULT_TILES
    xp = jops._pad3d(jnp.asarray(x), bm, bk)
    wp = jops._pad3d(jnp.asarray(w), bk, bn)
    wsp = jnp.pad(jnp.asarray(ws), ((0, 0), (0, wp.shape[-1] - ws.shape[1])),
                  constant_values=1.0)
    args = (xp, wp, jnp.asarray(a_s), jnp.asarray(a_b), wsp)
    if dy is not None:
        args = (jops._pad3d(jnp.asarray(dy), bm, bn),) + args
    return fn(*args, interpret=True, **kw)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_bf16_close(t, j, abs_products, length):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    tol = bf16_ulp(np.maximum(np.abs(t), np.abs(j))) + 2 * length * 2.0 ** -24 * abs_products
    assert np.all(np.abs(t - j) <= tol), np.max(np.abs(t - j) - tol)
    assert np.mean(t != j) <= 0.01, np.mean(t != j)


# (E, M, K, N) of the MoE expert einsums at tests/test_fused_qat_matmul.py:
# 120-121: x (2, 3, 6, K) -> 12 rows an expert
SHAPES = [(3, 12, 32, 40), (3, 12, 40, 32)]
BITS = [(2, 2), (3, 3), (4, 4)]


@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", BITS, ids=["w2a2", "w3a3", "w4a4"])
@pytest.mark.parametrize("emkn", SHAPES, ids=["in", "out"])
def test_batched_forward_plain_matches_pallas(emkn, bits, xdtype):
    qs = _qs(*bits)
    x, w, a_s, a_b, ws, _ = _inputs(*emkn, seed=sum(emkn) + bits[0])
    xj = jnp.asarray(x, dtype=xdtype)
    e, m, _, n = emkn
    y_j = np.asarray(_jax_kernel(jqmm.quant_matmul_batched, None, xj, w, a_s,
                                 a_b, ws, **qs))[:, :m, :n]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if xdtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    y_t = qmm.quant_matmul_batched(xt, *_t(w, a_s, a_b, ws), **qs).numpy()
    assert y_t.shape == (e, m, n) and y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


def _check_bwd(t_out, j_out, x, w, a_s, a_b, ws, dy, qs, round_cot):
    """All five per-expert cotangents against the reference's at the bars
    of the module docstring."""
    e, m, k = x.shape
    n = w.shape[2]
    tx, tw, tas, tab, tws, tdy = _t(x, w, a_s, a_b, ws, dy)
    s_a, b_a, s_w = ref._expert_scales(tas, tab, tws)
    u, q, xd = ref._act_codes(tx, s_a, b_a, qs["q_n_a"], qs["q_p_a"])
    uw, qw, wd = ref._weight_codes(tw, s_w, qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(tdy, round_cot)
    j_dx, j_dsa, j_dba, j_dw, j_dws = (np.asarray(v) for v in j_out)
    t_dx, t_dsa, t_dba, t_dw, t_dws = (v.numpy() for v in t_out)
    assert t_dx.shape == (e, m, k) and t_dw.shape == (e, k, n)
    assert t_dsa.shape == (e, 1) and t_dba.shape == (e, 1) and t_dws.shape == (e, n)
    _assert_bf16_close(t_dx, j_dx[:, :m, :k],
                       (cot.abs() @ wd.abs().transpose(1, 2)).numpy(), n)
    _assert_bf16_close(t_dw, j_dw[:, :k, :n],
                       (xd.abs().transpose(1, 2) @ cot.abs()).numpy(), m)
    dxd = ref._bf16(cot @ wd.transpose(1, 2))
    mf = ref._in_range(u, qs["q_n_a"], qs["q_p_a"])
    l1a = torch.sum((dxd * (q - mf * u)).abs(), dim=(1, 2)).numpy()[:, None]
    l1b = torch.sum((dxd * (1 - mf)).abs(), dim=(1, 2)).numpy()[:, None]
    assert np.all(np.abs(t_dsa - j_dsa) <= 1e-4 * l1a + 1e-30)
    assert np.all(np.abs(t_dba - j_dba) <= 1e-4 * l1b + 1e-30)
    dwd = ref._bf16(xd.transpose(1, 2) @ cot)
    mfw = ref._in_range(uw, qs["q_n_w"], qs["q_p_w"])
    l1w = torch.sum((dwd * (qw - mfw * uw)).abs(), dim=1).numpy()
    assert np.all(np.abs(t_dws - j_dws[:, :n]) <= 1e-4 * l1w + 1e-30)


@pytest.mark.parametrize("round_cot", [True, False], ids=["bf16cot", "f32cot"])
@pytest.mark.parametrize("bits", BITS, ids=["w2a2", "w3a3", "w4a4"])
@pytest.mark.parametrize("emkn", SHAPES, ids=["in", "out"])
def test_batched_backward_plain_matches_pallas(emkn, bits, round_cot):
    qs = _qs(*bits)
    x, w, a_s, a_b, ws, dy = _inputs(*emkn, seed=sum(emkn) + 7 * bits[0])
    kw = dict(round_cot=round_cot, **qs)
    j_out = _jax_kernel(jqmm.quant_matmul_bwd_batched, dy, x, w, a_s, a_b, ws,
                        **kw)
    t_out = qmm.quant_matmul_bwd_batched(*_t(dy, x, w, a_s, a_b, ws), **kw)
    _check_bwd(t_out, j_out, x, w, a_s, a_b, ws, dy, qs, round_cot)


def test_batched_route_rule_on_the_expert_shape():
    """The combined-vs-split decision is the reference's, taken on the
    padded per-expert shape: granite-moe's expert linears at batch 8 x 512
    (capacity 1280 rows) stay combined; a wide N or a zero budget splits."""
    for m, k, n in ((1280, 1024, 512), (1280, 512, 1024), (12, 32, 40)):
        padded = qmm.padded_dims(m, k, n)
        assert qmm.bwd_uses_combined(*padded) == jqmm.bwd_uses_combined(*padded)
        assert qmm.bwd_uses_combined(*padded)
    assert qmm.bwd_scratch_bytes(1280, 1024, 512) == 4 * (128 * 512 + 512 * 512 + 512)
    assert not qmm.bwd_uses_combined(*qmm.padded_dims(1280, 512, 8192))
    assert not qmm.bwd_uses_combined(1280, 1024, 512, scratch_budget=0)


@pytest.mark.parametrize("round_cot", [True, False], ids=["bf16cot", "f32cot"])
def test_batched_split_fallback_matches_combined(round_cot):
    """Mirror of tests/test_fused_qat_matmul.py::
    test_bwd_batched_split_fallback_matches_combined: scratch_budget=0 sends
    every expert through the split dx / dw kernels (no batched launch), and
    all five cotangents equal the combined route's; the split route also
    meets the Pallas combined kernel at the bars above."""
    e, m, k, n = 3, 128, 512, 128
    qs = _qs(4, 4)
    x, w, a_s, a_b, ws, dy = _inputs(e, m, k, n, seed=11)
    kw = dict(round_cot=round_cot, **qs)
    args = _t(dy, x, w, a_s, a_b, ws)
    tops.reset_launch_counts()
    combined = qmm.quant_matmul_bwd_batched(*args, **kw)
    split = qmm.quant_matmul_bwd_batched(*args, scratch_budget=0, **kw)
    assert tops.launch_counts()["quant_matmul_bwd_batched"] == 0  # CPU: plain
    for a, b in zip(combined, split):
        assert a.shape == b.shape
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1e-30)
    j_out = _jax_kernel(jqmm.quant_matmul_bwd_batched, dy, x, w, a_s, a_b, ws,
                        **kw)
    _check_bwd(split, j_out, x, w, a_s, a_b, ws, dy, qs, round_cot)
