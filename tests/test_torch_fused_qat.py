"""The port's QAT linear, value and all its gradients (x, w, bias, w_scale,
a_scale, a_offset), on the kernel route (the QAT kernels' plain versions
for CPU tensors, through the autograd Function) against the port's unfused
composition ("off"), and both against the JAX package's fused (interpret
mode) and unfused routes, with the bars of the reference's own fused-vs-
unfused test (tests/test_fused_qat_matmul.py `_grad_parity`): the forward
within 1e-5, dx within 1e-4, every parameter gradient within 1e-4 of
max(max|g|, 1). One allowance: dX and dW are bf16 values rounded from f32
accumulators, which the kernel route, the unfused route and XLA sum in
other orders, so an element may land on the neighbouring bf16 value; such
an element may differ by one bf16 ulp, on at most 1% of the elements.
Across frameworks the bias gradient gets its own bar: XLA sums the bf16
bias cotangent over the batch in bf16 where torch accumulates it in f32
(several bf16 ulps apart, nothing to do with the kernels), so it is held to
the bound of a bf16 sum in any order, L * 2**-8 * sum|terms|."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import EXACT_BF16, bf16_ulp  # noqa: E402
from repro.core.policy import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402

JQ = JQuantConfig(w_bits=4, a_bits=4, mode="mdq")
TQ = QuantConfig(w_bits=4, a_bits=4, mode="mdq")

# name, weight shape, group axes, bias shape, x shape, eq
LINEARS = {
    "ffn": ("w_in", (130, 90), (), None, (2, 37, 130), "bsd,df->bsf"),
    "qkv_bias": ("wq", (40, 6, 24), (1,), (6, 24), (2, 7, 40), "bsd,dhk->bshk"),
    "wo_rows": ("wo", (6, 24, 40), (0,), None, (2, 7, 6, 24), "bshk,hkd->bsd"),
    "no_offset": ("w_out", (96, 40), (), None, (2, 9, 96), "bsf,fd->bsd"),
}
D, V, VP = 40, 90, 96  # head: d_model, vocab, padded vocab


def _params(case):
    key = jax.random.PRNGKey(len(case))
    if case in LINEARS:
        name, shape, ga, bias = LINEARS[case][:4]
        p = JC.linear_init(key, name, JQ, shape, std=0.1, group_axes=ga,
                           bias_shape=bias)
        if bias is not None:
            p["b"] = jax.random.normal(jax.random.PRNGKey(9), bias) * 0.1
        if case == "no_offset":
            del p["a_offset"]
        return {name: p}
    if case == "untied_head":
        return {"lm_head": JC.lm_head_init(key, JQ, D, VP)}
    emb = JC.embed_init(key, JQ, VP, D)
    head = JC.tied_head_act_init(JQ)
    head["a_scale"] = jnp.float32(0.4)
    head["a_offset"] = jnp.float32(-0.3)
    return {"embed": emb, "lm_head": head}


def _x(case):
    shape = LINEARS[case][4] if case in LINEARS else (2, 7, D)
    rng = np.random.default_rng(len(case))
    return np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16)
                      .astype(jnp.float32))


def _apply_jax(case, p, x, qcfg):
    if case in LINEARS:
        name, eq = LINEARS[case][0], LINEARS[case][5]
        return JC.qlinear(p[name], x, name, qcfg, eq)
    return JC.lm_head_apply(p["lm_head"], x, qcfg, V, VP,
                            tied_embed=p.get("embed"))


def _apply_port(case, p, x, qcfg):
    if case in LINEARS:
        name, eq = LINEARS[case][0], LINEARS[case][5]
        return TC.qlinear(p[name], x, name, qcfg, eq)
    return TC.lm_head_apply(p["lm_head"], x, qcfg, V, VP,
                            tied_embed=p.get("embed"))


def _jax_grads(case, p, x, qcfg):
    def loss(p, x):
        y = _apply_jax(case, p, x, qcfg).astype(jnp.float32)
        wgt = jnp.cos(jnp.arange(y.size, dtype=jnp.float32) * 0.1)
        return jnp.sum(y.reshape(-1) * wgt), y
    xb = jnp.asarray(x, jnp.bfloat16)
    # compiled with excess precision off: XLA rounds every bf16 op as written
    f = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    (_, y), (gp, gx) = f.lower(p, xb).compile(EXACT_BF16)(p, xb)
    flat = {f"{a}/{b}": np.asarray(v, np.float32) for a, d in gp.items()
            for b, v in d.items()}
    return np.asarray(y, np.float32), np.asarray(gx, np.float32), flat


def _port_grads(case, p_np, x, qcfg):
    p = {a: {b: torch.tensor(np.asarray(v), requires_grad=True)
             for b, v in d.items()} for a, d in p_np.items()}
    tx = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
    y = _apply_port(case, p, tx, qcfg).to(torch.float32)
    wgt = torch.cos(torch.arange(y.numel(), dtype=torch.float32) * 0.1)
    (y.reshape(-1) * wgt).sum().backward()
    flat = {f"{a}/{b}": v.grad.numpy() for a, d in p.items() for b, v in d.items()}
    return y.detach().numpy(), tx.grad.to(torch.float32).numpy(), flat


def _grad_close(a, b, tol, what):
    d = np.abs(a.astype(np.float64) - b)
    beyond = d > tol
    ulp = bf16_ulp(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(~beyond | (d <= ulp)), (what, d.max())
    assert beyond.mean() <= 0.01, (what, beyond.mean())


def _bias_bar(y):
    """Per bias element, the bound on two bf16 sums (any order) of the L
    bf16 cotangents reduced into it: L * 2**-8 * sum|terms|."""
    wgt = np.cos(np.arange(y.size, dtype=np.float32) * 0.1).reshape(y.shape)
    ct = np.abs(np.asarray(jnp.asarray(wgt, jnp.bfloat16).astype(jnp.float32)))
    n = y.shape[0] * y.shape[1]
    return n * 2.0 ** -8 * ct.sum(axis=(0, 1))


def _close(a, b, tol=1e-4, frameworks_differ=False):
    y_a, gx_a, g_a = a
    y_b, gx_b, g_b = b
    np.testing.assert_allclose(y_a, y_b, rtol=0, atol=1e-5 * max(np.abs(y_b).max(), 1))
    _grad_close(gx_a, gx_b, tol, "x")
    assert set(g_a) == set(g_b)
    for k in g_b:
        if frameworks_differ and k.endswith("/b"):
            assert np.all(np.abs(g_a[k] - g_b[k]) <= _bias_bar(y_b)), k
            continue
        scale = max(float(np.abs(g_b[k]).max()), 1.0)
        _grad_close(g_a[k], g_b[k], tol * scale, k)


CASES = list(LINEARS) + ["untied_head", "tied_head"]


@pytest.mark.parametrize("case", CASES)
def test_qat_linear_kernel_route_matches_unfused_and_jax(case):
    jp = _params(case)
    p_np = jax.tree.map(np.asarray, jp)
    x = _x(case)
    ops.reset_launch_counts()
    t_on = _port_grads(case, p_np, x, TQ)
    counts = ops.launch_counts()
    assert counts["quant_matmul"] == 0, "a CPU tensor must launch nothing"
    t_off = _port_grads(case, p_np, x, TQ.replace(fused_matmul="off"))
    j_on = _jax_grads(case, jp, x, JQ.replace(fused_matmul="on"))
    j_off = _jax_grads(case, jp, x, JQ.replace(fused_matmul="off"))
    _close(t_on, t_off)
    _close(t_on, j_on, frameworks_differ=True)
    _close(t_off, j_off, frameworks_differ=True)


def test_fused_on_refuses_cpu_tensors():
    jp = _params("ffn")
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp["w_in"].items()}
    x = torch.zeros((1, 2, 130))
    with pytest.raises(ValueError, match="needs CUDA"):
        TC.qlinear(p, x, "w_in", TQ.replace(fused_matmul="on"), "bsd,df->bsf")
