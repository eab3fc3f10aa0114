"""The QAT forward on the tensor cores, 2D (`quant_matmul`) and per expert
(`quant_matmul_batched`): a prologue that writes xd and wd to zero-padded
bf16 scratch, then an mma.sync tile (the expert on blockIdx.z).

On the CPU no kernel runs, so this pins what surrounds them: the scratch
shapes, the entry each wrapper launches and the order of its arguments
(through a fake library on meta tensors), that a failed launch raises, the
plain forward prologue against the quantizers, the scratch bytes the kernel
bench reports, and the CPU route of both wrappers against the JAX package's
Pallas kernels in interpret mode, with the bars of
tests/test_torch_qat_kernels_ref.py and tests/test_torch_moe_kernels_ref.py
(within 1e-5 * max|y|: only the f32 summation order differs). The kernels
themselves are held against the plain versions on the card by
chip_smoke.py (phases 5 and 5b).
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.launch import kernel_bench as kb  # noqa: E402
from test_torch_moe_kernels_ref import _inputs as _moe_inputs  # noqa: E402
from test_torch_moe_kernels_ref import _jax_kernel as _jax_batched  # noqa: E402
from test_torch_moe_kernels_ref import _qs  # noqa: E402
from test_torch_qat_bwd_tc import _c_param_count  # noqa: E402
from test_torch_qat_kernels_ref import QS, _inputs, _jax_kernel  # noqa: E402

SCRATCH_SHAPES = [(1, 4096, 1024, 2816), (1, 4096, 2816, 1024),
                  (1, 4096, 1024, 152064), (1, 4096, 1024, 49408),
                  (1, 1, 1, 1), (1, 257, 129, 65), (1, 4096, 1000, 2817),
                  (32, 1280, 1024, 512), (32, 1280, 512, 1024), (3, 257, 129, 65)]


@pytest.mark.parametrize("emkn", SCRATCH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scratch_leading_dims_and_bytes(emkn):
    e, m, k, n = emkn
    lds, nbytes = qmm._fwd_tc_scratch(m, k, n, e)
    for ld, true in zip(lds, (k, n)):
        assert ld % 8 == 0 and true <= ld < true + 8
    assert nbytes == (2 * e * m * lds[0], 2 * e * k * lds[1])
    assert qmm._fwd_tc_scratch(m, k, n)[0] == lds  # per expert as in 2D
    if emkn == (1, 4096, 1024, 152064):  # the qwen head: 8 MB of xd, 311 MB of wd
        assert nbytes == (8_388_608, 311_427_072)
    if emkn == (32, 1280, 1024, 512):    # granite-moe's experts: 117 MB
        assert sum(nbytes) == 117_440_512


@pytest.fixture
def fake_fwd_lib(monkeypatch):
    """A fake kernel library that records each launch, operand checks that
    let meta tensors through, and scratch whose data pointers are tagged
    (meta tensors have none), so the launch's argument order shows."""
    calls, scratch = [], []
    status = {"rc": 0}

    def entry(name):
        def launch(*args):
            calls.append((name, args))
            return status["rc"]
        return launch

    lib = types.SimpleNamespace(**{n: entry(n) for n in (
        "qat_fwd_tc_launch", "qat_fwd_prologue_launch")})

    def operands(x, w, a_scale, a_offset, w_scale, dy=None):
        k_side = tuple(w_scale.shape) != (1, w.shape[1])
        return (x, w, a_scale, a_offset, w_scale.reshape(-1), k_side, dy)

    def batched(x, w, a_scale, a_offset, w_scale, dy=None):
        return (x, w, a_scale, a_offset, w_scale, dy)

    def tensors(lead, m, k, n, device):
        lds, _ = qmm._fwd_tc_scratch(m, k, n)
        out = []
        for i, (rows, ld) in enumerate(zip((m, k), lds)):
            t = torch.empty((*lead, rows, ld), dtype=torch.bfloat16, device=device)
            out.append(types.SimpleNamespace(shape=t.shape, dtype=t.dtype,
                                             data_ptr=lambda i=i: 0x1000 * (i + 1)))
        scratch.append(out)
        return tuple(out)

    monkeypatch.setattr(qmm, "_qat_lib", lambda: lib)
    # meta tensors take the plain versions now (the dry run's route): send
    # them down the launch path, as CUDA tensors go, to reach the fake library
    monkeypatch.setattr(ref, "takes_plain", lambda t: t.device.type == "cpu")
    monkeypatch.setattr(qmm, "_qat_operands", operands)
    monkeypatch.setattr(qmm, "_batched_operands", batched)
    monkeypatch.setattr(qmm, "_fwd_tc_scratch_tensors", tensors)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls, status


def _meta_operands(m, k, n, k_side=False, e=None):
    meta = dict(device="meta")
    if e is None:
        lead, a_shape, w_shape = (), (), (k, 1) if k_side else (1, n)
    else:
        lead, a_shape, w_shape = (e,), (e, 1), (e, n)
    return (torch.empty((*lead, m, k), dtype=torch.bfloat16, **meta),
            torch.empty((*lead, k, n), **meta), torch.empty(a_shape, **meta),
            torch.empty(a_shape, **meta), torch.empty(w_shape, **meta))


LAUNCH_CASES = [((None, 4096, 1024, 2816), False), ((None, 257, 129, 65), True),
                ((None, 4096, 1000, 2817), False), ((32, 1280, 1024, 512), False),
                ((3, 257, 129, 65), False)]


@pytest.mark.parametrize("emkn,k_side", LAUNCH_CASES,
                         ids=["ffn", "rows-odd", "misaligned", "experts", "experts-odd"])
def test_wrappers_launch_the_tensor_core_entry(fake_fwd_lib, emkn, k_side):
    """quant_matmul / quant_matmul_batched launch qat_fwd_tc_launch once, in
    the declared order: x, x_bf16, w, a_s, a_b, ws, k_side, out, xd, ld_x,
    wd, ld_w, E, M, K, N, the four code bounds, the stream."""
    calls, _ = fake_fwd_lib
    e, m, k, n = emkn
    fn = qmm.quant_matmul if e is None else qmm.quant_matmul_batched
    before = fn.launches
    out = fn(*_meta_operands(m, k, n, k_side, e), **QS)
    assert tuple(out.shape) == ((m, n) if e is None else (e, m, n))
    assert out.dtype == torch.float32
    assert [name for name, _ in calls] == ["qat_fwd_tc_launch"]
    args = calls[0][1]
    assert len(args) == _c_param_count("qat_fwd_tc_launch")
    lds, _ = qmm._fwd_tc_scratch(m, k, n)
    assert args[1] == 1 and args[6] == int(k_side)
    assert args[8:12] == (0x1000, lds[0], 0x2000, lds[1])
    assert args[12:16] == (e or 1, m, k, n)
    assert args[16:20] == (QS["q_n_a"], QS["q_p_a"], QS["q_n_w"], QS["q_p_w"])
    assert fn.launches == before + 1


@pytest.mark.parametrize("e", [None, 3], ids=["2d", "experts"])
def test_prologue_wrapper_passes_the_scratch(fake_fwd_lib, e):
    calls, _ = fake_fwd_lib
    m, k, n = 257, 129, 65
    xd, wd = qmm.fwd_prologue(*_meta_operands(m, k, n, e is None, e), **QS)
    lds, _ = qmm._fwd_tc_scratch(m, k, n)
    lead = () if e is None else (e,)
    assert [tuple(t.shape) for t in (xd, wd)] == [(*lead, m, lds[0]), (*lead, k, lds[1])]
    name, args = calls[0]
    assert name == "qat_fwd_prologue_launch" and len(args) == _c_param_count(name)
    assert args[6] == int(e is None)
    assert args[7:11] == (0x1000, lds[0], 0x2000, lds[1])
    assert args[11:15] == (e or 1, m, k, n)


@pytest.mark.parametrize("batched", [False, True], ids=["2d", "experts"])
def test_failed_launch_raises_without_fallback(fake_fwd_lib, batched):
    calls, status = fake_fwd_lib
    status["rc"] = 2  # cudaErrorMemoryAllocation
    fn = qmm.quant_matmul_batched if batched else qmm.quant_matmul
    before = fn.launches
    with pytest.raises(RuntimeError, match="qat_fwd_tc_launch failed: cudaError 2"):
        fn(*_meta_operands(4096, 1024, 512, e=32 if batched else None), **QS)
    assert [name for name, _ in calls] == ["qat_fwd_tc_launch"]
    assert fn.launches == before


def test_old_simt_forward_entries_are_gone():
    src = build.SOURCES["qat_matmul"].read_text()
    for gone in ("qat_fwd_launch(", "qat_fwd_batched_launch(", "qat_fwd_kernel",
                 "qat_fwd_batched_kernel", "fwd_tile("):
        assert gone not in src, gone
    for entry in ("qat_fwd_tc_launch", "qat_fwd_prologue_launch"):
        assert _c_param_count(entry) > 0


def _torch_args(*vals):
    return [torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray)
            else torch.tensor(v) for v in vals]


@pytest.mark.parametrize("mkn", [(37, 130, 90), (20, 129, 65), (16, 64, 128), (1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k_side", [False, True], ids=["cols", "rows"])
def test_cpu_prologue_is_the_plain_dequantization(mkn, xdtype, k_side):
    """On a CPU tensor fwd_prologue is the plain version: the quantizers'
    bf16 values and zeros in the pad."""
    m, k, n = mkn
    x, w, a_s, a_b, ws, _ = _inputs(m, k, n, k_side, seed=m * k + n + 3)
    tx, tw, ts, tb, tws = _torch_args(x, w, a_s, a_b, ws)
    tx = tx.to(xdtype)
    xd, wd = qmm.fwd_prologue(tx, tw, ts, tb, tws, **QS)
    lds, _ = qmm._fwd_tc_scratch(m, k, n)
    assert [tuple(t.shape) for t in (xd, wd)] == [(m, lds[0]), (k, lds[1])]
    want = (ref._act_codes(tx, ts, tb, QS["q_n_a"], QS["q_p_a"])[2],
            ref._weight_codes(tw, tws, QS["q_n_w"], QS["q_p_w"])[2])
    for got, w_ in zip((xd, wd), want):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got[:, :w_.shape[1]].float(), w_)
        assert not got[:, w_.shape[1]:].any()


@pytest.mark.parametrize("emkn", [(3, 12, 32, 40), (3, 12, 41, 33), (2, 5, 9, 7)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_prologue_per_expert_is_the_plain_dequantization(emkn, xdtype):
    """Per expert, each slice of the plain batched prologue is the 2D one
    under that expert's own scales (the kernel's contract for blockIdx.y)."""
    e, m, k, n = emkn
    qs = _qs(3, 3)
    x, w, a_s, a_b, ws, _ = _moe_inputs(e, m, k, n, seed=sum(emkn))
    tx, tw, ts, tb, tws = _torch_args(x, w, a_s, a_b, ws)
    tx = tx.to(xdtype)
    xd, wd = qmm.fwd_prologue(tx, tw, ts, tb, tws, **qs)
    lds, _ = qmm._fwd_tc_scratch(m, k, n)
    assert [tuple(t.shape) for t in (xd, wd)] == [(e, m, lds[0]), (e, k, lds[1])]
    for i in range(e):
        xi = ref._act_codes(tx[i], ts[i, 0], tb[i, 0], qs["q_n_a"], qs["q_p_a"])[2]
        wi = ref._weight_codes(tw[i], tws[i:i + 1], qs["q_n_w"], qs["q_p_w"])[2]
        assert torch.equal(xd[i, :, :k].float(), xi) and not xd[i, :, k:].any()
        assert torch.equal(wd[i, :, :n].float(), wi) and not wd[i, :, n:].any()
        two_d = qmm.fwd_prologue(tx[i], tw[i], ts[i, 0], tb[i, 0], tws[i:i + 1], **qs)
        assert torch.equal(xd[i], two_d[0]) and torch.equal(wd[i], two_d[1])


def test_kernel_bench_counts_the_scratch_bytes():
    """The bench's scratch_bytes: the prologue's bf16 arrays written once
    and read once, at its (M, K, N) = (256, 1024, 512); the boundary bytes
    leave them out."""
    assert (kb.M, kb.K, kb.N) == (256, 1024, 512)
    fwd = 2 * (2 * 256 * 1024 + 2 * 1024 * 512)
    assert kb.tc_scratch_bytes(kb.M, kb.K, kb.N, backward=False) == fwd == 3_145_728
    bwd = fwd + 2 * 2 * 256 * 512
    assert kb.tc_scratch_bytes(kb.M, kb.K, kb.N, backward=True) == bwd
    # past the reference's scratch budget the backward takes the split grids
    assert kb.tc_scratch_bytes(64, 1024, 152064, backward=True) == 0
    assert kb.tc_scratch_bytes(257, 129, 65, backward=False) == 2 * (
        2 * 257 * 136 + 2 * 129 * 72)


FWD_SHAPES = [(37, 130, 90), (257, 129, 65), (5, 700, 130), (1, 1, 1)]


@pytest.mark.parametrize("mkn", FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_side", [False, True], ids=["cols", "rows"])
def test_cpu_route_matches_pallas(mkn, k_side, xdtype):
    """quant_matmul's CPU route (the plain version the CUDA kernel is held
    to) against the reference's Pallas kernel at odd shapes."""
    m, k, n = mkn
    x, w, a_s, a_b, ws, _ = _inputs(m, k, n, k_side, seed=m + 2 * k + n)
    xj = jnp.asarray(x, dtype=xdtype)
    y_j = np.asarray(_jax_kernel(jqmm.quant_matmul, None, xj, w, a_s, a_b, ws,
                                 k_side, **QS))[:m, :n]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if xdtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    y_t = qmm.quant_matmul(xt, *_torch_args(w, a_s, a_b, ws), **QS).numpy()
    assert y_t.shape == (m, n) and y_t.dtype == np.float32
    np.testing.assert_allclose(y_t, y_j, rtol=0, atol=1e-5 * np.abs(y_j).max())


@pytest.mark.parametrize("emkn", [(3, 12, 41, 33), (2, 5, 9, 130)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_cpu_route_batched_matches_pallas(emkn, xdtype):
    """quant_matmul_batched's CPU route against the reference's batched
    Pallas kernel, and each expert against the 2D CPU route on its slices."""
    e, m, k, n = emkn
    qs = _qs(3, 3)
    x, w, a_s, a_b, ws, _ = _moe_inputs(e, m, k, n, seed=sum(emkn) + 5)
    xj = jnp.asarray(x, dtype=xdtype)
    y_j = np.asarray(_jax_batched(jqmm.quant_matmul_batched, None, xj, w, a_s,
                                  a_b, ws, **qs))[:, :m, :n]
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if xdtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    tw, ts, tb, tws = _torch_args(w, a_s, a_b, ws)
    y_t = qmm.quant_matmul_batched(xt, tw, ts, tb, tws, **qs)
    assert tuple(y_t.shape) == (e, m, n) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0,
                               atol=1e-5 * np.abs(y_j).max())
    for i in range(e):
        y2 = qmm.quant_matmul(xt[i], tw[i], ts[i, 0], tb[i, 0], tws[i:i + 1], **qs)
        np.testing.assert_allclose(y_t[i].numpy(), y2.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(y_j).max())
