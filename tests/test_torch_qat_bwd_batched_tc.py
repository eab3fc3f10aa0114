"""quant_matmul_bwd_batched's two routes: the tensor-core backward (the
prologue writes xd, wd and the cotangent's planes to zero-padded bf16
scratch, the expert on blockIdx.y; then the 2D backward's mma.sync tile,
the expert on blockIdx.z: `qat_bwd_tc_launch` with E > 1; one plane,
bf16(dY), for bf16 cotangents, three exact planes and the 2D backward's
dW ranges for f32 ones), and past the reference's scratch budget the split
dx / dw grids expert by expert.

On the CPU no kernel runs, so this pins what surrounds them: the
per-expert scratch shapes and bytes, the entry each route launches and the
order of its arguments (through a fake library on meta tensors), that a
failed launch raises with no fallback, and the plain per-expert prologue
against the quantizers. The route rule and the CPU route against the JAX
package's batched Pallas kernel (an odd shape among them) are in
tests/test_torch_moe_kernels_ref.py. The kernels themselves are held
against the plain versions on the card by chip_smoke.py (phase 5b).
"""
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the helpers below come from a module that imports it

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from test_torch_moe_kernels_ref import _inputs, _qs, _t  # noqa: E402
from test_torch_qat_bwd_tc import _c_param_count  # noqa: E402

QS = _qs(3, 3)  # w3a3, granite-moe's experts

SCRATCH_SHAPES = [(32, 1280, 1024, 512), (32, 1280, 512, 1024), (3, 257, 129, 65),
                  (1, 4096, 1024, 2816), (2, 1, 1, 1), (4, 256, 512, 8192)]


@pytest.mark.parametrize("emkn", SCRATCH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scratch_per_expert_shapes_and_bytes(emkn):
    e, m, k, n = emkn
    lds, nbytes = qmm._bwd_tc_scratch(m, k, n, e)
    for ld, true in zip(lds, (k, n, n)):
        assert ld % 8 == 0 and true <= ld < true + 8
    assert nbytes == (2 * e * m * lds[0], 2 * e * k * lds[1], 2 * e * m * lds[2])
    assert qmm._bwd_tc_scratch(m, k, n)[0] == lds  # per expert as in 2D
    assert qmm._bwd_tc_scratch(m, k, n)[1] == tuple(b // e for b in nbytes)
    # each expert's slice starts 16-byte aligned: rows x ld x 2 bytes, ld % 8 == 0
    assert all(rows * ld * 2 % 16 == 0 for rows, ld in zip((m, k, m), lds))
    if emkn == (32, 1280, 1024, 512):  # xd 84 MB + wd 34 MB + bf16 dY 42 MB
        assert nbytes == (83_886_080, 33_554_432, 41_943_040)
        assert sum(nbytes) == 159_383_552
    xd, wd, dyb = qmm._bwd_tc_scratch_tensors((e,), m, k, n, "meta")
    assert [tuple(t.shape) for t in (xd, wd, dyb)] == [(e, m, lds[0]), (e, k, lds[1]),
                                                       (e, m, lds[2])]
    assert all(t.dtype == torch.bfloat16 for t in (xd, wd, dyb))


ENTRIES = ("qat_bwd_tc_launch", "qat_dx_tc_launch", "qat_dw_tc_launch",
           "qat_bwd_prologue_launch")


@pytest.fixture
def fake_lib(monkeypatch):
    """A fake kernel library that records each launch, operand checks that
    let meta tensors (no data, not on the CPU) through to the launch, and
    scratch whose data pointers are tagged (the bf16 arrays 0x1000-0x3000,
    a split dW's sums and tickets 0x4000 / 0x5000), so the argument order
    shows; status["scratch"] keeps the shapes each allocation had."""
    calls = []
    status = {"rc": 0, "scratch": {}}

    def entry(name):
        def launch(*args):
            calls.append((name, args))
            return status["rc"]
        return launch

    lib = types.SimpleNamespace(**{n: entry(n) for n in ENTRIES})

    def operands(x, w, a_scale, a_offset, w_scale, dy=None):
        k_side = tuple(w_scale.shape) != (1, w.shape[1])
        return (x, w, a_scale, a_offset, w_scale.reshape(-1), k_side, dy)

    def batched(x, w, a_scale, a_offset, w_scale, dy=None):
        e = x.shape[0]
        return (x, w, a_scale.reshape(e), a_offset.reshape(e), w_scale, dy)

    allocate = qmm._bwd_tc_scratch_tensors

    def tensors(lead, m, k, n, device, planes=1, xd=True, wd=True):
        real = allocate(lead, m, k, n, "meta", planes, xd, wd)
        status["scratch"]["bf16"] = [None if t is None else tuple(t.shape) for t in real]
        return tuple(None if t is None else
                     types.SimpleNamespace(shape=t.shape, dtype=t.dtype,
                                           data_ptr=lambda i=i: 0x1000 * (i + 1))
                     for i, t in enumerate(real))

    split_scratch = qmm._dw_split_scratch

    def sums(lead, m, k, n, splits, device):
        real = split_scratch(lead, m, k, n, splits, "meta")
        status["scratch"]["split"] = real
        return tuple(None if t is None else types.SimpleNamespace(data_ptr=lambda v=v: v)
                     for t, v in zip(real, (0x4000, 0x5000)))

    monkeypatch.setattr(qmm, "_qat_lib", lambda: lib)
    # meta tensors take the plain versions now (the dry run's route): send
    # them down the launch path, as CUDA tensors go, to reach the fake library
    monkeypatch.setattr(ref, "takes_plain", lambda t: t.device.type == "cpu")
    monkeypatch.setattr(qmm, "_dw_split_scratch", sums)
    monkeypatch.setattr(qmm, "_qat_operands", operands)
    monkeypatch.setattr(qmm, "_batched_operands", batched)
    monkeypatch.setattr(qmm, "_bwd_tc_scratch_tensors", tensors)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls, status


def _meta_operands(e, m, k, n, x_dtype=torch.bfloat16):
    meta = dict(device="meta")
    return (torch.empty((e, m, n), **meta), torch.empty((e, m, k), dtype=x_dtype, **meta),
            torch.empty((e, k, n), **meta), torch.empty((e, 1), **meta),
            torch.empty((e, 1), **meta), torch.empty((e, n), **meta))


def _check_shapes(out, e, m, k, n):
    assert [tuple(t.shape) for t in out] == [(e, m, k), (e, 1), (e, 1), (e, k, n), (e, n)]
    assert all(t.dtype == torch.float32 for t in out)


@pytest.mark.parametrize("emkn,x_dtype", [((32, 1280, 1024, 512), torch.bfloat16),
                                          ((32, 1280, 512, 1024), torch.bfloat16),
                                          ((3, 257, 129, 65), torch.float32)],
                         ids=["experts-in", "experts-out", "odd-f32x"])
def test_bf16_cotangents_launch_the_tensor_core_entry(fake_lib, emkn, x_dtype):
    """bf16 cotangents: qat_bwd_tc_launch once, in the declared order: dy,
    x, x_bf16, w, a_s, a_b, ws, k_side 0, dx, dsa, dba, dw, dws, part_x,
    part_w, xd, ld_x, wd, ld_w, dyb, ld_y, the split dW's sums and tickets
    (none: one plane never splits), splits 1, its rows M, E, M, K, N, the
    four code bounds, planes 1, the stream."""
    calls, _ = fake_lib
    e, m, k, n = emkn
    before = qmm.quant_matmul_bwd_batched.launches
    out = qmm.quant_matmul_bwd_batched(*_meta_operands(e, m, k, n, x_dtype), **QS)
    _check_shapes(out, e, m, k, n)
    assert [name for name, _ in calls] == ["qat_bwd_tc_launch"]
    args = calls[0][1]
    assert len(args) == _c_param_count("qat_bwd_tc_launch") == 35
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert args[2] == int(x_dtype == torch.bfloat16) and args[7] == 0
    assert args[15:21] == (0x1000, lds[0], 0x2000, lds[1], 0x3000, lds[2])
    assert args[21:25] == (None, None, 1, m)
    assert args[25:29] == (e, m, k, n)
    assert args[29:33] == (QS["q_n_a"], QS["q_p_a"], QS["q_n_w"], QS["q_p_w"])
    assert args[33] == 1
    assert qmm.quant_matmul_bwd_batched.launches == before + 1


@pytest.mark.parametrize("emkn", [(32, 1280, 1024, 512), (3, 257, 129, 65), (2, 64, 1024, 2816)],
                         ids=["experts-in", "odd", "wide"])
def test_f32_cotangents_launch_the_tensor_core_entry(fake_lib, emkn):
    """f32 cotangents: the same entry with planes 3, the planes' scratch
    (E, 3, M, ld_y), and the 2D backward's dW ranges (`dw_splits` on the
    per-expert shape, so an expert's bits are the 2D kernel's): where it
    cuts, the (E, S, K, N) sums and one ticket a dW tile of every expert."""
    calls, status = fake_lib
    e, m, k, n = emkn
    before = qmm.quant_matmul_bwd_batched.launches
    out = qmm.quant_matmul_bwd_batched(*_meta_operands(e, m, k, n), round_cot=False, **QS)
    _check_shapes(out, e, m, k, n)
    assert [name for name, _ in calls] == ["qat_bwd_tc_launch"]
    args = calls[0][1]
    assert len(args) == _c_param_count("qat_bwd_tc_launch")
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert status["scratch"]["bf16"] == [(e, m, lds[0]), (e, k, lds[1]), (e, 3, m, lds[2])]
    splits, rows = qmm.dw_splits(m, k, n, 3)
    assert args[23:29] == (splits, rows, e, m, k, n) and args[33] == 3
    part_s, tickets = status["scratch"]["split"]
    if splits == 1:
        assert args[21:23] == (None, None) and part_s is None
    else:
        assert args[21:23] == (0x4000, 0x5000)
        assert tuple(part_s.shape) == (e, splits, k, n) and part_s.dtype == torch.float32
        assert tickets.dtype == torch.int32
        assert tickets.numel() >= e * -(-k // 128) * -(-n // 128)
    assert qmm.quant_matmul_bwd_batched.launches == before + 1


@pytest.mark.parametrize("round_cot", [True, False], ids=["bf16cot", "f32cot"])
def test_wide_n_splits_expert_by_expert(fake_lib, round_cot):
    """Past the reference's scratch budget: for each expert, on its (M, K,
    N), the split route's prologue, then qat_dx_tc_launch and
    qat_dw_tc_launch on its planes (1 for bf16 cotangents, 3 for f32), and
    no batched launch."""
    calls, _ = fake_lib
    e, m, k, n = 4, 256, 512, 8192
    before = qmm.quant_matmul_bwd_batched.launches
    out = qmm.quant_matmul_bwd_batched(*_meta_operands(e, m, k, n), round_cot=round_cot,
                                       **QS)
    _check_shapes(out, e, m, k, n)
    assert [name for name, _ in calls] == ["qat_bwd_prologue_launch", "qat_dx_tc_launch",
                                           "qat_dw_tc_launch"] * e
    for name, args in calls:
        assert len(args) == _c_param_count(name), name
        assert args[-9:-6] == (m, k, n) and args[-2] == (1 if round_cot else 3)
    assert qmm.quant_matmul_bwd_batched.launches == before


def test_2d_tensor_core_launch_passes_one_expert(fake_lib):
    calls, _ = fake_lib
    m, k, n = 256, 1024, 512
    meta = dict(device="meta")
    qmm.quant_matmul_bwd(torch.empty((m, n), **meta),
                         torch.empty((m, k), dtype=torch.bfloat16, **meta),
                         torch.empty((k, n), **meta), torch.empty((), **meta),
                         torch.empty((), **meta), torch.empty((1, n), **meta), **QS)
    name, args = calls[0]
    assert name == "qat_bwd_tc_launch" and len(args) == _c_param_count(name)
    assert args[25:29] == (1, m, k, n)


def test_failed_tc_launch_raises_without_fallback(fake_lib):
    calls, status = fake_lib
    status["rc"] = 2  # cudaErrorMemoryAllocation
    before = qmm.quant_matmul_bwd_batched.launches
    with pytest.raises(RuntimeError, match="qat_bwd_tc_launch failed: cudaError 2"):
        qmm.quant_matmul_bwd_batched(*_meta_operands(32, 1280, 1024, 512), **QS)
    assert [name for name, _ in calls] == ["qat_bwd_tc_launch"]
    assert qmm.quant_matmul_bwd_batched.launches == before


def test_batched_prologue_wrapper_passes_the_scratch(fake_lib):
    calls, _ = fake_lib
    e, m, k, n = 3, 257, 129, 65
    xd, wd, dyb = qmm.bwd_prologue(*_meta_operands(e, m, k, n), **QS)
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert [tuple(t.shape) for t in (xd, wd, dyb)] == [(e, m, lds[0]), (e, k, lds[1]),
                                                       (e, m, lds[2])]
    name, args = calls[0]
    assert name == "qat_bwd_prologue_launch" and len(args) == _c_param_count(name) == 24
    assert args[7] == 0
    assert args[8:14] == (0x1000, lds[0], 0x2000, lds[1], 0x3000, lds[2])
    assert args[14:18] == (e, m, k, n)


@pytest.mark.parametrize("emkn", [(3, 12, 32, 40), (3, 17, 9, 13), (2, 5, 41, 33)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_prologue_per_expert_is_the_plain_dequantization(emkn, xdtype):
    """On CPU tensors (E, M, K) bwd_prologue is the plain version: each
    expert's slices are its quantizers' bf16 values and bf16(dY[e]), zero
    in the pad, and equal to the 2D prologue on that expert's operands."""
    e, m, k, n = emkn
    x, w, a_s, a_b, ws, dy = _inputs(e, m, k, n, seed=sum(emkn) + 5)
    tdy, tx, tw, ts, tb, tws = _t(dy, x, w, a_s, a_b, ws)
    tx = tx.to(xdtype)
    xd, wd, dyb = qmm.bwd_prologue(tdy, tx, tw, ts, tb, tws, **QS)
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert [tuple(t.shape) for t in (xd, wd, dyb)] == [(e, m, lds[0]), (e, k, lds[1]),
                                                       (e, m, lds[2])]
    for i in range(e):
        want = (ref._act_codes(tx[i], ts[i, 0], tb[i, 0], QS["q_n_a"], QS["q_p_a"])[2],
                ref._weight_codes(tw[i], tws[i:i + 1], QS["q_n_w"], QS["q_p_w"])[2],
                ref._cotangent(tdy[i], True))
        for got, w_ in zip((xd[i], wd[i], dyb[i]), want):
            assert got.dtype == torch.bfloat16
            assert torch.equal(got[:, :w_.shape[1]].float(), w_)
            assert not got[:, w_.shape[1]:].any()
        two_d = qmm.bwd_prologue(tdy[i], tx[i], tw[i], ts[i, 0], tb[i, 0], tws[i:i + 1],
                                 **QS)
        assert all(torch.equal(a, b) for a, b in zip((xd[i], wd[i], dyb[i]), two_d))
