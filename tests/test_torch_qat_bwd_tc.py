"""quant_matmul_bwd's two combined paths: the tensor-core backward for bf16
cotangents (a prologue that writes xd, wd and bf16(dY) to zero-padded bf16
scratch, then an mma.sync tile) and the SIMT backward for f32 cotangents;
and which entries its split route launches (tests/test_torch_qat_dxdw_tc.py
has the rest of the split route).

On the CPU no kernel runs, so this pins what surrounds them: the scratch
shapes, the route rule and the entry each route launches (through a fake
library on meta tensors), the plain prologue against the quantizers, and
the CPU route of quant_matmul_bwd against the JAX package's Pallas kernel
with the bars of tests/test_torch_qat_kernels_ref.py. The kernels
themselves are held against the plain versions on the card by
chip_smoke.py (phase 5).
"""
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from test_torch_qat_kernels_ref import (QS, _assert_bf16_close, _inputs,  # noqa: E402
                                        _jax_kernel, _parts)

SCRATCH_SHAPES = [(4096, 1024, 2816), (4096, 2816, 1024), (4096, 1000, 2817),
                  (1000, 700, 300), (257, 129, 65), (1, 1, 1), (8, 9, 15)]


@pytest.mark.parametrize("mkn", SCRATCH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_scratch_leading_dims_and_bytes(mkn):
    m, k, n = mkn
    lds, nbytes = qmm._bwd_tc_scratch(m, k, n)
    for ld, true in zip(lds, (k, n, n)):
        assert ld % 8 == 0 and true <= ld < true + 8
    assert nbytes == (2 * m * lds[0], 2 * k * lds[1], 2 * m * lds[2])
    if mkn == (4096, 1024, 2816):  # the FFN's backward: ~37 MB of scratch
        assert lds == (1024, 2816, 2816) and sum(nbytes) == 37_224_448


ROUTES = [((4096, 1024, 2816), True, "tc"), ((4096, 1024, 2816), False, "simt"),
          ((4096, 1000, 2817), True, "tc"), ((257, 129, 65), True, "tc"),
          ((4096, 1024, 152064), True, "split"), ((4096, 1024, 152064), False, "split"),
          ((37, 130, 90), False, "simt")]


@pytest.mark.parametrize("mkn,round_cot,want", ROUTES,
                         ids=[f"{'x'.join(map(str, s))}-{r}" for s, _, r in ROUTES])
def test_route_rule(mkn, round_cot, want):
    """bf16 cotangents on the combined route -> tensor cores; f32 -> SIMT;
    past the reference's scratch budget (vocab-wide N) -> split."""
    assert qmm.bwd_route(*mkn, round_cot) == want
    assert (want != "split") == qmm.bwd_uses_combined(*qmm.padded_dims(*mkn))


def _c_param_count(fn: str) -> int:
    src = build.SOURCES["qat_matmul"].read_text()
    found = re.search(r'extern "C" [\w ]+\b' + fn + r"\(([^)]*)\)", src)
    assert found, fn
    return len([p for p in found.group(1).split(",") if p.strip()])


@pytest.fixture
def fake_qat_lib(monkeypatch):
    """A fake kernel library that records each launch, and operand checks
    that let meta tensors (no data, not on the CPU) through to the launch."""
    calls = []
    status = {"rc": 0}

    def entry(name):
        def launch(*args):
            calls.append((name, args))
            return status["rc"]
        return launch

    lib = types.SimpleNamespace(**{n: entry(n) for n in (
        "qat_bwd_launch", "qat_bwd_tc_launch", "qat_dx_tc_launch", "qat_dw_tc_launch",
        "qat_bwd_prologue_launch")})

    def operands(x, w, a_scale, a_offset, w_scale, dy=None):
        k_side = tuple(w_scale.shape) != (1, w.shape[1])
        return (x, w, a_scale, a_offset, w_scale.reshape(-1), k_side, dy)

    monkeypatch.setattr(qmm, "_qat_lib", lambda: lib)
    monkeypatch.setattr(qmm, "_qat_operands", operands)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls, status


def _meta_operands(m, k, n, k_side=False):
    meta = dict(device="meta")
    return (torch.empty((m, n), **meta), torch.empty((m, k), dtype=torch.bfloat16, **meta),
            torch.empty((k, n), **meta), torch.empty((), **meta), torch.empty((), **meta),
            torch.empty((k, 1) if k_side else (1, n), **meta))


PATH_CASES = [((256, 1024, 2816), False, True, ["qat_bwd_tc_launch"]),
              ((257, 129, 65), True, True, ["qat_bwd_tc_launch"]),
              ((256, 1024, 2816), False, False, ["qat_bwd_launch"]),
              ((64, 1024, 152064), False, True, ["qat_bwd_prologue_launch", "qat_dx_tc_launch",
                                                 "qat_dw_tc_launch"])]


@pytest.mark.parametrize("mkn,k_side,round_cot,entries", PATH_CASES,
                         ids=["tc", "tc-rows-odd", "simt-f32", "split-head"])
def test_wrapper_launches_the_route_entry(fake_qat_lib, mkn, k_side, round_cot, entries):
    calls, _ = fake_qat_lib
    m, k, n = mkn
    before = qmm.quant_matmul_bwd.launches
    out = qmm.quant_matmul_bwd(*_meta_operands(m, k, n, k_side), round_cot=round_cot, **QS)
    assert [name for name, _ in calls] == entries
    assert [tuple(t.shape) for t in out] == [(m, k), (), (), (k, n),
                                             (k, 1) if k_side else (1, n)]
    split = "qat_dx_tc_launch" in entries
    for name, args in calls:
        assert len(args) == _c_param_count(name), name
        # the combined entries take round_cot there, the split route's the planes
        assert args[-2] == (qmm.plane_count(round_cot) if split else int(round_cot))
        assert args[-9:-6] == (m, k, n)
    if entries == ["qat_bwd_tc_launch"]:
        lds, _ = qmm._bwd_tc_scratch(m, k, n)
        args = calls[0][1]
        assert (args[16], args[18], args[20]) == lds
    assert qmm.quant_matmul_bwd.launches == before + (not split)


def test_failed_tc_launch_raises_without_fallback(fake_qat_lib):
    calls, status = fake_qat_lib
    status["rc"] = 2  # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="qat_bwd_tc_launch failed: cudaError 2"):
        qmm.quant_matmul_bwd(*_meta_operands(256, 1024, 2816), round_cot=True, **QS)
    assert [name for name, _ in calls] == ["qat_bwd_tc_launch"]


def test_prologue_wrapper_passes_the_scratch(fake_qat_lib):
    calls, _ = fake_qat_lib
    m, k, n = 257, 129, 65
    xd, wd, dyb = qmm.bwd_prologue(*_meta_operands(m, k, n, True), **QS)
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert [tuple(t.shape) for t in (xd, wd, dyb)] == [(m, lds[0]), (k, lds[1]), (m, lds[2])]
    assert all(t.dtype == torch.bfloat16 for t in (xd, wd, dyb))
    name, args = calls[0]
    assert name == "qat_bwd_prologue_launch" and len(args) == _c_param_count(name)
    assert (args[9], args[11], args[13]) == lds and args[14:18] == (1, m, k, n)


@pytest.mark.parametrize("mkn", [(37, 130, 90), (20, 129, 65), (16, 64, 128)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("k_side", [False, True], ids=["cols", "rows"])
def test_cpu_prologue_is_the_plain_dequantization(mkn, xdtype, k_side):
    """On a CPU tensor bwd_prologue is the plain version: the quantizers'
    bf16 values, bf16(dY), and zeros in the pad."""
    m, k, n = mkn
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, k_side, seed=m * k + n)
    tx = torch.from_numpy(x).to(xdtype)
    args = (torch.from_numpy(dy), tx, torch.from_numpy(w), torch.tensor(a_s),
            torch.tensor(a_b), torch.from_numpy(ws))
    xd, wd, dyb = qmm.bwd_prologue(*args, **QS)
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert [tuple(t.shape) for t in (xd, wd, dyb)] == [(m, lds[0]), (k, lds[1]), (m, lds[2])]
    want = (ref._act_codes(tx, args[3], args[4], QS["q_n_a"], QS["q_p_a"])[2],
            ref._weight_codes(args[2], args[5], QS["q_n_w"], QS["q_p_w"])[2],
            ref._cotangent(args[0], True))
    for got, w_ in zip((xd, wd, dyb), want):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got[:, :w_.shape[1]].float(), w_)
        assert not got[:, w_.shape[1]:].any()


CPU_ROUTE = [((37, 130, 90), False, True), ((20, 129, 65), True, True),
             ((37, 130, 90), False, False)]


@pytest.mark.parametrize("mkn,k_side,round_cot", CPU_ROUTE,
                         ids=["cols-bf16cot", "rows-bf16cot-odd", "cols-f32cot"])
def test_cpu_route_matches_pallas(mkn, k_side, round_cot):
    """The CPU route of quant_matmul_bwd (the plain version both CUDA paths
    are held to) against the reference's combined Pallas kernel."""
    m, k, n = mkn
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, k_side, seed=m + k + n + 7)
    kw = dict(round_cot=round_cot, **QS)
    want = _jax_kernel(jqmm.quant_matmul_bwd, dy, x, w, a_s, a_b, ws, k_side, **kw)
    targs = [torch.from_numpy(v) if isinstance(v, np.ndarray) else torch.tensor(v)
             for v in (dy, x, w, a_s, a_b, ws)]
    got = qmm.quant_matmul_bwd(*targs, **kw)
    xd, wd, cot = _parts(x, w, a_s, a_b, ws, dy, round_cot)
    _assert_bf16_close(got[0].numpy(), np.asarray(want[0])[:m, :k],
                       (cot.abs() @ wd.abs().T).numpy(), n)
    _assert_bf16_close(got[3].numpy(), np.asarray(want[3])[:k, :n],
                       (xd.abs().T @ cot.abs()).numpy(), m)
    u, q, _ = ref._act_codes(torch.from_numpy(x), targs[3], targs[4],
                             QS["q_n_a"], QS["q_p_a"])
    mf = ref._in_range(u, QS["q_n_a"], QS["q_p_a"])
    dxd = ref._bf16(cot @ wd.T)
    assert abs(float(got[1]) - float(want[1])) <= 1e-4 * float((dxd * (q - mf * u)).abs().sum())
    assert abs(float(got[2]) - float(want[2])) <= 1e-4 * float((dxd * (1 - mf)).abs().sum())
    uw, qw, _ = ref._weight_codes(targs[2], targs[5], QS["q_n_w"], QS["q_p_w"])
    mfw = ref._in_range(uw, QS["q_n_w"], QS["q_p_w"])
    l1 = (ref._bf16(xd.T @ cot) * (qw - mfw * uw)).abs().sum(dim=1 if k_side else 0,
                                                            keepdim=True)
    ws_want = np.asarray(want[4])[:k] if k_side else np.asarray(want[4])[:, :n]
    assert got[4].shape == ws_want.shape
    assert np.all(np.abs(got[4].numpy() - ws_want) <= 1e-4 * l1.numpy())
