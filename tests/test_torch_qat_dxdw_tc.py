"""The split dx / dw on the tensor cores: quant_matmul_dx, quant_matmul_dw
and quant_matmul_bwd's split route (the vocab-wide lm head) run one
prologue, which writes wd, xd and the cotangent's bf16 planes, then the dX
grid (`qat_dx_tc_launch`) and / or the dW grid (`qat_dw_tc_launch`). An f32
cotangent (the head's) is split exactly into three bf16 planes, hi + mid +
lo, whose bf16 x bf16 products are exact in f32 and sum to its f32
products; a bf16 cotangent is one plane.

On the CPU no kernel runs, so this pins the split's contract
(`ref.cotangent_planes`, which the CUDA prologue's split3 repeats), the
planar prologue, the three-plane product summed in f32 against the JAX
package's Pallas kernels (interpret mode) with the bars of
tests/test_torch_qat_kernels_ref.py, and, through a fake library on meta
tensors, the entries each wrapper launches, the plane count and scratch it
passes, and that a failed launch raises. chip_smoke.py (phase 5) holds the
kernels against the plain versions on the card.
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
from test_torch_qat_bwd_tc import _c_param_count  # noqa: E402
from test_torch_qat_kernels_ref import (QS, _assert_bf16_close, _inputs,  # noqa: E402
                                        _jax_kernel, _parts)

BF16_OVERFLOW = (2.0 - 2.0 ** -8) * 2.0 ** 127  # bf16(y) is Inf from here up


def _f32_values(lo_exp, hi_exp, sign, n, seed):
    """n f32 values with exponents uniform in [lo_exp, hi_exp) and random
    full mantissas, all of one sign, below bf16's overflow."""
    rng = np.random.default_rng(seed)
    y = (2.0 ** rng.uniform(lo_exp, hi_exp, n)).astype(np.float32)
    y = (y.view(np.uint32) ^ rng.integers(0, 1 << 23, n, dtype=np.uint32)).view(np.float32)
    y = y[np.isfinite(y) & (y < BF16_OVERFLOW) & (y >= 2.0 ** lo_exp)]
    return torch.from_numpy(sign * y)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["pos", "neg"])
@pytest.mark.parametrize("exps", [(-110, -100), (-100, -20), (-20, 20), (20, 128)],
                         ids=lambda e: f"2^{e[0]}..2^{e[1]}")
def test_split_is_exact(exps, sign):
    """hi + mid + lo == y in f64, bit for bit, for f32 y from 2^-110 up to
    bf16's overflow; every plane bf16-valued; |mid| <= half an ulp of hi."""
    y = _f32_values(*exps, sign, 50_000, seed=exps[0] + 1000 + 300 * (sign > 0))
    assert y.numel() > 40_000
    hi, mid, lo = ref.cotangent_planes(y, 3)
    for p in (hi, mid, lo):
        assert p.dtype == torch.float32 and torch.equal(ref._bf16(p), p)
    assert torch.equal(hi.double() + mid.double() + lo.double(), y.double())
    assert torch.all(mid.abs() <= ref._bf16(hi).abs() * 2.0 ** -8)


def test_split_of_zeros_and_non_finite_values():
    """±0 splits into three zeros of its sign; Inf and NaN keep hi and give
    mid = lo = 0, so no Inf - Inf = NaN appears; an f32 past bf16's largest
    finite value splits to Inf."""
    y = torch.tensor([0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                      BF16_OVERFLOW, -np.finfo(np.float32).max], dtype=torch.float32)
    hi, mid, lo = ref.cotangent_planes(y, 3)
    assert torch.equal(torch.signbit(hi[:2]), torch.tensor([False, True]))
    assert not hi[:2].any()
    assert hi[2] == float("inf") and hi[3] == float("-inf") and torch.isnan(hi[4])
    assert hi[5] == float("inf") and hi[6] == float("-inf")
    assert not mid.any() and not lo.any()
    assert not torch.isnan(mid).any() and not torch.isnan(lo).any()


def test_split_below_2_pow_minus_110_loses_under_2_pow_minus_133():
    """Below 2^-110, lo is a bf16 subnormal or lost: |hi + mid + lo - y|
    is at most 2^-134 (half of bf16's least subnormal), and 0 for some."""
    y = torch.cat([_f32_values(-149, -110, s, 50_000, seed=7) for s in (1.0, -1.0)])
    hi, mid, lo = ref.cotangent_planes(y, 3)
    err = (hi.double() + mid.double() + lo.double() - y.double()).abs()
    assert err.max().item() <= 2.0 ** -134
    assert (err == 0).any() and (err > 0).any()


def test_one_plane_is_bf16_and_plane_counts_are_checked():
    y = _f32_values(-30, 30, 1.0, 1000, seed=3)
    (hi,) = ref.cotangent_planes(y, 1)
    assert torch.equal(hi, ref._cotangent(y, True))
    assert qmm.plane_count(True) == 1 and qmm.plane_count(False) == 3
    with pytest.raises(ValueError, match="planes"):
        ref.cotangent_planes(y, 2)


@pytest.mark.parametrize("side", ["dx", "dw"])
def test_plane_products_sum_to_the_f32_products(side):
    """(hi + mid + lo) @ wd^T in f64 is dY @ wd^T in f64 (the planes sum to
    dY exactly), and the three planes' products, each exact, summed plane by
    plane in f64, agree with it within the f64 order bound."""
    m, k, n = 24, 40, 300
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, False, seed=11)
    dy = dy * np.float32(1e-3)
    xd, wd, _ = _parts(x, w, a_s, a_b, ws, dy, False)
    y = torch.from_numpy(dy)
    planes = ref.cotangent_planes(y, 3)
    other = wd.double() if side == "dx" else xd.double()
    prod = (lambda c: c @ other.T) if side == "dx" else (lambda c: other.T @ c)
    exact = prod(y.double())
    assert torch.equal(prod(sum(p.double() for p in planes)), exact)
    by_plane = prod(planes[0].double()) + prod(planes[1].double()) + prod(planes[2].double())
    length = n if side == "dx" else m
    abs_products = (y.double().abs() @ other.abs().T if side == "dx"
                    else other.abs().T @ y.double().abs())
    assert torch.all((by_plane - exact).abs() <= 2 * 3 * length * 2.0 ** -53 * abs_products)


SCRATCH = [(4096, 1024, 152064, 3), (4096, 1024, 49408, 3), (4096, 1024, 2816, 1),
           (257, 129, 65, 3), (1, 1, 1, 3)]


@pytest.mark.parametrize("mknp", SCRATCH, ids=lambda s: "x".join(map(str, s)))
def test_planar_scratch_bytes_and_shapes(mknp):
    m, k, n, planes = mknp
    lds, nbytes = qmm._bwd_tc_scratch(m, k, n, planes=planes)
    assert lds == qmm._bwd_tc_scratch(m, k, n)[0]
    assert nbytes == (2 * m * lds[0], 2 * k * lds[1], 2 * planes * m * lds[2])
    if mknp[:3] == (4096, 1024, 152064):  # the qwen head: 3.74 GB of planes, wd 0.31 GB
        assert nbytes[2] == 3_737_124_864 and nbytes[1] == 311_427_072
    xd, wd, dyb = qmm._bwd_tc_scratch_tensors((), m, k, n, "meta", planes, xd=False)
    assert xd is None and tuple(wd.shape) == (k, lds[1])
    assert tuple(dyb.shape) == ((m, lds[2]) if planes == 1 else (planes, m, lds[2]))


PROLOGUE = [((37, 130, 90), False, 3), ((20, 129, 65), True, 3), ((16, 64, 128), False, 1)]


@pytest.mark.parametrize("mkn,k_side,planes", PROLOGUE,
                         ids=["cols-3", "rows-odd-3", "cols-1"])
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_planar_prologue_is_its_definition(mkn, k_side, planes, xdtype):
    """bwd_prologue(planes=P) on CPU tensors: xd and wd as for one plane,
    and the planes (P, M, ld_y) (one plane: (M, ld_y)) equal to
    cotangent_planes, zero in the pad; per expert likewise."""
    m, k, n = mkn
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, k_side, seed=m + k + n + 3)
    dy[0, :4] = [0.0, -0.0, 1e-38, -3e-36]  # subnormal-lo territory
    args = (torch.from_numpy(dy), torch.from_numpy(x).to(xdtype), torch.from_numpy(w),
            torch.tensor(a_s), torch.tensor(a_b), torch.from_numpy(ws))
    xd, wd, dyb = qmm.bwd_prologue(*args, planes=planes, **QS)
    xd1, wd1, _ = qmm.bwd_prologue(*args, **QS)
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert torch.equal(xd, xd1) and torch.equal(wd, wd1)
    assert dyb.dtype == torch.bfloat16
    stacked = dyb if planes > 1 else dyb[None]
    assert tuple(stacked.shape) == (planes, m, lds[2])
    for got, want in zip(stacked, ref.cotangent_planes(args[0], planes)):
        assert torch.equal(got[:, :n].float(), want)
        assert not got[:, n:].any()
    if not k_side:  # per expert: (E, P, M, ld_y), each expert its own split
        e = 2
        ex = [torch.stack([a] * e) for a in args[:3]]
        _, _, dyb_e = ref.bwd_prologue(ex[0], ex[1], ex[2], torch.full((e, 1), a_s),
                                       torch.full((e, 1), a_b), args[5].expand(e, n),
                                       lds=lds, planes=planes, **QS)
        assert torch.equal(dyb_e, torch.stack([dyb] * e))


def _planar_backward(dy, x, w, a_s, a_b, ws, k_side, planes):
    """The plain backward with the cotangent multiplied plane by plane: each
    plane's exact products summed in f32, the planes added in order (hi,
    mid, lo), then the reference's bf16 rounding, masks and scale sums."""
    tx, tw, tws = (torch.from_numpy(v) for v in (x, w, ws))
    u, q, xd = ref._act_codes(tx, torch.tensor(a_s), torch.tensor(a_b),
                              QS["q_n_a"], QS["q_p_a"])
    uw, qw, wd = ref._weight_codes(tw, tws, QS["q_n_w"], QS["q_p_w"])
    cots = ref.cotangent_planes(torch.from_numpy(dy), planes)
    acc_x, acc_w = cots[0] @ wd.T, xd.T @ cots[0]
    for c in cots[1:]:
        acc_x, acc_w = acc_x + c @ wd.T, acc_w + xd.T @ c
    dxd, dwd = ref._bf16(acc_x), ref._bf16(acc_w)
    mf, mfw = ref._in_range(u, QS["q_n_a"], QS["q_p_a"]), ref._in_range(uw, QS["q_n_w"],
                                                                       QS["q_p_w"])
    part = dwd * (qw - mfw * uw)
    return (dxd * mf, (dxd * (q - mf * u)).sum(), (dxd * (1 - mf)).sum(), dwd * mfw,
            part.sum(dim=1 if k_side else 0, keepdim=True), part, (dxd, q, u, mf))


PLANAR = [((37, 130, 90), False, False), ((20, 129, 65), True, False),
          ((130, 64, 257), False, False), ((37, 130, 90), True, True),
          ((20, 129, 65), False, True)]


@pytest.mark.parametrize("mkn,k_side,round_cot", PLANAR,
                         ids=["cols-f32cot", "rows-f32cot-odd", "cols-f32cot-tall",
                              "rows-bf16cot", "cols-bf16cot-odd"])
def test_planar_plain_matches_pallas(mkn, k_side, round_cot):
    """The planar product (three planes for f32 cotangents, one for bf16),
    summed in f32, against the reference's quant_matmul_dx / _dw Pallas
    kernels (interpret mode) within the bars of the QAT kernel tests: the
    products the tensor-core grids add, in a plane-by-plane order."""
    m, k, n = mkn
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, k_side, seed=m * 3 + k + n)
    kw = dict(round_cot=round_cot, **QS)
    j_dx, j_dsa, j_dba = _jax_kernel(jqmm.quant_matmul_dx, dy, x, w, a_s, a_b, ws,
                                     k_side, **kw)
    j_dw, j_dws = _jax_kernel(jqmm.quant_matmul_dw, dy, x, w, a_s, a_b, ws, k_side, **kw)
    dx, dsa, dba, dw, dws, part, (dxd, q, u, mf) = _planar_backward(
        dy, x, w, a_s, a_b, ws, k_side, qmm.plane_count(round_cot))
    xd, wd, cot = _parts(x, w, a_s, a_b, ws, dy, round_cot)
    _assert_bf16_close(dx.numpy(), np.asarray(j_dx)[:m, :k],
                       (cot.abs() @ wd.abs().T).numpy(), n)
    _assert_bf16_close(dw.numpy(), np.asarray(j_dw)[:k, :n],
                       (xd.abs().T @ cot.abs()).numpy(), m)
    assert abs(float(dsa) - float(j_dsa)) <= 1e-4 * float((dxd * (q - mf * u)).abs().sum())
    assert abs(float(dba) - float(j_dba)) <= 1e-4 * float((dxd * (1 - mf)).abs().sum())
    l1 = part.abs().sum(dim=1 if k_side else 0, keepdim=True).numpy()
    j_ws = np.asarray(j_dws)[:k] if k_side else np.asarray(j_dws)[:, :n]
    assert dws.shape == j_ws.shape and np.all(np.abs(dws.numpy() - j_ws) <= 1e-4 * l1)


# ---------------------------------------------------------------------------
# the wrappers, through a fake kernel library
# ---------------------------------------------------------------------------

SPLIT_ENTRIES = ("qat_bwd_prologue_launch", "qat_dx_tc_launch", "qat_dw_tc_launch")


@pytest.fixture
def fake_lib(monkeypatch):
    """A fake kernel library that records each launch and returns the code
    set for its entry, operand checks that let meta tensors through, and
    scratch whose data pointers are tagged (xd 0x1000, wd 0x2000, planes
    0x3000), so the pointers each entry gets show."""
    calls = []
    rcs = dict.fromkeys(SPLIT_ENTRIES + ("qat_bwd_tc_launch",), 0)

    def entry(name):
        def launch(*args):
            calls.append((name, args))
            return rcs[name]
        return launch

    lib = types.SimpleNamespace(**{n: entry(n) for n in rcs})

    def operands(x, w, a_scale, a_offset, w_scale, dy=None):
        k_side = tuple(w_scale.shape) != (1, w.shape[1])
        return (x, w, a_scale, a_offset, w_scale.reshape(-1), k_side, dy)

    allocate = qmm._bwd_tc_scratch_tensors

    def tensors(lead, m, k, n, device, planes=1, xd=True, wd=True):
        real = allocate(lead, m, k, n, "meta", planes, xd, wd)
        return tuple(None if t is None else
                     types.SimpleNamespace(shape=t.shape, dtype=t.dtype,
                                           data_ptr=lambda i=i: 0x1000 * (i + 1))
                     for i, t in enumerate(real))

    monkeypatch.setattr(qmm, "_qat_lib", lambda: lib)
    # meta tensors take the plain versions now (the dry run's route): send
    # them down the launch path, as CUDA tensors go, to reach the fake library
    monkeypatch.setattr(ref, "takes_plain", lambda t: t.device.type == "cpu")
    monkeypatch.setattr(qmm, "_qat_operands", operands)
    monkeypatch.setattr(qmm, "_bwd_tc_scratch_tensors", tensors)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls, rcs


def _meta_operands(m, k, n, k_side=False, x_dtype=torch.bfloat16):
    meta = dict(device="meta")
    return (torch.empty((m, n), **meta), torch.empty((m, k), dtype=x_dtype, **meta),
            torch.empty((k, n), **meta), torch.empty((), **meta), torch.empty((), **meta),
            torch.empty((k, 1) if k_side else (1, n), **meta))


def _check_prologue_args(args, m, k, n, planes, xd: bool, wd: bool):
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert len(args) == _c_param_count("qat_bwd_prologue_launch")
    assert args[8:14] == (0x1000 if xd else 0, lds[0], 0x2000 if wd else 0, lds[1],
                          0x3000, lds[2])
    assert args[14:18] == (1, m, k, n) and args[-2] == planes


@pytest.mark.parametrize("name", ["quant_matmul_dx", "quant_matmul_dw"], ids=["dx", "dw"])
@pytest.mark.parametrize("round_cot", [False, True], ids=["f32cot", "bf16cot"])
def test_wrapper_passes_the_plane_count(fake_lib, name, round_cot):
    """quant_matmul_dx / _dw: the prologue with 3 planes for f32 cotangents
    and 1 for bf16, writing no xd for dX and no wd for dW, then its grid on
    that scratch; one launch counted on the wrapper."""
    calls, _ = fake_lib
    m, k, n = 64, 1024, 152064
    planes = 1 if round_cot else 3
    fn = getattr(qmm, name)
    before = fn.launches
    out = fn(*_meta_operands(m, k, n), round_cot=round_cot, **QS)
    grid = "qat_dx_tc_launch" if name == "quant_matmul_dx" else "qat_dw_tc_launch"
    assert [c for c, _ in calls] == ["qat_bwd_prologue_launch", grid]
    _check_prologue_args(calls[0][1], m, k, n, planes, xd=grid == "qat_dw_tc_launch",
                         wd=grid == "qat_dx_tc_launch")
    args = calls[1][1]
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert len(args) == _c_param_count(grid) and args[-2] == planes
    assert args[-9:-6] == (m, k, n) and args[1] == 1
    if grid == "qat_dx_tc_launch":
        assert args[11:15] == (0x2000, lds[1], 0x3000, lds[2])
        assert [tuple(t.shape) for t in out] == [(m, k), (), ()]
    else:
        assert args[10:14] == (0x1000, lds[0], 0x3000, lds[2])
        assert [tuple(t.shape) for t in out] == [(k, n), (1, n)]
    assert fn.launches == before + 1


@pytest.mark.parametrize("k_side", [False, True], ids=["cols", "rows"])
def test_split_route_runs_one_prologue_then_both_grids(fake_lib, k_side):
    """quant_matmul_bwd at the qwen head with f32 cotangents: one prologue
    (xd, wd and three planes), then the dX and the dW grid on it; one
    launch counted on quant_matmul_dx and one on quant_matmul_dw, none on
    quant_matmul_bwd (the launch formula of chip_smoke.py)."""
    calls, _ = fake_lib
    m, k, n = 4096, 1024, 152064
    counts = [qmm.quant_matmul_dx.launches, qmm.quant_matmul_dw.launches,
              qmm.quant_matmul_bwd.launches]
    out = qmm.quant_matmul_bwd(*_meta_operands(m, k, n, k_side, torch.float32),
                               round_cot=False, **QS)
    assert [c for c, _ in calls] == list(SPLIT_ENTRIES)
    _check_prologue_args(calls[0][1], m, k, n, 3, xd=True, wd=True)
    assert calls[0][1][2] == 0 and calls[0][1][7] == int(k_side)
    for _, args in calls[1:]:
        assert args[-2] == 3 and args[6] == int(k_side)
    assert [tuple(t.shape) for t in out] == [(m, k), (), (), (k, n),
                                             (k, 1) if k_side else (1, n)]
    assert [qmm.quant_matmul_dx.launches, qmm.quant_matmul_dw.launches,
            qmm.quant_matmul_bwd.launches] == [counts[0] + 1, counts[1] + 1, counts[2]]


@pytest.mark.parametrize("failing", SPLIT_ENTRIES, ids=["prologue", "dx", "dw"])
def test_failed_split_launch_raises_without_fallback(fake_lib, failing):
    """A failed launch of any of the three raises, names its entry, launches
    nothing after it and counts nothing: no plain or combined fallback."""
    calls, rcs = fake_lib
    rcs[failing] = 2  # cudaErrorMemoryAllocation
    counts = (qmm.quant_matmul_dx.launches, qmm.quant_matmul_dw.launches)
    with pytest.raises(RuntimeError, match=f"{failing} failed: cudaError 2"):
        qmm.quant_matmul_bwd(*_meta_operands(4096, 1024, 152064), round_cot=False, **QS)
    assert [c for c, _ in calls] == list(SPLIT_ENTRIES[:SPLIT_ENTRIES.index(failing) + 1])
    assert (qmm.quant_matmul_dx.launches, qmm.quant_matmul_dw.launches) == counts


def test_planar_prologue_wrapper_passes_the_planes(fake_lib):
    calls, _ = fake_lib
    m, k, n = 257, 129, 65
    xd, wd, dyb = qmm.bwd_prologue(*_meta_operands(m, k, n, True), planes=3, **QS)
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    assert tuple(dyb.shape) == (3, m, lds[2])
    assert [c for c, _ in calls] == ["qat_bwd_prologue_launch"]
    _check_prologue_args(calls[0][1], m, k, n, 3, xd=True, wd=True)
    with pytest.raises(ValueError, match="planes"):
        qmm.bwd_prologue(*_meta_operands(m, k, n), planes=2, **QS)


def _c_param_kinds(fn: str) -> list:
    src = build.SOURCES["qat_matmul"].read_text()
    params = re.search(r'extern "C" [\w ]+\b' + fn + r"\(([^)]*)\)", src).group(1)
    return ["p" if "*" in p else "i" for p in params.split(",") if p.strip()]


@pytest.mark.parametrize("fn", SPLIT_ENTRIES + ("qat_bwd_tc_launch",))
def test_ctypes_types_follow_the_c_entries(monkeypatch, fn):
    """Each backward entry's ctypes argument types, in order: a pointer
    where the C entry takes one, an int where it takes an int."""
    import ctypes
    fake = types.SimpleNamespace(qat_tile=lambda: qmm.QAT_TILE, **{
        name: types.SimpleNamespace() for name in (
            "qat_fwd_tc_launch", "qat_fwd_prologue_launch",
            "qat_bwd_tc_launch") + SPLIT_ENTRIES})
    monkeypatch.setattr(build, "load", lambda name: fake)
    monkeypatch.setattr(qmm, "_QAT_SIGNED", False)
    qmm._qat_lib()
    kinds = ["p" if t is ctypes.c_void_p else "i" for t in getattr(fake, fn).argtypes]
    assert kinds == _c_param_kinds(fn)
