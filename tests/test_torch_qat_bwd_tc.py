"""quant_matmul_bwd's combined path, the tensor-core backward (a prologue
that writes xd, wd and the cotangent's bf16 planes to zero-padded bf16
scratch, then an mma.sync tile: one plane, bf16(dY), for bf16 cotangents,
three exact planes for f32 ones, the dW contraction cut by `dw_splits` on a
tall, narrow f32 head); and which entries its split route launches
(tests/test_torch_qat_dxdw_tc.py has the rest of the split route).

On the CPU no kernel runs, so this pins what surrounds them: the scratch
shapes, the route rule, `dw_splits` and the entry each route launches with
its arguments (through a fake library on meta tensors), the plain prologue
against the quantizers, and the CPU route of quant_matmul_bwd against the
JAX package's Pallas kernel with the bars of
tests/test_torch_qat_kernels_ref.py. The kernels themselves are held
against the plain versions on the card by chip_smoke.py (phase 5).
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.kernels import quant_matmul as jqmm  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from test_torch_qat_kernels_ref import (QS, _assert_bf16_close, _inputs,  # noqa: E402
                                        _jax_kernel)

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


ROUTES = [((4096, 1024, 2816), True, "tc"), ((4096, 1024, 2816), False, "tc"),
          ((4096, 1000, 2817), True, "tc"), ((257, 129, 65), True, "tc"),
          ((4096, 1024, 152064), True, "split"), ((4096, 1024, 152064), False, "split"),
          ((37, 130, 90), False, "tc"), ((64 * 197, 192, 1024), False, "tc")]


@pytest.mark.parametrize(
    "mkn,round_cot,want", ROUTES,
    ids=[f"{'x'.join(map(str, s))}-{'bf16' if c else 'f32'}cot" for s, c, _ in ROUTES])
def test_route_rule(mkn, round_cot, want):
    """Within the reference's combined scratch budget the combined backward
    on the tensor cores, bf16 and f32 cotangents alike (one plane or
    three); past it (vocab-wide N) the split grids."""
    assert qmm.bwd_route(*mkn) == want
    assert (want != "split") == qmm.bwd_uses_combined(*qmm.padded_dims(*mkn))
    assert qmm.plane_count(round_cot) == (1 if round_cot else 3)


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_shapes", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the QAT training cells' linears: qwen1.5-0.5b (C), granite-moe (D, per
# expert), musicgen-medium (H), paper-bert-base (I), as chip_smoke.py runs them
CELLS = [("qwen1.5-0.5b", "w4a4", 8 * 512), ("granite-moe-1b-a400m", "w3a3", 8 * 512),
         ("musicgen-medium", "w4a4", 8 * 512), ("paper-bert-base", "w2a2", 32 * 128)]


@pytest.mark.parametrize("arch,quant,tokens", CELLS, ids=[c[0] for c in CELLS])
def test_dw_splits_keep_one_range_at_the_training_shapes(arch, quant, tokens):
    """Every linear of cells C, D, H and I keeps one dW range: its bf16
    linears are on one plane, its f32 head is either past the combined
    budget or M <= N (qwen's, granite-moe's, BERT's) or fills a wave
    (musicgen-medium's (4096, 1536, 2048): 384 dX tiles alone)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    linears = _chip_smoke().qat_linears(get_config(arch), get_preset(quant), tokens)
    assert linears
    for name, _, m, k, n, f32_cot, _, _ in linears:
        assert qmm.dw_splits(m, k, n, 3 if f32_cot else 1) == (1, m), name
    assert qmm.dw_splits(8 * 512, 1536, 2048, 3) == (1, 8 * 512)


SPLIT_SHAPES = [(64 * 197, 192, 1024), (8 * 197, 192, 128), (257, 129, 65), (1000, 700, 300),
                (33, 8, 1), (4096, 1024, 2816), (37, 130, 90), (1280, 1024, 512),
                (1, 1, 1), (4096, 192, 256)]


@pytest.mark.parametrize("mkn", SPLIT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dw_splits_ranges(mkn):
    """One range on one plane at every shape; on three, ranges that are
    whole 32-row stages, cover M exactly, and are cut only where the
    grid is short of a wave and M > N, about N deep each."""
    m, k, n = mkn
    assert qmm.dw_splits(m, k, n, 1) == (1, m)
    splits, rows = qmm.dw_splits(m, k, n, 3)
    t = qmm.QAT_TILE
    short = -(-m // t) * -(-k // t) + -(-k // t) * -(-n // t) < qmm.QAT_BLOCKS
    assert (splits > 1) == (short and m > n)
    if splits == 1:
        assert rows == m
        return
    assert rows % qmm.QAT_STAGE == 0 and (splits - 1) * rows < m <= splits * rows
    assert n / 2 < rows < n + qmm.QAT_STAGE  # about a dX tile's depth


def test_dw_splits_at_deit_heads():
    """paper-deit-t's head (64 x 197 patches, K 192, N 1024): 214 blocks of
    one range, so 13 ranges of 992 rows, 198 + 16 x 13 = 406 blocks."""
    assert qmm.dw_splits(64 * 197, 192, 1024, 3) == (13, 992)
    assert qmm.dw_splits(64 * 197, 192, 1024, 1) == (1, 64 * 197)
    assert qmm.dw_splits(8 * 197, 192, 128, 3) == (13, 128)


def test_split_scratch_shapes_and_zeroed_tickets():
    """The split dW's scratch: f32 (*lead, S, K, N) sums, and one int32
    ticket a dW tile of every expert, zero (build.tickets' buffer, which
    the kernel leaves at zero)."""
    part_s, tickets = qmm._dw_split_scratch((), 8 * 197, 192, 128, 13, "cpu")
    assert tuple(part_s.shape) == (13, 192, 128) and part_s.dtype == torch.float32
    assert tickets.dtype == torch.int32 and tickets.numel() >= 2 and not tickets.any()
    part_s, tickets = qmm._dw_split_scratch((3,), 257, 129, 65, 3, "meta")
    assert tuple(part_s.shape) == (3, 3, 129, 65) and tickets.numel() >= 3 * 2
    assert qmm._dw_split_scratch((), 4096, 1024, 2816, 1, "meta") == (None, None)


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
        "qat_bwd_tc_launch", "qat_dx_tc_launch", "qat_dw_tc_launch",
        "qat_bwd_prologue_launch")})

    def operands(x, w, a_scale, a_offset, w_scale, dy=None):
        k_side = tuple(w_scale.shape) != (1, w.shape[1])
        return (x, w, a_scale, a_offset, w_scale.reshape(-1), k_side, dy)

    monkeypatch.setattr(qmm, "_qat_lib", lambda: lib)
    # meta tensors take the plain versions now (the dry run's route): send
    # them down the launch path, as CUDA tensors go, to reach the fake library
    monkeypatch.setattr(ref, "takes_plain", lambda t: t.device.type == "cpu")
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
              ((256, 1024, 2816), False, False, ["qat_bwd_tc_launch"]),
              ((64, 1024, 152064), False, True, ["qat_bwd_prologue_launch", "qat_dx_tc_launch",
                                                 "qat_dw_tc_launch"])]


@pytest.mark.parametrize("mkn,k_side,round_cot,entries", PATH_CASES,
                         ids=["tc", "tc-rows-odd", "tc-f32", "split-head"])
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
        assert args[-2] == qmm.plane_count(round_cot)  # every entry takes the planes there
        assert args[-9:-6] == (m, k, n)
    if entries == ["qat_bwd_tc_launch"]:
        lds, _ = qmm._bwd_tc_scratch(m, k, n)
        args = calls[0][1]
        assert (args[16], args[18], args[20]) == lds
        assert args[21:26] == (None, None, 1, m, 1)  # one dW range: no sums, no tickets; E 1
    assert qmm.quant_matmul_bwd.launches == before + (not split)


@pytest.mark.parametrize("mkn", [(64 * 197, 192, 1024), (8 * 197, 192, 128)],
                         ids=["deit-head", "deit-head-8"])
def test_f32_combined_call_passes_planes_and_split_scratch(fake_qat_lib, monkeypatch, mkn):
    """f32 cotangents on the combined route: one qat_bwd_tc_launch with
    planes 3, the planes' scratch (3, M, ld_y), and, where dw_splits cuts
    the dW contraction, the (S, K, N) sums, the tickets, S and the range's
    rows; and no other launch."""
    calls, _ = fake_qat_lib
    m, k, n = mkn
    seen = {}
    allocate, split_scratch = qmm._bwd_tc_scratch_tensors, qmm._dw_split_scratch

    def tensors(*a, **kw):
        seen["scratch"] = allocate(*a, **kw)
        return seen["scratch"]

    def sums(*a, **kw):
        seen["split"] = split_scratch(*a, **kw)
        return tuple(types.SimpleNamespace(data_ptr=lambda v=v: v) for v in (0x4000, 0x5000))

    monkeypatch.setattr(qmm, "_bwd_tc_scratch_tensors", tensors)
    monkeypatch.setattr(qmm, "_dw_split_scratch", sums)
    out = qmm.quant_matmul_bwd(*_meta_operands(m, k, n), round_cot=False, **QS)
    assert [tuple(t.shape) for t in out] == [(m, k), (), (), (k, n), (1, n)]
    assert [name for name, _ in calls] == ["qat_bwd_tc_launch"]
    args = calls[0][1]
    lds, _ = qmm._bwd_tc_scratch(m, k, n)
    splits, rows = qmm.dw_splits(m, k, n, 3)
    assert splits > 1 and args[-2] == 3
    assert [tuple(t.shape) for t in seen["scratch"]] == [(m, lds[0]), (k, lds[1]),
                                                         (3, m, lds[2])]
    assert args[21:26] == (0x4000, 0x5000, splits, rows, 1)
    part_s, tickets = seen["split"]
    assert tuple(part_s.shape) == (splits, k, n) and part_s.dtype == torch.float32
    assert tickets.dtype == torch.int32 and tickets.numel() >= -(-k // 128) * -(-n // 128)


def test_failed_f32_combined_launch_raises_without_fallback(fake_qat_lib):
    calls, status = fake_qat_lib
    status["rc"] = 2  # cudaErrorMemoryAllocation
    before = qmm.quant_matmul_bwd.launches
    with pytest.raises(RuntimeError, match="qat_bwd_tc_launch failed: cudaError 2"):
        qmm.quant_matmul_bwd(*_meta_operands(64 * 197, 192, 1024), round_cot=False, **QS)
    assert [name for name, _ in calls] == ["qat_bwd_tc_launch"]
    assert qmm.quant_matmul_bwd.launches == before


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


# the lm heads' 8-bit edge quantizer (the only layers with f32 cotangents)
HEAD_QS = dict(q_n_a=0, q_p_a=255, q_n_w=128, q_p_w=127)
CPU_ROUTE = [((37, 130, 90), False, True, QS), ((20, 129, 65), True, True, QS),
             ((37, 130, 90), False, False, QS), ((8 * 197, 192, 128), False, False, HEAD_QS)]


@pytest.mark.parametrize("mkn,k_side,round_cot,qs", CPU_ROUTE,
                         ids=["cols-bf16cot", "rows-bf16cot-odd", "cols-f32cot",
                              "cols-f32cot-tall-head"])
def test_cpu_route_matches_pallas(mkn, k_side, round_cot, qs):
    """The CPU route of quant_matmul_bwd (the plain version the combined
    kernel is held to, on one plane or three) against the reference's
    combined Pallas kernel. The tall, narrow f32 case is a DeiT-like head
    (8 x 197 patches, d_model 192; the head's 8-bit quantizer), on the
    combined route, whose dW contraction the card cuts in 13 ranges."""
    m, k, n = mkn
    assert qmm.bwd_route(m, k, n) == "tc"
    x, w, a_s, a_b, ws, dy = _inputs(m, k, n, k_side, seed=m + k + n + 7)
    kw = dict(round_cot=round_cot, **qs)
    want = _jax_kernel(jqmm.quant_matmul_bwd, dy, x, w, a_s, a_b, ws, k_side, **kw)
    targs = [torch.from_numpy(v) if isinstance(v, np.ndarray) else torch.tensor(v)
             for v in (dy, x, w, a_s, a_b, ws)]
    got = qmm.quant_matmul_bwd(*targs, **kw)
    u, q, xd = ref._act_codes(targs[1], targs[3], targs[4], qs["q_n_a"], qs["q_p_a"])
    uw, qw, wd = ref._weight_codes(targs[2], targs[5], qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(targs[0], round_cot)
    _assert_bf16_close(got[0].numpy(), np.asarray(want[0])[:m, :k],
                       (cot.abs() @ wd.abs().T).numpy(), n)
    _assert_bf16_close(got[3].numpy(), np.asarray(want[3])[:k, :n],
                       (xd.abs().T @ cot.abs()).numpy(), m)
    mf = ref._in_range(u, qs["q_n_a"], qs["q_p_a"])
    dxd = ref._bf16(cot @ wd.T)
    assert abs(float(got[1]) - float(want[1])) <= 1e-4 * float((dxd * (q - mf * u)).abs().sum())
    assert abs(float(got[2]) - float(want[2])) <= 1e-4 * float((dxd * (1 - mf)).abs().sum())
    mfw = ref._in_range(uw, qs["q_n_w"], qs["q_p_w"])
    l1 = (ref._bf16(xd.T @ cot) * (qw - mfw * uw)).abs().sum(dim=1 if k_side else 0,
                                                            keepdim=True)
    ws_want = np.asarray(want[4])[:k] if k_side else np.asarray(want[4])[:, :n]
    assert got[4].shape == ws_want.shape
    assert np.all(np.abs(got[4].numpy() - ws_want) <= 1e-4 * l1.numpy())


def test_old_simt_backward_is_gone():
    """The f32 SIMT backward and its tile left with this route: no name of
    theirs in the CUDA source or the wrapper."""
    cu = build.SOURCES["qat_matmul"].read_text()
    py = Path(qmm.__file__).read_text()
    for gone in ("qat_bwd_kernel", "qat_bwd_batched_kernel", "qat_bwd_launch",
                 "qat_bwd_batched_launch", "gemm_tile", "dx_tile", "dw_tile", "Smem"):
        assert not re.search(rf"\b{gone}\b", cu), gone
        assert not re.search(rf"\b{gone}\b", py), gone
    assert _c_param_count("qat_bwd_tc_launch") == 35
