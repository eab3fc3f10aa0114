"""The port's cost counter (`repro_torch.launch.cost`), twin of
tests/test_hlo_cost.py: exact FLOPs on known programs, bytes, collectives.

The reference parses compiled HLO and multiplies loop bodies by their trip
counts; the port counts aten ops as they run, so a Python loop is counted
once per iteration. Beyond the reference's five cases: a QAT linear's
forward and backward count the same on the CPU and on the meta device (each
kernel wrapper is one op with its own figures, whatever implements it),
the kernel figures are the bytes and operations `chip_smoke.py`'s bound
rows use, and the live-bytes peak of the dry run.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.core.quantizer import pack_int4  # noqa: E402
from repro_torch.dist import spmd  # noqa: E402
from repro_torch.kernels import bin_stats as bs  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import fake_quant as fq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.launch import cost  # noqa: E402
from repro_torch.launch.dryrun import fake_world, rows_all_live  # noqa: E402
from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS  # noqa: E402
from repro_torch.models import common as C  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401 (autouse)


def _count(fn, *args, track_live=False):
    with cost.CostMode(track_live=track_live) as cm:
        fn(*args)
    return cm.result()


# ---------------------------------------------------------------------------
# the reference's five cases
# ---------------------------------------------------------------------------

def test_single_matmul_flops():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    res = _count(lambda x, y: x @ y, a, b)
    assert res["flops"] == 2 * 64 * 128 * 32


def test_loop_multiplies_trip_count():
    w, x = torch.zeros(10, 32, 32), torch.zeros(4, 32)

    def fn(ws, x0):
        for i in range(ws.shape[0]):
            x0 = torch.matmul(x0, ws[i])
        return x0

    res = _count(fn, w, x)
    assert res["flops"] == 10 * 2 * 4 * 32 * 32


def test_nested_loop():
    w, x = torch.zeros(3, 32, 32), torch.zeros(4, 32)

    def fn(ws, x0):
        for _ in range(5):
            for i in range(ws.shape[0]):
                x0 = torch.matmul(x0, ws[i])
        return x0

    res = _count(fn, w, x)
    assert res["flops"] == 5 * 3 * 2 * 4 * 32 * 32


def test_bytes_nonzero_and_collectives_absent():
    a = torch.zeros(256, 256)
    res = _count(lambda x: x * 2.0 + 1.0, a)
    assert res["bytes"] >= 2 * 256 * 256 * 4  # read + write at least
    assert res["collective_count"] == 0 and res["collective_bytes"] == 0


def test_collective_records_output_bytes():
    with fake_world(2):
        group = dist.new_group([0, 1])
        res = _count(lambda t: spmd.all_reduce(t, group), torch.zeros(128, 64))
        assert res["collective_bytes_by_op"]["all-reduce"] == 128 * 64 * 4
        assert res["collective_count_by_op"]["all-reduce"] == 1
        res = _count(lambda t: spmd.all_gather(t, group, 0), torch.zeros(8, 64))
        assert res["collective_bytes_by_op"] == {"all-gather": 2 * 8 * 64 * 4}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def _qat_linear_cost(device):
    """Forward and backward of one fused QAT linear (w4a4, N-side columns)
    under the counter, on `device`."""
    q = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    gen = torch.Generator().manual_seed(0)
    p = C.linear_init(gen, "w_in", q, (48, 40), std=0.1)
    pp = {k: v.to(device).requires_grad_() for k, v in p.items()}
    x = torch.randn(2, 7, 48, generator=gen).to(device=device, dtype=torch.bfloat16)
    x.requires_grad_()
    ops.reset_launch_counts()
    with cost.CostMode(track_live=True) as cm:
        y = C.qlinear(pp, x, "w_in", q, "bsd,df->bsf")
        torch.autograd.grad(y.float().sum(), [x] + list(pp.values()))
    assert sum(ops.launch_counts().values()) == 0  # no kernel launches off the card
    return cm.result()


def test_qat_linear_counts_the_same_on_cpu_and_meta():
    cpu, meta = _qat_linear_cost("cpu"), _qat_linear_cost("meta")
    assert cpu == meta
    assert set(cpu["kernels"]) == {"quant_matmul", "quant_matmul_bwd"}
    m, k, n = 14, 48, 40
    assert cpu["kernels"]["quant_matmul"]["flops"] == 2 * m * k * n
    assert cpu["kernels"]["quant_matmul_bwd"]["flops"] == 4 * m * k * n
    assert cpu["peak_live_bytes"] > 0


def _chip_smoke_figures():
    """(name, call, bytes, ops, ops_per_s) at chip_smoke.py's row shapes, the
    bytes and operations written as its bound rows write them."""
    meta = dict(device="meta")
    bf16, i8 = torch.bfloat16, torch.int8
    rows = []
    m, k, n = 4, 4096, 14336
    x = torch.empty(m, k, dtype=bf16, **meta)
    codes = torch.empty(k // 2, n, dtype=i8, **meta)
    scale = torch.empty(n, **meta)
    rows.append(("int4_matmul", lambda: qmm.int4_matmul(x, codes, scale),
                 m * k * 2 + codes.numel() + n * 4 + m * n * 4, 2.0 * m * k * n, PEAK_FLOPS))
    codes8 = torch.empty(k, n, dtype=i8, **meta)
    rows.append(("int_matmul", lambda: qmm.int_matmul(x, codes8, scale),
                 m * k * 2 + codes8.numel() + n * 4 + m * n * 4, 2.0 * m * k * n, PEAK_FLOPS))
    b, c, h, hkv, t, d = 4, 1, 32, 8, 160, 128
    q = torch.empty(b, c, h, d, dtype=bf16, **meta)
    kv = torch.empty(b, t, hkv, d, dtype=i8, **meta)
    sc = torch.empty(b, t, hkv, 1, **meta)
    pos = torch.empty(b, t, dtype=torch.int32, **meta)
    qpos = torch.empty(b, c, dtype=torch.int32, **meta)
    nbytes = (q.numel() * 2 + 2 * kv.numel() + 2 * sc.numel() * 4 + pos.numel() * 4
              + qpos.numel() * 4 + b * c * h * d * 4 + 2 * b * c * h * 4)
    rows.append(("pooled_decode_attention",
                 lambda: da.pooled_decode_attention(q, kv, kv, sc, sc, pos, qpos, q_per_kv=4,
                                                    window=0, softcap=0.0),
                 nbytes, 4.0 * b * c * h * t * d, PEAK_FLOPS))
    m, k, n = 4096, 1024, 2816
    qs = dict(q_n_a=8, q_p_a=7, q_n_w=8, q_p_w=7)
    xq = torch.empty(m, k, dtype=bf16, **meta)
    w = torch.empty(k, n, **meta)
    a0 = torch.empty((), **meta)
    ws = torch.empty(1, n, **meta)
    dy = torch.empty(m, n, **meta)
    rows.append(("quant_matmul", lambda: qmm.quant_matmul(xq, w, a0, a0, ws, **qs),
                 m * k * 2 + k * n * 4 + n * 4 + 8 + m * n * 4, 2.0 * m * k * n, PEAK_FLOPS))
    ins = m * n * 4 + m * k * 2 + k * n * 4 + n * 4 + 8
    for name, fn, outs, products in (
            ("quant_matmul_bwd", qmm.quant_matmul_bwd, m * k * 4 + 8 + k * n * 4 + n * 4, 2),
            ("quant_matmul_dx", qmm.quant_matmul_dx, m * k * 4 + 8, 1),
            ("quant_matmul_dw", qmm.quant_matmul_dw, k * n * 4 + n * 4, 1)):
        for round_cot, planes in ((True, 1), (False, 3)):
            rows.append((name, lambda fn=fn, rc=round_cot: fn(dy, xq, w, a0, a0, ws, **qs,
                                                               round_cot=rc),
                         ins + outs, 2.0 * m * k * n * products * planes, PEAK_FLOPS))
    e, m, k, n = 32, 1280, 1024, 512
    xe = torch.empty(e, m, k, dtype=bf16, **meta)
    we = torch.empty(e, k, n, **meta)
    ae = torch.empty(e, 1, **meta)
    wse = torch.empty(e, n, **meta)
    dye = torch.empty(e, m, n, **meta)
    rows.append(("quant_matmul_batched",
                 lambda: qmm.quant_matmul_batched(xe, we, ae, ae, wse, **qs),
                 e * (m * k * 2 + k * n * 4 + 8 + n * 4 + m * n * 4), 2.0 * e * m * k * n,
                 PEAK_FLOPS))
    rows.append(("quant_matmul_bwd_batched",
                 lambda: qmm.quant_matmul_bwd_batched(dye, xe, we, ae, ae, wse, **qs),
                 e * (m * n * 4 + m * k * 2 + k * n * 4 + 8 + n * 4 + m * k * 4 + 8 + k * n * 4
                      + n * 4), 4.0 * e * m * k * n, PEAK_FLOPS))
    xf = torch.empty(4096, 1024, **meta)
    s0 = torch.empty((), **meta)
    rows.append(("fake_quant_2d", lambda: fq.fake_quant_2d(xf, s0, s0, q_n=8, q_p=7),
                 2 * xf.numel() * 4 + 4 + 4, 5.0 * xf.numel(), F32_FLOPS))
    rs = torch.empty(4096, 1, **meta)
    rows.append(("fake_quant_rows", lambda: fq.fake_quant_rows(xf, rs, q_n=8, q_p=7),
                 2 * xf.numel() * 4 + 4 * 4096, 5.0 * xf.numel(), F32_FLOPS))
    rows.append(("bin_stats_2d", lambda: bs.bin_stats_2d(xf, s0, q_n=8, q_p=7),
                 xf.numel() * 4 + 4 + 3 * 16 * 4, 8.0 * xf.numel(), F32_FLOPS))
    return rows


@pytest.mark.parametrize("row", range(len(_chip_smoke_figures())))
def test_kernel_figures_are_chip_smokes_bound_rows(row):
    name, call, nbytes, ops_, rate = _chip_smoke_figures()[row]
    with rows_all_live():  # bin_stats' plain version masks through nonzero
        rec = _count(call)["kernels"][name]
    assert rec["calls"] == 1
    assert rec["bytes"] == nbytes
    assert rec["ops"] == ops_
    assert rec["bound_s"] == max(nbytes / HBM_BW, ops_ / rate)


def test_kernel_insides_are_not_counted_and_wrappers_nest_once():
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    a, ws = torch.tensor(0.1), torch.ones(1, 4)
    res = _count(lambda: qmm.quant_matmul(x, w, a, a, ws, q_n_a=8, q_p_a=7, q_n_w=8,
                                          q_p_w=7))
    assert list(res["by_op"]) == ["kernel::quant_matmul"]
    assert res["flops"] == 2 * 8 * 16 * 4
    # without a counter the wrapper is the plain call
    y = qmm.quant_matmul(x, w, a, a, ws, q_n_a=8, q_p_a=7, q_n_w=8, q_p_w=7)
    assert y.shape == (8, 4)


def test_meta_route_gives_shapes_and_launches_nothing():
    ops.reset_launch_counts()
    q = torch.empty(2, 1, 8, 16, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 130, 2, 16, device="meta")
    pos = torch.empty(2, 130, dtype=torch.int32, device="meta")
    acc, m, l = da.pooled_decode_attention(q, kv, kv, None, None, pos, pos[:, :1],
                                           q_per_kv=4, window=0, softcap=0.0)
    assert acc.shape == (2, 1, 8, 16) and m.shape == l.shape == (2, 1, 8)
    assert acc.dtype == torch.float32 and acc.is_meta
    parts = da.pooled_decode_attention(q, kv, kv, None, None, pos, pos[:, :1], q_per_kv=4,
                                       window=0, softcap=0.0, parts=True)
    assert parts[0].shape == (3, 2, 1, 8, 16)
    y = qmm.int4_matmul(torch.empty(3, 64, device="meta"),
                        pack_int4(torch.zeros(64, 8, dtype=torch.int8), 0).to("meta"),
                        torch.empty(8, device="meta"))
    assert y.shape == (3, 8) and y.dtype == torch.float32
    assert sum(ops.launch_counts().values()) == 0


def test_live_bytes_peak():
    t = torch.zeros(1024)  # an argument: not counted

    def fn(x):
        a = x * 2.0          # 4 KiB live
        b = a + 1.0          # 8 KiB live
        del a                # 4 KiB
        v = b.view(32, 32)   # a view holds b's storage
        del b
        c = v * 3.0          # 8 KiB live (v still holds b's)
        return c

    res = _count(fn, t, track_live=True)
    assert res["peak_live_bytes"] == 2 * 4096


def test_byte_counter_counts_kernel_insides():
    x, w = torch.randn(8, 16), torch.randn(16, 4)
    a, ws = torch.tensor(0.1), torch.ones(1, 4)
    n = cost.counted_bytes(lambda: qmm.quant_matmul(x, w, a, a, ws, q_n_a=8, q_p_a=7,
                                                    q_n_w=8, q_p_w=7))
    whole = cost.boundary_bytes((x, w, a, a, ws), torch.empty(8, 4))
    assert n > whole  # the plain version's ops, each counted
    assert np.isfinite(n)
