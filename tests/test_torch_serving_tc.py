"""The serving kernels' tensor-core designs, as far as the CPU can see them.

`int4_matmul` and `int_matmul` (csrc/quant_matmul.cu) cut the contraction
into splits by `quant_matmul.int4_plan` and dequantize nibbles or int8 bytes
by a byte permute into the mantissa of 2^23; `pooled_decode_attention` (csrc/decode_attention.cu) splits
the key walk into splits of `KV_SPLIT` keys and merges them in split order.
No kernel runs here, so this pins what surrounds them: that the plans ignore
M, B and the live slots; that the merge rule, applied to the plain version
split by split, is the one-pass plain version; that the kernel's
dequantization is bit-equal to the plain rule; and that each wrapper hands its
entry the planned grid and scratch (through a fake library on meta tensors)
and raises on a failed launch. chip_smoke.py (phase 2) holds the kernels to
their plain versions on the card.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.quantizer import QuantSpec, pack_int4  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import quant_matmul as qmm  # noqa: E402
from repro_torch.models.attention import _quantize_kv  # noqa: E402

NEG_INF = ref.NEG_INF

# granite-8b's serving linears (w_gate / w_in, w_out, wq, wk / wv), the tied
# head's width, and small or ragged shapes
INT4_SHAPES = [(4096, 14336), (14336, 4096), (4096, 4096), (4096, 1024), (4096, 49152),
               (64, 96), (2, 1), (1000, 300), (130, 2050)]


@pytest.mark.parametrize("kn", INT4_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_int4_plan_covers_the_contraction_in_one_wave(kn):
    k, n = kn
    plan = qmm.int4_plan(k, n)
    per, splits = plan["ksteps_per_split"], plan["splits"]
    assert plan["col_tiles"] == math.ceil(n / qmm.INT4_COLS)
    assert plan["ksteps"] == max(1, math.ceil(k / qmm.INT4_STEP))
    assert (splits - 1) * per < plan["ksteps"] <= splits * per  # no empty split
    assert splits == 1 or plan["col_tiles"] * splits <= qmm.INT4_BLOCKS
    assert splits == 1 or per >= qmm.INT4_WARPS  # a step for every warp
    if kn == (4096, 14336):  # w_gate / w_in: 112 column tiles, two splits
        assert (plan["col_tiles"], splits, per) == (112, 2, 128)
    if kn == (4096, 1024):  # wk / wv: 8 column tiles, 32 splits of 8 steps
        assert (plan["col_tiles"], splits, per) == (8, 32, 8)


@pytest.fixture
def fake_serving_lib(monkeypatch):
    """Fake quant_matmul / decode_attention libraries that record each
    launch, and operand checks that let meta tensors (no data, not on the
    CPU) through to the launch."""
    calls = []
    status = {"rc": 0}

    def entry(name):
        def launch(*args):
            calls.append((name, args))
            return status["rc"]
        return launch

    lib = types.SimpleNamespace(
        int4_matmul_launch=entry("int4_matmul_launch"),
        int_matmul_launch=entry("int_matmul_launch"),
        decode_attention_launch=entry("decode_attention_launch"),
        decode_attention_smem_bytes=lambda rows, d, q_bf16: 0)
    monkeypatch.setattr(qmm, "_lib", lambda: lib)
    monkeypatch.setattr(da, "_lib", lambda: lib)
    # meta tensors take the plain versions now (the dry run's route): send
    # them down the launch path, as CUDA tensors go, to reach the fake library
    monkeypatch.setattr(ref, "takes_plain", lambda t: t.device.type == "cpu")
    monkeypatch.setattr(qmm, "_check", lambda *a: None)
    monkeypatch.setattr(da, "_require_cuda", lambda device: None)
    monkeypatch.setattr(build, "_TICKETS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return calls, status


def _int4_launch(calls, m, k, n):
    meta = dict(device="meta")
    out = qmm.int4_matmul(torch.empty((m, k), dtype=torch.bfloat16, **meta),
                          torch.empty((k // 2, n), dtype=torch.int8, **meta),
                          torch.empty((n,), **meta))
    assert tuple(out.shape) == (m, n) and out.dtype == torch.float32
    name, args = calls[-1]
    assert name == "int4_matmul_launch"
    # x codes scale out part tickets | M K N splits ksteps_per_split vec | stream
    return dict(zip(("M", "K", "N", "splits", "per", "vec"), args[6:12]),
                part=args[4], tickets=args[5])


@pytest.mark.parametrize("kn", [(4096, 14336), (14336, 4096), (4096, 1024), (64, 96)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int4_wrapper_passes_the_plan_whatever_m(fake_serving_lib, kn):
    """The grid's contraction split is the (K, N) plan at every M: decode,
    a ragged batch, prefill chunks of 32 and 4 x 32 rows."""
    calls, _ = fake_serving_lib
    k, n = kn
    plan = qmm.int4_plan(k, n)
    before = qmm.int4_matmul.launches
    for m in (1, 4, 8, 9, 32, 128):
        got = _int4_launch(calls, m, k, n)
        assert (got["M"], got["K"], got["N"]) == (m, k, n)
        assert (got["splits"], got["per"]) == (plan["splits"], plan["ksteps_per_split"])
        # scratch only where there are splits to merge (meta pointers are 0,
        # so the fake sees 0 for a tensor and None for none)
        assert (got["part"] is None) == (plan["splits"] == 1)
        assert (got["tickets"] is None) == (plan["splits"] == 1)
    assert qmm.int4_matmul.launches == before + 6
    if plan["splits"] > 1:  # enough tickets for every (column tile, token tile)
        buf = build._TICKETS[("int4_matmul", "meta")]
        assert buf.numel() >= plan["col_tiles"] * qmm.int4_token_tiles(128)[1]


@pytest.mark.parametrize("m,tiles", [(1, (8, 1)), (8, (8, 1)), (9, (32, 1)),
                                     (32, (32, 1)), (128, (32, 4)), (129, (32, 5))])
def test_int4_token_tiles(m, tiles):
    assert qmm.int4_token_tiles(m) == tiles


def test_failed_int4_launch_raises_without_fallback(fake_serving_lib):
    calls, status = fake_serving_lib
    status["rc"] = 2  # cudaErrorMemoryAllocation
    with pytest.raises(RuntimeError, match="int4_matmul_launch failed: cudaError 2"):
        _int4_launch(calls, 4, 4096, 14336)
    assert [name for name, _ in calls] == ["int4_matmul_launch"]


def _kernel_dequant(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(K/2, N) packed codes -> (K, N) bf16 as csrc/quant_matmul.cu computes
    them: each nibble biased by 8 (x ^ 8) goes into the low byte of 0x4B000000
    (2^23 + code + 8 as an f32), 2^23 + 8 is subtracted, the f32 is multiplied
    by max(s, 1e-9) and rounded to bf16."""
    b = packed.to(torch.int32) & 0xFF
    biased = torch.stack([(b & 0xF) ^ 8, (b >> 4) ^ 8], dim=1).reshape(-1, b.shape[1])
    code = (biased | 0x4B000000).view(torch.float32) - torch.tensor(8388616.0)
    s = torch.maximum(scale.to(torch.float32), torch.tensor(1e-9, dtype=torch.float32))
    return (code * s).to(torch.bfloat16)


def test_kernel_dequantization_is_the_plain_rule_bit_for_bit():
    """Every code (-8..7) against scales below the 1e-9 floor, subnormal,
    zero, ordinary and large (the products overflow to inf alike): the byte
    permute trick is exact and the one f32 product rounds as the rule's."""
    rng = np.random.default_rng(0)
    scales = np.concatenate([
        np.array([0.0, 1e-12, 1e-40, 1.4e-45, 1e-9, 1.0000001e-9, 3.7e-3, 1.0, 0.1,
                  1e30, 3.0e38], np.float32),
        rng.random(53).astype(np.float32) * np.float32(0.05)])
    n = scales.size
    codes = np.tile(np.arange(-8, 8, dtype=np.int8)[:, None], (1, n))  # (16, N)
    packed = pack_int4(torch.from_numpy(codes), 0)
    scale = torch.from_numpy(scales)
    got = _kernel_dequant(packed, scale)
    want = (torch.from_numpy(codes).to(torch.float32)
            * torch.clamp(scale, min=ref.EPS)).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # and ref.int4_matmul's own weights: x = identity rows read them out
    # (on the columns without an infinite weight, which 0 x inf would spoil)
    finite = torch.isfinite(got.to(torch.float32)).all(0)
    assert int(finite.sum()) == n - 1  # only 3e38 overflows
    eye = torch.eye(16, dtype=torch.bfloat16)
    plain = ref.int4_matmul(eye, packed[:, finite], scale[finite])
    assert torch.equal(plain.view(torch.int32),
                       got[:, finite].to(torch.float32).view(torch.int32))


def _int8_launch(calls, m, k, n):
    meta = dict(device="meta")
    out = qmm.int_matmul(torch.empty((m, k), dtype=torch.bfloat16, **meta),
                         torch.empty((k, n), dtype=torch.int8, **meta),
                         torch.empty((n,), **meta))
    assert tuple(out.shape) == (m, n) and out.dtype == torch.float32
    name, args = calls[-1]
    assert name == "int_matmul_launch"
    # x codes scale out part tickets | M K N ldx splits ksteps_per_split vec | stream
    return dict(zip(("M", "K", "N", "ldx", "splits", "per", "vec"), args[6:13]),
                part=args[4], tickets=args[5])


@pytest.mark.parametrize("kn", [(4096, 49152), (4096, 14336), (14336, 4096), (4096, 4096),
                                (4096, 1024), (64, 96), (129, 65)],
                         ids=lambda s: "x".join(map(str, s)))
def test_int8_wrapper_passes_the_plan_whatever_m(fake_serving_lib, kn):
    """int_matmul takes int4_matmul's (K, N) plan at every M (decode, a
    ragged batch, prefill chunks of 32 and 4 x 32 rows), whatever its block
    width; an odd K reaches the kernel as x rows padded to an even length."""
    calls, _ = fake_serving_lib
    k, n = kn
    plan = qmm.int4_plan(k, n)
    before = qmm.int_matmul.launches
    for m in (1, 4, 8, 9, 32, 128):
        got = _int8_launch(calls, m, k, n)
        assert (got["M"], got["K"], got["N"], got["ldx"]) == (m, k, n, k + k % 2)
        assert (got["splits"], got["per"]) == (plan["splits"], plan["ksteps_per_split"])
        assert (got["part"] is None) == (plan["splits"] == 1)
        assert (got["tickets"] is None) == (plan["splits"] == 1)
        assert got["vec"] == int(n % 16 == 0)
    assert qmm.int_matmul.launches == before + 6
    if plan["splits"] > 1:  # its own tickets, one a (column tile, token tile)
        buf = build._TICKETS[("int_matmul", "meta")]
        assert buf.numel() >= qmm.int8_col_tiles(128, n) * qmm.int4_token_tiles(128)[1]
        assert ("int4_matmul", "meta") not in build._TICKETS


@pytest.mark.parametrize("m,cols", [(1, 128), (4, 128), (8, 128), (9, 64), (32, 64),
                                    (128, 64)])
def test_int8_col_tiles(m, cols):
    for n in (1, 64, 65, 128, 129, 49152):
        assert qmm.int8_col_tiles(m, n) == math.ceil(n / cols)
    assert qmm.INT8_COLS[int(m > 8)] == cols


def test_failed_int8_launch_raises_without_fallback(fake_serving_lib):
    calls, status = fake_serving_lib
    status["rc"] = 2  # cudaErrorMemoryAllocation
    before = qmm.int_matmul.launches
    with pytest.raises(RuntimeError, match="int_matmul_launch failed: cudaError 2"):
        _int8_launch(calls, 4, 4096, 49152)
    assert [name for name, _ in calls] == ["int_matmul_launch"]
    assert qmm.int_matmul.launches == before


def _kernel_dequant8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 codes -> (K, N) bf16 as csrc/quant_matmul.cu's int8 kernel
    computes them: each byte biased by x ^ 0x80 (code + 128) goes into the
    low byte of 0x4B000000 (2^23 + code + 128 as an f32), 2^23 + 128 is
    subtracted, the f32 is multiplied by max(s, 1e-9) and rounded to bf16."""
    biased = (codes.to(torch.int32) & 0xFF) ^ 0x80
    code = (biased | 0x4B000000).view(torch.float32) - torch.tensor(8388736.0)
    s = torch.maximum(scale.to(torch.float32), torch.tensor(1e-9, dtype=torch.float32))
    return (code * s).to(torch.bfloat16)


def test_int8_kernel_dequantization_is_the_plain_rule_bit_for_bit():
    """All 256 codes against the scales of the int4 test (below the 1e-9
    floor, subnormal, zero, ordinary, and large enough to overflow): the
    biased byte permute gives each code exactly, and the one f32 product
    rounds as ref.int_matmul's rule."""
    rng = np.random.default_rng(1)
    scales = np.concatenate([
        np.array([0.0, 1e-12, 1e-40, 1.4e-45, 1e-9, 1.0000001e-9, 3.7e-3, 1.0, 0.1,
                  1e30, 3.0e38], np.float32),
        rng.random(53).astype(np.float32) * np.float32(0.05)])
    n = scales.size
    codes = torch.from_numpy(np.tile(np.arange(-128, 128, dtype=np.int8)[:, None], (1, n)))
    scale = torch.from_numpy(scales)
    got = _kernel_dequant8(codes, scale)
    want = (codes.to(torch.float32) * torch.clamp(scale, min=ref.EPS)).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # ref.int_matmul's own weights, read out by identity rows (on the
    # columns without an infinite weight: only 3e38 overflows)
    finite = torch.isfinite(got.to(torch.float32)).all(0)
    assert int(finite.sum()) == n - 1
    eye = torch.eye(256, dtype=torch.bfloat16)
    plain = ref.int_matmul(eye, codes[:, finite], scale[finite])
    assert torch.equal(plain.view(torch.int32),
                       got[:, finite].to(torch.float32).view(torch.int32))


def _attention_inputs(rng, *, storage, b=3, t=150, hkv=2, q_per_kv=2, c=1, d=32):
    q = torch.from_numpy(rng.standard_normal((b, c, hkv * q_per_kv, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, t, hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, t, hkv, d)).astype(np.float32))
    pos = torch.full((b, t), -1, dtype=torch.int32)
    pos[0, :100] = torch.arange(100)      # slot 0: 100 tokens, then idle rows
    pos[1, :] = torch.arange(t) + 7       # slot 1: full
    # slot 2 idle (fully masked rows)
    q_pos = torch.stack([torch.arange(99 - c + 1, 100), torch.arange(t + 7 - c, t + 7),
                         torch.full((c,), -1)]).to(torch.int32)
    if storage == "fp":
        ks = vs = None
    else:
        spec = QuantSpec(bits=8 if storage == "int8" else 4)
        (k, ks), (v, vs) = _quantize_kv(k, spec), _quantize_kv(v, spec)
        if storage == "int4":
            k, v = pack_int4(k, -1), pack_int4(v, -1)
    return q, k, v, ks, vs, pos, q_pos


def _split_merge(q, k, v, ks, vs, pos, q_pos, **kw):
    """The plain version over each split of KV_SPLIT keys, merged as the
    kernel merges them: m the max over splits, wholly masked splits (m =
    NEG_INF) skipped, the others added in split order scaled by
    exp(m_s - m) (one f32 product and one f32 sum each); a fully masked row
    keeps split 0's triple."""
    t = k.shape[1]
    parts = []
    for t0 in range(0, t, da.KV_SPLIT):
        sl = slice(t0, min(t, t0 + da.KV_SPLIT))
        cut = lambda x: None if x is None else x[:, sl]
        parts.append(ref.pooled_decode_attention(q, cut(k), cut(v), cut(ks), cut(vs),
                                                 pos[:, sl], q_pos, **kw))
    mx = torch.stack([p[1] for p in parts]).amax(0)
    acc = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for acc_s, m_s, l_s in parts:
        e = torch.where(m_s == NEG_INF, 0.0, torch.exp(m_s - mx))
        live = m_s != NEG_INF
        acc = torch.where(live[..., None], acc + acc_s * e[..., None], acc)
        l = torch.where(live, l + l_s * e, l)
    dead = mx == NEG_INF
    acc = torch.where(dead[..., None], parts[0][0], acc)
    l = torch.where(dead, parts[0][2], l)
    return acc, mx, l


@pytest.mark.parametrize("storage", ["fp", "int8", "int4"])
@pytest.mark.parametrize("c,window,softcap", [(1, 0, 0.0), (5, 0, 0.0), (1, 40, 30.0),
                                              (5, 70, 30.0)])
def test_split_merge_is_the_one_pass_attention(storage, c, window, softcap):
    """f32 queries (the compute dtype): the merged splits and the one-pass
    plain version differ only by f32 rounding, within 1e-6 x max|o|; m
    agrees; fully masked rows keep m = NEG_INF, l > 0, finite acc."""
    rng = np.random.default_rng(11 + c + window)
    args = _attention_inputs(rng, storage=storage, c=c)
    kw = dict(q_per_kv=2, window=window, softcap=softcap)
    acc, m, l = _split_merge(*args, **kw)
    acc1, m1, l1 = ref.pooled_decode_attention(*args, **kw)
    live = m1 > NEG_INF / 2
    o, o1 = acc[live] / l[live][:, None], acc1[live] / l1[live][:, None]
    assert float((o - o1).abs().max()) <= 1e-6 * float(o1.abs().max())
    assert torch.allclose(m[live], m1[live], rtol=0, atol=1e-6)
    assert bool((m[~live] == NEG_INF).all()) and bool((l[~live] > 0).all())
    assert bool(torch.isfinite(acc).all())
    assert int((~live).sum()) >= 2 * c  # slot 2's rows, at least


@pytest.mark.parametrize("storage", ["fp", "int8", "int4"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wholly_masked_split_changes_no_bit(storage, q_dtype):
    """Whole splits of idle rows appended to the pool (T 128 -> 256) leave
    every (acc, m, l) bit as it was: such a split's m is NEG_INF, and the
    merge skips it. (That idle rows inside a split change no bit is a
    property of the kernel's fixed 64-key sums, held on the card by
    chip_smoke.py; the plain version's sums follow the slice's length.)"""
    rng = np.random.default_rng(5)
    q, k, v, ks, vs, pos, q_pos = _attention_inputs(rng, storage=storage, c=3, t=128)
    q = q.to(q_dtype)
    if storage == "fp":
        k, v = k.to(q_dtype), v.to(q_dtype)
    grow = 256 - k.shape[1]
    pad = lambda x: None if x is None else torch.cat(
        [x, x[:, :grow].flip(0)], dim=1)  # idle rows hold other slots' data
    pos_big = torch.cat([pos, torch.full((pos.shape[0], grow), -1, dtype=torch.int32)], 1)
    kw = dict(q_per_kv=2, window=0, softcap=0.0)
    small = _split_merge(q, k, v, ks, vs, pos, q_pos, **kw)
    big = _split_merge(q, pad(k), pad(v), pad(ks), pad(vs), pos_big, q_pos, **kw)
    for a, b in zip(small, big):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("t,splits", [(1, 1), (64, 1), (65, 2), (160, 3), (256, 4), (4096, 64)])
def test_decode_plan_splits_depend_on_t_alone(t, splits):
    for g in (1, 4, 16, 128, 130):
        for q_bf16 in (True, False):
            plan = da.decode_plan(t, g, q_bf16)
            assert plan["splits"] == splits
            assert plan["rows"] * plan["row_tiles"] >= g > plan["rows"] * (plan["row_tiles"] - 1)
            if q_bf16:
                assert plan["rows"] % 16 == 0 and plan["rows"] <= 64


def _attention_launch(calls, *, b, live, t, c=1, hkv=8, q_per_kv=4, d=128,
                      storage="int8", q_dtype=torch.bfloat16):
    meta = dict(device="meta")
    q = torch.empty((b, c, hkv * q_per_kv, d), dtype=q_dtype, **meta)
    ds = d // 2 if storage == "int4" else d
    st = torch.int8 if storage != "fp" else q_dtype
    k = torch.empty((b, t, hkv, ds), dtype=st, **meta)
    sc = None if storage == "fp" else torch.empty((b, t, hkv, 1), **meta)
    pos = torch.full((b, t), -1, dtype=torch.int32, **meta)
    q_pos = torch.full((b, c), -1, dtype=torch.int32, **meta)
    del live  # the pool's live slots sit in pos / q_pos, which the plan never reads
    acc, m, l = da.pooled_decode_attention(q, k, k, sc, sc, pos, q_pos, q_per_kv=q_per_kv,
                                           window=0, softcap=0.0)
    h = hkv * q_per_kv
    assert tuple(acc.shape) == (b, c, h, d) and tuple(m.shape) == tuple(l.shape) == (b, c, h)
    name, args = calls[-1]
    assert name == "decode_attention_launch"
    # ... | B T C Hkv qpk D GT kind q_bf16 window | qscale softcap stream
    got = dict(zip(("B", "T", "C", "Hkv", "qpk", "D", "GT", "kind", "q_bf16"), args[13:22]),
               part_acc=args[10], part_ml=args[11], tickets=args[12], qscale=args[23])
    assert got["qscale"] == d ** -0.5
    return got


@pytest.mark.parametrize("t", [160, 64, 4096])
@pytest.mark.parametrize("c", [1, 32])
def test_attention_wrapper_passes_the_plan_whatever_b(fake_serving_lib, t, c):
    """Slots 1 or 4, none to all live: the same row tile and key splits."""
    calls, _ = fake_serving_lib
    plan = da.decode_plan(t, c * 4, True)
    seen = set()
    for b, live in ((1, 0), (1, 1), (4, 0), (4, 1), (4, 4)):
        got = _attention_launch(calls, b=b, live=live, t=t, c=c)
        assert (got["B"], got["T"], got["C"], got["qpk"], got["GT"]) == (b, t, c, 4,
                                                                         plan["rows"])
        assert (got["part_acc"] is None) == (plan["splits"] == 1)
        assert (got["tickets"] is None) == (plan["splits"] == 1)
        seen.add((got["T"], got["GT"], got["kind"], got["q_bf16"]))
    assert len(seen) == 1
    if plan["splits"] > 1:
        assert build._TICKETS[("decode_attention", "meta")].numel() >= 4 * 8 * plan["row_tiles"]


@pytest.mark.parametrize("storage,q_dtype,kind", [
    ("fp", torch.bfloat16, 0), ("fp", torch.float32, 1), ("int8", torch.bfloat16, 2),
    ("int4", torch.bfloat16, 3), ("int4", torch.float32, 3)])
def test_attention_wrapper_kv_kind_and_compute_dtype(fake_serving_lib, storage, q_dtype, kind):
    calls, _ = fake_serving_lib
    got = _attention_launch(calls, b=4, live=4, t=160, storage=storage, q_dtype=q_dtype)
    assert (got["kind"], got["q_bf16"]) == (kind, int(q_dtype == torch.bfloat16))
    assert got["GT"] == da.decode_plan(160, 4, q_dtype == torch.bfloat16)["rows"]


def test_failed_attention_launch_raises_without_fallback(fake_serving_lib):
    calls, status = fake_serving_lib
    status["rc"] = 1  # cudaErrorInvalidValue
    before = da.pooled_decode_attention.launches
    with pytest.raises(RuntimeError, match="decode_attention_launch failed: cudaError 1"):
        _attention_launch(calls, b=4, live=4, t=160)
    assert [name for name, _ in calls] == ["decode_attention_launch"]
    assert da.pooled_decode_attention.launches == before


def test_attention_refuses_a_head_dim_off_the_tensor_core_tiles(fake_serving_lib):
    calls, _ = fake_serving_lib
    with pytest.raises(ValueError, match="head_dim 24 is not a multiple of 16"):
        _attention_launch(calls, b=1, live=1, t=8, d=24)
    with pytest.raises(ValueError, match="head_dim 18 is not a multiple of 4"):
        _attention_launch(calls, b=1, live=1, t=8, d=18, q_dtype=torch.float32)
    assert calls == []
