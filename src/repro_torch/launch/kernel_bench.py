"""Kernel benchmark: the port's kernels against the unfused composition.

    PYTHONPATH=src python -m repro_torch.launch.kernel_bench [--smoke] \
        [--device cpu] [--out PATH]

PyTorch counterpart of `benchmarks/kernel_bench.py`, with the same gates,
case names and tolerances; it runs on CUDA unless `--device cpu` is passed
(without CUDA it raises). On the CPU every kernel wrapper takes its plain
version, so the gates check the plain versions' routes there.

Gates (both modes; any failure exits non-zero):
  * `check_equivalence`: `qlinear` on the kernel route against the unfused
    composition for each of `_PARITY_CASES` (N-side columns, K-side per-head
    rows, per-expert batched), forward within TOL_FWD, every gradient
    within TOL_GRAD (max error over max(max|value|, 1)).
  * `_decode_parity`: `attend_decode` on the flash-decode kernel against
    the fallback, fp / int8 / int4 KV, window 0 and 4, within TOL_FWD.
  * decode-attention traffic at the first pool (4 slots x 512): the unfused
    step moves at least 2x (int8) / 4x (int4) the kernel's bytes.
  * the combined QAT backward moves fewer bytes than the split dx/dw pair.
  * the nibble-packed embedding lookup equals the int8-codes lookup bit for
    bit, from a table of half the bytes.
The full run (no `--smoke`) adds the reference's `run()` sections at its
shapes: QAT forward and backward (256 x 1024 x 512, w4a4), the int8 / int4
serving matmuls, the decode pool sweep, and the standalone fake-quant and
bin-stats kernels on a (4096, 1024) f32 tensor.

Bytes. A kernel's bytes are its boundary: every input read once and every
output written once (the reference's `hlo_cost.entry_boundary_bytes`). The
unfused side's bytes are counted by `launch.cost.ByteCounter`, a
TorchDispatchMode that adds up the input and output bytes of every aten op
it runs (views move none). It is the eager counterpart of the reference's `hlo_cost.analyze`,
and reads higher than XLA's count: eager PyTorch fuses nothing.

Times are medians of single-call CUDA-event times on the card, each call
after a 2 GB read that empties the L2 and covers the host's enqueue (as
`chip_smoke.py` times its kernels). A CPU run measures none (they are
written as null): a CPU time says nothing of the device.

The JSON goes to `--out` only (default `build/kernel_bench.json` at the
root of the checkout); nothing else is written.
"""
from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.policy import QuantConfig
from repro_torch.core.quantizer import (QuantSpec, fake_quant, grad_scale,
                                        pack_int4, scale_grad_factor)
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels.decode_attention import pooled_decode_attention
from repro_torch.launch.cost import ByteCounter, boundary_bytes, counted_bytes  # noqa: F401 (ByteCounter: re-exported)
from repro_torch.models import attention as A
from repro_torch.models import common as C

M, K, N = 256, 1024, 512  # tile-multiple QAT hot-path shape
DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "kernel_bench.json"

# decode-attention pool shapes (n_slots, max_len): the full run sweeps all,
# the gate uses the first; floors are the least unfused / kernel byte ratio
_DECODE_POOLS = [(4, 512), (8, 1024), (8, 2048)]
_DECODE_GATES = {8: 2.0, 4: 4.0}

TOL_FWD, TOL_GRAD = 1e-5, 1e-4

# Equivalence-gate cases: one per fused dispatch flavor (N-side columns,
# K-side per-head rows, batched per-expert). Small shapes: the gate checks
# math, the byte counts check traffic.
_PARITY_CASES = {
    "ffn_cols": ("w_in", (40, 24), "bsd,df->bsf", (2, 5, 40), ()),
    "wo_kside": ("wo", (4, 10, 24), "bshk,hkd->bsd", (2, 5, 4, 10), (0,)),
    "moe_expert": ("moe_in", (3, 16, 20), "gecd,edf->gecf", (2, 3, 4, 16),
                   (0,)),
}


# ---------------------------------------------------------------------------
# bytes and times
# ---------------------------------------------------------------------------

class Flush:
    """A 2 GB buffer read before each timed call: the read evicts the 50 MB
    L2, so the call finds its inputs in HBM, and keeps the device busy for
    ~0.7 ms while the host enqueues the call, so the events time the
    device's work and not the Python in front of it."""

    def __init__(self, device: torch.device):
        self.buf = torch.ones(512 * 2**20, dtype=torch.float32, device=device)

    def __call__(self):
        self.buf.sum()


def device_ms(fn, device: torch.device, flush=None, iters: int = 10):
    """Median ms of single fn() calls between CUDA events, each after
    `flush()`, after one warm-up call; None off the GPU (not measured)."""
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _kernel_route(device: torch.device) -> str:
    """The dispatch knob for the kernel route: "on" on the GPU (raises
    rather than run anything else), "auto" on the CPU (the plain versions,
    since "on" refuses CPU tensors)."""
    return "on" if device.type == "cuda" else "auto"


def _t(a, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def _norm_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.detach().to(torch.float64)
    b = b.detach().to(torch.float64)
    return float((a - b).abs().max() / max(a.abs().max().item(), 1.0))


def _parity_case(device, name, shape, eq, xshape, group_axes) -> dict:
    q_off = QuantConfig(w_bits=4, a_bits=4, mode="mdq", fused_matmul="off")
    q_on = q_off.replace(fused_matmul=_kernel_route(device))
    gen = torch.Generator().manual_seed(0)
    p = C.linear_init(gen, name, q_off, shape, std=0.1, group_axes=group_axes)
    p["a_scale"] = torch.tensor(0.3)
    p["a_offset"] = torch.tensor(0.02)
    rng = np.random.default_rng(1)
    x0 = _t(rng.standard_normal(xshape), device, torch.bfloat16)

    def run(qcfg):
        pp = {k: v.to(device).requires_grad_() for k, v in p.items()}
        x = x0.clone().requires_grad_()
        y = C.qlinear(pp, x, name, qcfg, eq)
        wgt = torch.cos(torch.arange(y.numel(), dtype=torch.float32,
                                     device=device) * 0.1)
        loss = torch.sum(y.to(torch.float32).reshape(-1) * wgt)
        grads = torch.autograd.grad(loss, [x] + list(pp.values()))
        return y.detach().to(torch.float32), dict(zip(["x"] + list(pp), grads))

    y_off, g_off = run(q_off)
    y_on, g_on = run(q_on)
    errs = {"fwd": float((y_off - y_on).abs().max())}
    errs["dx"] = _norm_err(g_off["x"].to(torch.float32),
                           g_on["x"].to(torch.float32))
    for k in p:
        errs[f"d{k}"] = _norm_err(g_off[k], g_on[k])
    return errs


def check_equivalence(device) -> tuple[dict, bool]:
    """Kernel-route-vs-unfused drift over every dispatch flavor: ({case.grad:
    err}, ok), ok False past TOL_FWD / TOL_GRAD."""
    errs, ok = {}, True
    for label, case in _PARITY_CASES.items():
        for k, v in _parity_case(device, *case).items():
            errs[f"{label}.{k}"] = v
            ok = ok and v <= (TOL_FWD if k == "fwd" else TOL_GRAD)
    return errs, ok


def _decode_parity(device) -> tuple[dict, bool]:
    """Flash-decode-vs-fallback drift of attend_decode across storage
    widths, windows and GQA grouping: ({case: err}, ok), gate TOL_FWD."""
    hkv, d, b, t, n = 2, 8, 2, 9, 7
    errs, ok = {}, True
    for kv_bits in (0, 8, 4):
        off = QuantConfig(w_bits=8, a_bits=32, mode="mdq",
                          kv_cache_bits=kv_bits, fused_attention="off")
        on = off.replace(fused_attention=_kernel_route(device))
        rng = np.random.default_rng(kv_bits)
        k = _t(rng.standard_normal((b, n, hkv, d)), device)
        v = _t(rng.standard_normal((b, n, hkv, d)), device)
        cpos = torch.arange(n, dtype=torch.int32, device=device).expand(b, n)
        cache = A.cache_append_chunk(
            A.init_kv_cache(off, b, t, hkv, d, device=device), k, v, cpos,
            off, ring=False, window=0)
        q = _t(rng.standard_normal((b, 1, hkv * 4, d)), device)
        pos = torch.full((b,), n - 1, dtype=torch.int32, device=device)
        for window in (0, 4):
            outs = [A.attend_decode(q, cache, qc, q_per_kv=4, pos=pos,
                                    window=window, softcap=30.0)
                    for qc in (off, on)]
            e = float((outs[0].to(torch.float32)
                       - outs[1].to(torch.float32)).abs().max())
            errs[f"int{kv_bits}.decode.w{window}"] = e
            ok = ok and e <= TOL_FWD
    return errs, ok


def decode_attention_case(device, kv_bits: int, n_slots: int, ctx: int,
                          hkv: int = 4, q_per_kv: int = 4, d: int = 128,
                          timed: bool = False, flush=None) -> dict:
    """Bytes of ONE pooled decode step at serving shape: the fallback
    dequantizes the whole pool (all slots x max_len) and takes a dense
    softmax; the flash-decode kernel reads the codes as stored."""
    qcfg = QuantConfig(w_bits=8, a_bits=32, mode="mdq",
                       kv_cache_bits=kv_bits, fused_attention="off")
    h = hkv * q_per_kv
    cache = A.init_kv_cache(qcfg, n_slots, ctx, hkv, d, device=device)
    # every slot live at full context, so no mask can be skipped
    cache = cache._replace(pos=torch.arange(ctx, dtype=torch.int32, device=device)
                           .expand(n_slots, ctx).contiguous())
    q = torch.zeros((n_slots, 1, h, d), dtype=torch.float32, device=device)
    pos = torch.full((n_slots,), ctx - 1, dtype=torch.int32, device=device)
    unfused = lambda: A.attend_decode(q, cache, qcfg, q_per_kv=q_per_kv,
                                      pos=pos, window=0, softcap=0.0)
    args = (q, cache.k, cache.v, cache.k_scale, cache.v_scale, cache.pos,
            pos[:, None])
    fused = lambda: pooled_decode_attention(*args, q_per_kv=q_per_kv,
                                            window=0, softcap=0.0)
    ub = counted_bytes(unfused)
    fb = boundary_bytes(args, fused())
    out = {"n_slots": n_slots, "max_len": ctx, "kv_bits": kv_bits,
           "unfused_bytes": ub, "kernel_bytes": fb, "reduction": ub / fb}
    if timed:
        out["unfused_ms"] = device_ms(unfused, device, flush)
        out["kernel_ms"] = device_ms(fused, device, flush)
    return out


def qat_bwd_traffic(device) -> dict:
    """Boundary bytes of the split dx / dw pair against the combined
    backward, at (M, K, N) w4a4 with column scales."""
    wspec = QuantSpec(bits=4)
    aspec = QuantSpec(bits=4, signed=False, offset=True)
    kw = dict(q_n_a=aspec.q_n, q_p_a=aspec.q_p, q_n_w=wspec.q_n,
              q_p_w=wspec.q_p)
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    args = (ones(M, N), ones(M, K), ones(K, N), ones(), ones(), ones(1, N))
    split = (boundary_bytes(args, qmm.quant_matmul_dx(*args, **kw))
             + boundary_bytes(args, qmm.quant_matmul_dw(*args, **kw)))
    combined = boundary_bytes(args, qmm.quant_matmul_bwd(*args, **kw))
    return {"split_bytes": split, "combined_bytes": combined,
            "split_vs_combined": split / combined}


def tc_scratch_bytes(m: int, k: int, n: int, *, backward: bool) -> int:
    """Bytes of the tensor-core path's bf16 scratch on the CUDA kernels,
    written once by the prologue and read once by the tile: xd and wd for
    the forward, and bf16(dY) as well for the (bf16-cotangent) backward (0
    where the backward takes the split route, whose scratch this does not
    count). Not in `kernel_bytes`, which counts the boundary alone."""
    if not backward:
        return 2 * sum(qmm._fwd_tc_scratch(m, k, n)[1])
    if qmm.bwd_route(m, k, n) != "tc":
        return 0
    return 2 * sum(qmm._bwd_tc_scratch(m, k, n)[1])


def _embed_lookup_cases(rng, device, vocab=4096, d_model=1024, n_tokens=128):
    """Matched int8-codes / packed-int4 serving embeddings + a token batch."""
    codes = _t(rng.integers(-8, 8, (vocab, d_model)), device, torch.int8)
    scale = torch.tensor(0.02, device=device)
    toks = _t(rng.integers(0, vocab, (2, n_tokens // 2)), device, torch.int64)
    eqcfg = QuantConfig(w_bits=4, a_bits=32, mode="mdq", edge_bits=4)
    return ({"codes": codes, "w_scale": scale},
            {"codes4": pack_int4(codes, 1), "w_scale": scale}, toks, eqcfg)


def embedding_gate(device) -> tuple[dict, bool]:
    rng = np.random.default_rng(2)
    emb8, emb4, toks, eqcfg = _embed_lookup_cases(rng, device, vocab=64,
                                                  d_model=32, n_tokens=16)
    y8 = C.embed_lookup(emb8, toks, eqcfg)
    y4 = C.embed_lookup(emb4, toks, eqcfg)
    equal = y8.dtype == y4.dtype and bool(torch.equal(y8, y4))
    half = emb4["codes4"].numel() * 2 == emb8["codes"].numel()
    return ({"table_bytes_int8": emb8["codes"].numel(),
             "table_bytes_int4": emb4["codes4"].numel(), "lookup_equal": equal},
            equal and half)


# ---------------------------------------------------------------------------
# the full run's sections
# ---------------------------------------------------------------------------

def run(device) -> dict:
    flush = Flush(device) if device.type == "cuda" else None
    ms = lambda fn: device_ms(fn, device, flush)
    rng = np.random.default_rng(0)
    wspec = QuantSpec(bits=4)
    aspec = QuantSpec(bits=4, signed=False, offset=True)
    x = _t(rng.standard_normal((M, K)), device)
    w = _t(rng.standard_normal((K, N)) * 0.05, device)
    ws = _t(np.abs(rng.standard_normal(N)) * 0.02 + 0.01, device)
    a_s = torch.tensor(0.2, device=device)
    a_b = torch.tensor(0.05, device=device)
    kw = dict(q_n_a=aspec.q_n, q_p_a=aspec.q_p, q_n_w=wspec.q_n,
              q_p_w=wspec.q_p)
    wcols = ws.reshape(1, -1)

    # ---- QAT forward -------------------------------------------------------
    unfused_fwd = lambda: ref.quant_matmul(x, w, a_s, a_b, wcols, **kw)
    fused_fwd = lambda: ops.fused_qat_matmul(x, w, a_s, a_b, ws, aspec, wspec)
    fwd_args = (x, w, a_s, a_b, wcols)
    qat_fwd = {"unfused_bytes": counted_bytes(unfused_fwd),
               "kernel_bytes": boundary_bytes(
                   fwd_args, qmm.quant_matmul(*fwd_args, **kw)),
               "scratch_bytes": tc_scratch_bytes(M, K, N, backward=False),
               "unfused_ms": ms(unfused_fwd),
               "kernel_ms": ms(fused_fwd)}
    qat_fwd["reduction"] = qat_fwd["unfused_bytes"] / qat_fwd["kernel_bytes"]

    # ---- QAT backward (dX, dW + scale / offset reductions) -----------------
    def unfused_grad():
        leaves = [t.clone().requires_grad_() for t in (x, w, a_s, a_b, ws)]
        xx, ww, ss, bb, cc = leaves
        xq = fake_quant(xx, ss, aspec, offset=bb, grad_scale_ref=ww.detach())
        wd = fake_quant(ww, cc.reshape(1, -1), wspec)
        y = torch.matmul(xq.to(torch.bfloat16), wd.to(torch.bfloat16))
        return torch.autograd.grad(torch.sum(y.to(torch.float32)), leaves)

    def fused_grad():
        leaves = [t.clone().requires_grad_() for t in (x, w, a_s, a_b, ws)]
        xx, ww, ss, bb, cc = leaves
        g_a = scale_grad_factor(aspec, ww.detach(), ())
        g_w = scale_grad_factor(wspec, ww.detach(), (1, N))
        y = ops.fused_qat_matmul(
            xx, ww, grad_scale(ss, g_a), grad_scale(bb, g_a),
            grad_scale(cc.reshape(1, -1), g_w).reshape(-1), aspec, wspec)
        return torch.autograd.grad(torch.sum(y), leaves)

    qat_bwd = qat_bwd_traffic(device)
    qat_bwd.update({"scratch_bytes": tc_scratch_bytes(M, K, N, backward=True),
                    "unfused_bytes": counted_bytes(unfused_grad),
                    "unfused_ms": ms(unfused_grad),
                    "kernel_ms": ms(fused_grad)})
    qat_bwd["reduction"] = qat_bwd["unfused_bytes"] / qat_bwd["combined_bytes"]

    # ---- serving: int8 codes vs nibble-packed int4 -------------------------
    codes = _t(rng.integers(-wspec.q_n, wspec.q_p + 1, (K, N)), device,
               torch.int8)
    packed = pack_int4(codes, 0)

    def unfused_serving():
        wd = codes.to(torch.bfloat16) * ws.reshape(1, -1).to(torch.bfloat16)
        return torch.matmul(x.to(torch.bfloat16), wd)

    serving = {
        "unfused_bytes": counted_bytes(unfused_serving),
        "int8_kernel_bytes": boundary_bytes(
            (x.to(torch.bfloat16), codes, ws), qmm.int_matmul(x, codes, ws)),
        "int4_kernel_bytes": boundary_bytes(
            (x.to(torch.bfloat16), packed, ws), qmm.int4_matmul(x, packed, ws)),
        "weight_bytes_int8": K * N, "weight_bytes_int4": K * N // 2,
        "weight_traffic_reduction": (K * N) / (K * N // 2),
        "unfused_ms": ms(unfused_serving),
        "int8_kernel_ms": ms(lambda: ops.int_matmul(x, codes, ws, wspec)),
        "int4_kernel_ms": ms(
            lambda: ops.int_matmul(x, packed, ws, wspec, packed=True))}

    # ---- serving embedding: gathered int8 rows vs nibble-packed rows -------
    emb8, emb4, toks, eqcfg = _embed_lookup_cases(rng, device)
    y8 = C.embed_lookup(emb8, toks, eqcfg)
    y4 = C.embed_lookup(emb4, toks, eqcfg)
    ev, ed = emb8["codes"].shape
    b8 = boundary_bytes((emb8, toks), y8)
    b4 = boundary_bytes((emb4, toks), y4)
    embedding = {"vocab": ev, "d_model": ed, "tokens_gathered": toks.numel(),
                 "lookup_bytes_int8": b8, "lookup_bytes_int4": b4,
                 "bytes_saved": b8 - b4, "table_bytes_int8": ev * ed,
                 "table_bytes_int4": ev * ed // 2, "reduction": b8 / b4}

    # ---- serving: flash-decode attention over the quantized pool -----------
    decode_sweep = [decode_attention_case(device, bits, ns, ctx, timed=True,
                                          flush=flush)
                    for ns, ctx in _DECODE_POOLS for bits in (8, 4)]

    # ---- standalone kernels ------------------------------------------------
    wq = _t(rng.standard_normal((4096, 1024)) * 0.1, device)
    s05 = torch.tensor(0.05, device=device)
    fq = lambda: ops.fake_quant(wq, s05, wspec)
    bs = lambda: ops.bin_stats(wq, s05, wspec)
    fq_plain = lambda: ref.fake_quant_2d(wq, s05, q_n=wspec.q_n, q_p=wspec.q_p)
    bs_plain = lambda: ref.bin_stats_2d(wq, s05, q_n=wspec.q_n, q_p=wspec.q_p)
    standalone = {
        "shape": list(wq.shape), "bits": wspec.bits,
        "fake_quant_kernel_bytes": boundary_bytes((wq, s05), fq()),
        "fake_quant_plain_bytes": counted_bytes(fq_plain),
        "fake_quant_kernel_ms": ms(fq),
        "fake_quant_plain_ms": ms(fq_plain),
        "bin_stats_kernel_bytes": boundary_bytes((wq, s05), bs()),
        "bin_stats_plain_bytes": counted_bytes(bs_plain),
        "bin_stats_kernel_ms": ms(bs),
        "bin_stats_plain_ms": ms(bs_plain)}

    return {"shape": {"m": M, "k": K, "n": N, "w_bits": 4, "a_bits": 4},
            "qat_fwd": qat_fwd, "qat_bwd": qat_bwd, "serving_int4": serving,
            "embedding_pack": embedding,
            "decode_attention": {
                "hkv": 4, "q_per_kv": 4, "head_dim": 128,
                "reduction_floors": {f"int{b}": g
                                     for b, g in _DECODE_GATES.items()},
                "pool_sweep": decode_sweep},
            "standalone": standalone}


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _fmt(v) -> str:
    if v is None:
        return "not measured"
    if isinstance(v, float):
        return f"{v:,.4f}"
    return f"{v:,}" if isinstance(v, int) else str(v)


def _bench(args, device) -> int:
    failures = []
    errs, ok = check_equivalence(device)
    print("[equivalence]")
    for k, v in sorted(errs.items()):
        print(f"  {k:32s} {v:.2e}")
    if not ok:
        failures.append("kernel-route-vs-unfused equivalence drift past "
                        f"tolerance (fwd {TOL_FWD:g}, grads {TOL_GRAD:g})")

    derrs, dok = _decode_parity(device)
    print("[decode_attention parity]")
    for k, v in sorted(derrs.items()):
        print(f"  {k:32s} {v:.2e}")
    if not dok:
        failures.append(f"fused decode attention drifts past {TOL_FWD:g}")
    ns, ctx = _DECODE_POOLS[0]
    gates = {}
    for bits, floor in sorted(_DECODE_GATES.items()):
        case = decode_attention_case(device, bits, ns, ctx)
        gates[f"int{bits}"] = case
        print(f"[decode_attention] int{bits} pool {ns}x{ctx}: "
              f"{case['unfused_bytes']:,} -> {case['kernel_bytes']:,} bytes "
              f"({case['reduction']:.1f}x, floor {floor:.0f}x; eager "
              "unfused count)")
        if case["reduction"] < floor:
            failures.append(f"int{bits} decode-attention byte reduction "
                            f"{case['reduction']:.2f}x under the {floor:.0f}x floor")

    bwd = qat_bwd_traffic(device)
    print(f"[qat_bwd] split_bytes={bwd['split_bytes']:,} "
          f"combined_bytes={bwd['combined_bytes']:,} "
          f"({bwd['split_vs_combined']:.2f}x less backward traffic)")
    if bwd["combined_bytes"] >= bwd["split_bytes"]:
        failures.append("combined backward moves MORE bytes than the split pair")

    emb, eok = embedding_gate(device)
    print(f"[embedding_pack] table {emb['table_bytes_int8']:,} -> "
          f"{emb['table_bytes_int4']:,} bytes, lookup equal "
          f"{emb['lookup_equal']}")
    if not eok:
        failures.append("packed-int4 embedding lookup drifts from int8 codes "
                        "or its table is not half the bytes")

    result = {"device": str(device), "smoke": bool(args.smoke),
              "equivalence": errs, "decode_parity": derrs,
              "decode_gates": gates, "qat_bwd_gate": bwd,
              "embedding_gate": emb,
              "bytes": "kernel = boundary (inputs + outputs once); unfused = "
                       "eager aten-op count (no fusion: above XLA's count)"}
    if device.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(device)
    if not args.smoke:
        r = run(device)
        result.update(r)
        for sect in ("qat_fwd", "qat_bwd", "serving_int4", "standalone"):
            print(f"[{sect}]")
            for k, v in r[sect].items():
                print(f"  {k:32s} {_fmt(v)}")
        print("[decode_attention pool sweep]")
        for case in r["decode_attention"]["pool_sweep"]:
            print(f"  int{case['kv_bits']} {case['n_slots']}x"
                  f"{case['max_len']:5d}: {case['reduction']:6.1f}x, kernel "
                  f"{_fmt(case['kernel_ms'])} ms, unfused "
                  f"{_fmt(case['unfused_ms'])} ms")
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2, sort_keys=True))
    print(f"wrote {out}")
    for f in failures:
        print(f"FAIL: {f}")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.kernel_bench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the gates only (no timing sections)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="where the JSON result goes")
    args = ap.parse_args(argv)
    device = ops.resolve_device(args.device)
    if device.type != "cuda":
        return _bench(args, device)
    # the unfused route's products as one f32 sum (cuBLAS may otherwise
    # reduce bf16 split-K partials in bf16), and no TF32
    mm = torch.backends.cuda.matmul
    saved = (mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = False, False
    try:
        return _bench(args, device)
    finally:
        mm.allow_tf32, mm.allow_bf16_reduced_precision_reduction = saved


if __name__ == "__main__":
    raise SystemExit(main())
