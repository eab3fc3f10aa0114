#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
  1. build   — nvcc builds every CUDA kernel of the port from
               src/repro_torch/kernels/csrc, one process per source, in
               parallel; prints the build seconds and ptxas' register use.
  2. kernels — each kernel against its plain PyTorch version on the card, at
               the shapes granite-8b's serving path gives it, with the stated
               tolerance, run twice for identical bits; prints its plan
               (int4_matmul's and int_matmul's contraction splits, the
               attention's key splits and row tiles), the kernel's median
               ms, the plain version's ms, one PyTorch library call
               computing the same function (timed here only, never used by
               the port) and the least time the card could take (bytes
               over 3.35 TB/s or operations over 989 TFLOP/s, whichever is
               larger), and the device kernels one call launches, as
               torch.profiler names them.
               int_matmul runs at all five w8a8 linears of granite-8b at
               M 4 (w_gate / w_in, w_out, wq, wk / wv, the head) and the
               head at M 32. Then int4_matmul's and int_matmul's rows at
               M 1, 4 and 32 must be bit-equal where they overlap, and an
               attention slot's triple the same bits in a pool of 4, alone,
               and with T 160 grown to 256 by idle rows.
  3. serve   — `repro_torch.launch.serve` on full-width granite-8b, all 36
               layers, w4a4 weights, int8 KV, 4 slots, 8 requests of 128
               prompt tokens and 32 new tokens, chunk 32: prints prefill and
               decode tok/s, peak memory and the launch count of each
               kernel over the run (each must be > 0); then holds two
               requests' engine streams (one-chunk prefill, 4-slot pool)
               equal to their single-request greedy_generate streams, and
               reports the chunk-32 run's streams against them.
  4. serve   — w8a8 weights (every N-side linear on int_matmul) with packed
               int4 KV, 4 layers; and its logits on a 16-token prompt
               against the same port on the CPU (the plain versions), with
               its int4 KV cache and with an fp one. Its
               streams are not held against greedy_generate: with 4-bit KV,
               the chunked prefill's online-softmax merge rounds otherwise
               than a one-shot prefill, and one ulp can flip a 4-bit code
               (the JAX package's own int4 engine test shows the same).
  12. moe serve — `repro_torch.launch.serve` on full-width
               granite-moe-1b-a400m, all 24 layers, 32 experts top 8, tied
               head, w3a3 weights (3-bit packed experts: the
               dequantize-and-einsum fallback in 8-row blocks; an 8-bit
               f32 router), int8 KV, 4 slots, 8 requests of 128 prompt
               tokens and 32 new tokens, chunk 32 (run after phase 4):
               phase 3's numbers, int4_matmul's and pooled_decode_attention's
               launches (each > 0) and its stream contract at the config's
               own capacity factor 1.25 (a one-chunk prefill has
               greedy_generate's shape and capacity; a decode step's 4 tokens
               fit an expert's 8 slots); then a token's MoE-layer output the
               same bits at M 1, 4 and 32, a slot's decode logits the same
               bits alone, in a pool of 4 and beside 3 idle slots; the expert
               dequantization's ms a decode step; and a 4-layer cut's logits
               on a 16-token prompt against the CPU, int8 and fp KV, with
               phase 4's bars.
  5. qat kernels — each QAT kernel against its plain version at the shapes
               of the training path (M = 8 x 512 tokens of qwen1.5-0.5b):
               quant_matmul (the tensor-core path) at both FFN shapes, a
               K-side-scaled wo and the tied head, granite-moe's attention
               shapes (w3a3) and head (8 bits), and odd, misaligned shapes
               (one with f32 x), each row within 1e-5 x max|y| and every
               element within the f32 order bound, run twice for identical
               bits, its prologue bit-equal to the plain dequantization;
               quant_matmul_bwd at the FFN's two shapes and wo (bf16
               cotangents, the tensor-core path), at granite-moe's attention
               shapes (w3a3), at odd, misaligned shapes (one with f32 x), and
               once with f32 cotangents (the SIMT path), each row naming its
               path, run twice for identical bits, and on the tensor-core
               path its prologue bit-equal to the plain dequantization;
               quant_matmul_dx / _dw (the split grids, on the tensor cores)
               at the head with f32 cotangents as three exact bf16 planes
               (the planes bit-equal to the plain split, hi + mid + lo == dY
               in f64 over the whole cotangent), at the FFN's shape with bf16
               cotangents (one plane, bit-equal to quant_matmul_bwd's
               outputs) and at an odd K-side shape with f32 cotangents; the
               split's edges: a softmax head cotangent with entries below
               2^-110, and whether mma.sync keeps a bf16 subnormal lo
               (reported); with the same four numbers a kernel (the f32 SIMT
               line beside the three planes' bound), and the bars of the CPU
               tests; on the tensor cores dws is held as in phase 5b (the
               plain bar plus its differing bf16(xd^T dY) summands x
               |q - mf u|, read from a launch with w = 0, each summand the
               real dW where w is in range and held to the dW bar; the
               allowance approved for phase 5 too, ROADMAP Queue 3), each
               row printing the share of the allowance it uses (<= 1.0).
  6. train   — `repro_torch.launch.train` on full-width qwen1.5-0.5b (24
               layers, tied head, QKV bias), w4a4, MCKD top-16, sentinel on,
               batch 8 x 512, 3 steps saving at step 2, then a second call to
               4 steps that restores step 2 and runs one: finite loss, health
               0 every step, s/step, tokens/s, peak memory, and each QAT
               kernel's launches equal to its count per step x steps.
  7. route   — the same model cut to 2 layers, batch 2 x 256: gradients on
               the kernel route against the unfused composition on the card
               (run with the kernels' rule at the clip edge; the gaps against
               the composition as it is are printed beside it).
  5b. moe kernels — quant_matmul_batched and quant_matmul_bwd_batched
               against their plain versions at granite-moe-1b-a400m's expert
               shapes (32 experts x 1280 capacity rows, K/N 1024/512 and
               512/1024, w3a3) and at an odd (3, 257, 129, 65) with f32 x,
               both on the tensor cores; the forward with phase 5's forward
               bars and experts 0 and E-1 bit-equal to quant_matmul on their
               slices; the backward with phase 5's backward bars per expert,
               each row naming its path, run twice for identical bits, its
               prologue bit-equal to the plain dequantization, and experts 0
               and E-1 bit-equal in all five outputs to quant_matmul_bwd on
               their slices; on the tensor cores dws may also differ from
               the plain dws by its differing bf16(xd^T dY) summands x
               |q - mf u| (read from a launch with w = 0, each summand held
               to the dW bar); the backward also with f32 cotangents (the
               SIMT path) and once on its split route (a wide N past the
               reference's scratch budget: the split grids on the tensor
               cores, expert by expert, with the tensor-core rows' bars);
               run with phase 5.
  8. train   — `run_training` on full-width granite-moe-1b-a400m (24 layers,
               32 experts top 8, tied head), w3a3 (OBR lambda 0.1 on a cosine
               ramp) with oscillation tracking, MCKD top-16, sentinel on,
               batch 8 x 512, 3 steps: finite loss and no fatal health bit
               every step, loss_main / loss_obr / obr_lambda (0, then > 0) /
               osc_frac / lb_loss / drop_frac per step, s/step, peak memory,
               and every QAT kernel's launches equal to the printed formula x
               3 (the batched kernels on the expert linears).
  9. route   — granite-moe cut to 2 layers, batch 2 x 256, at init: phase
               7's check, plus the share of expert choices that differ
               between the routes.
  10. quantizer kernels — fake_quant_2d, fake_quant_rows and bin_stats_2d
               against their plain versions (fake-quant bit for bit; bin
               counts equal, sums within 1e-5 of each bin's sum of
               |summands|) at the kernel benchmark's (4096, 1024) f32,
               granite-8b's w_in (4096, 14336) f32 at 4 and 8 bits,
               qwen1.5-0.5b's FFN activation (4096, 2816) bf16 unsigned
               4 bits with offset, granite-moe's expert stack (32, 1024 x
               512) with a scale an expert at 3 bits, and odd, misaligned
               edges; run with phase 5.
  11. kernel bench — `repro_torch.launch.kernel_bench` --smoke, then the
               full run (JSON in build/, its numbers also on stdout and
               in the summary line): every gate passes, and
               fake_quant_2d / bin_stats_2d are launched (fake_quant_rows
               has no entry point: its launches are phase 10's).
  13. serve  — `repro_torch.launch.serve` on full-width musicgen-medium, all
               48 layers (learned positions, layernorm, gelu, untied 8-bit
               head), w4a4, int8 KV, 4 slots, 8 requests of 128 prompt
               tokens and 32 new tokens, chunk 32 (run after phase 12):
               phase 3's numbers, kernels 7, 8 and 9 launched, streams
               equal greedy_generate with a one-chunk prefill, a slot's
               decode logits the same bits alone, pooled and beside idle
               slots, and a 4-layer cut against the CPU with phase 4's
               bars. Phase 2 holds kernels 7-9 at its shapes and phase 5
               the QAT kernels at the training shapes of phase 14 (the
               f32 SIMT backward at musicgen-medium's and paper-deit-t's
               heads, the one-plane split dx / dw at musicgen-medium's
               w_in, paper-bert-base's head on three planes).
  14. train  — `repro_torch.launch.train --arch musicgen-medium` (w4a4, MCKD,
               batch 8 x 512, 3 steps); `run_training` on full-width
               paper-bert-base (w2a2, OBR, oscillation tracked, batch 32 x
               128) and paper-deit-t (w3a3, batch 64 x 197 patches): finite
               losses, health 0, s/step, peak memory, and each run's QAT
               launches equal to `qat_launches_per_step`, which decides
               each linear's backward route by `quant_matmul.bwd_route` on
               the padded shape as the dispatcher does. Then the MCKD store
               on the card: paper-bert-base's fp teacher builds a shard of
               2 batches x 4 window_crop views, read back bit for bit, and
               one w2a2 MCKD step trains from it.
  15. tables — the five paper-table twins (`repro_torch.tables`) at their
               reference size, steps cut to TABLE_STEPS: their rows,
               every value finite.
Then one JSON line with every kernel's numbers, the card's name and power
limit (nvidia-smi), and last `{"ok": true, "device": {...}}`.

Phases 2, 5 and 10 each draw their random inputs from a generator of their
own, seeded with 100 x SEED + the phase's number, so that rows added to one
phase leave the others' inputs as they were.

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Imports
nothing of JAX.
"""
from __future__ import annotations

import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak, H100 SXM
F32_OPS_PER_S = 67e12         # f32 outside the tensor cores, H100 SXM
NEG_INF = -2.0e9
SEED = 0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median of single-launch CUDA-event times (`kernel_bench.device_ms`).
    Before each launch a 2 GB buffer is read (not written: dirty lines
    would be written back during the timed launch): it evicts the 50 MB
    L2, so every launch finds its inputs in HBM as the serving path does
    (each weight is read once a step), and it keeps the device busy for
    ~0.7 ms while the host enqueues the timed call, so the events time the
    device's work and not the Python in front of the launch."""

    def __init__(self, torch, iters: int = 15):
        from repro_torch.launch.kernel_bench import Flush, device_ms
        self.device = torch.device("cuda")
        self.flush = Flush(self.device)
        self.iters = iters
        self._device_ms = device_ms

    def ms(self, fn) -> float:
        return self._device_ms(fn, self.device, self.flush, self.iters)


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _same_bits(torch, a, b) -> bool:
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def device_kernels(torch, fn, windows: int = 3, calls: int = 3) -> list:
    """The port's device kernels (its CUDA sources' anonymous namespace) that
    fn launches, by name and template arguments, as torch.profiler reads
    them: the union over a few windows of a few calls each, since a short
    window on the card now and then comes back without some of its kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    names = set()
    for _ in range(windows):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names |= {re.sub(r"^.*?\(anonymous namespace\)::", "", e.key).split("(")[0]
                  for e in prof.key_averages() if "(anonymous namespace)::" in e.key}
    return sorted(names)


def _int_operands(torch, packed: bool, m: int, k: int, n: int, gen):
    dev = "cuda"
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    lim = 8 if packed else 128
    codes = torch.randint(-lim, lim, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    if packed:
        from repro_torch.core.quantizer import pack_int4
        return x, codes, pack_int4(codes, 0), scale
    return x, codes, codes, scale


def check_matmul(torch, timer, qmm, ref, packed: bool, m: int, k: int, n: int,
                 gen) -> dict:
    x, codes, w, scale = _int_operands(torch, packed, m, k, n, gen)
    if packed:
        kern = lambda: qmm.int4_matmul(x, w, scale)
        plain = lambda: ref.int4_matmul(x, w, scale)
    else:
        kern = lambda: qmm.int_matmul(x, w, scale)
        plain = lambda: ref.int_matmul(x, w, scale)
    y_k = kern()
    y_k2 = kern()
    y_r = plain()
    torch.cuda.synchronize()
    err = (y_k - y_r).abs().max().item()
    repeat = _same_bits(torch, y_k, y_k2)
    # only the f32 summation order differs (up to 14336 terms)
    tol = 1e-5 * y_r.abs().max().item()
    wd = (codes.float() * scale).to(torch.bfloat16)
    lib = lambda: torch.matmul(x, wd)
    nbytes = m * k * 2 + w.numel() + n * 4 + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
    row = {"shape": [m, k, n], "max_abs_err": err, "tol": tol, "repeat": repeat,
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    name = "int4_matmul" if packed else "int_matmul"
    # both kernels cut the contraction by int4_plan; int_matmul's blocks
    # are 128 columns wide at decode and 64 at prefill
    pl = dict(qmm.int4_plan(k, n), token_tiles=qmm.int4_token_tiles(m))
    tiles = pl["col_tiles"] if packed else qmm.int8_col_tiles(m, n)
    pl["block_cols"] = qmm.INT4_COLS if packed else qmm.INT8_COLS[int(m > 8)]
    pl["blocks"] = tiles * pl["splits"] * pl["token_tiles"][1]
    row["plan"] = pl
    row["device_kernels"] = device_kernels(torch, kern)
    plan = (f" [plan: {pl['splits']} splits x {pl['ksteps_per_split']} steps, "
            f"{pl['blocks']} blocks of {pl['block_cols']} columns; "
            f"{', '.join(row['device_kernels'])}]")
    log(f"  {name} M={m} K={k} N={n}{plan}: max|err| {err:.3e} (tol {tol:.3e}), "
        f"repeat {'ok' if repeat else 'DIFFERS'}; "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"torch.matmul(bf16 dequant) {row['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        fail(f"{name} {m}x{k}x{n} disagrees with its plain version: {err} > {tol}")
    if not repeat:
        fail(f"{name} {m}x{k}x{n}: a second launch gave other bits")
    return row


def check_m_independence(torch, qmm, k: int, n: int, gen, packed: bool = True) -> dict:
    """int4_matmul's (or int_matmul's) rows at M 1, 4 and 32 bit-equal where
    they overlap: the plan, hence each element's sum order, depends on
    (K, N) alone (not on the block width or the token tiles)."""
    x, _, w, scale = _int_operands(torch, packed, 32, k, n, gen)
    kern = qmm.int4_matmul if packed else qmm.int_matmul
    name = kern.__name__
    ys = {m: kern(x[:m], w, scale) for m in (1, 4, 32)}
    torch.cuda.synchronize()
    ok = all(_same_bits(torch, ys[m], ys[32][:m]) for m in (1, 4))
    log(f"  {name} K={k} N={n}: rows at M 1, 4, 32 bit-equal: {ok}")
    if not ok:
        fail(f"{name} {k}x{n}: a row's bits depend on M")
    return {"shape": [k, n], "m": [1, 4, 32], "equal": ok}


def check_attention(torch, timer, da, ref, *, storage: str, c: int, window: int,
                    softcap: float, gen, qdtype=None, b=4, t=160, hkv=8,
                    q_per_kv=4, d=128) -> dict:
    dev = "cuda"
    qdtype = qdtype or torch.bfloat16
    h = hkv * q_per_kv
    q = torch.randn((b, c, h, d), generator=gen, device=dev).to(qdtype)
    k = torch.randn((b, t, hkv, d), generator=gen, device=dev)
    v = torch.randn((b, t, hkv, d), generator=gen, device=dev)
    pos = torch.full((b, t), -1, dtype=torch.int32, device=dev)
    pos[0, :100] = torch.arange(100, device=dev)
    pos[1, :] = torch.arange(t, device=dev)
    pos[2, :40] = torch.arange(40, device=dev)          # slot 3 stays idle
    last = torch.tensor([99, t - 1, 39, -1], device=dev)
    q_pos = (last[:, None] - c + 1 + torch.arange(c, device=dev)).to(torch.int32)
    q_pos[3] = -1
    if storage == "fp":
        ks_ = vs_ = None
        k_st, v_st = k.to(qdtype), v.to(qdtype)
    else:
        from repro_torch.core.quantizer import QuantSpec, pack_int4
        from repro_torch.models.attention import _quantize_kv
        spec = QuantSpec(bits=8 if storage == "int8" else 4)
        k_st, ks_ = _quantize_kv(k, spec)
        v_st, vs_ = _quantize_kv(v, spec)
        if storage == "int4":
            k_st, v_st = pack_int4(k_st, -1), pack_int4(v_st, -1)
    args = (q, k_st, v_st, ks_, vs_, pos, q_pos)
    kw = dict(q_per_kv=q_per_kv, window=window, softcap=softcap)
    kern = lambda: da.pooled_decode_attention(*args, **kw)
    plain = lambda: ref.pooled_decode_attention(*args, **kw)
    acc_k, m_k, l_k = kern()
    again = kern()
    acc_r, m_r, l_r = plain()
    torch.cuda.synchronize()
    repeat = all(_same_bits(torch, u, w) for u, w in zip((acc_k, m_k, l_k), again))
    live = m_r > NEG_INF / 2
    o_k = (acc_k / l_k[..., None])[live]
    o_r = (acc_r / l_r[..., None])[live]
    err = (o_k - o_r).abs().max().item()
    if qdtype == torch.float32:
        tol = 1e-5  # only the f32 summation order differs
    else:
        # P is rounded to bf16 after an f32 exp of dots summed in another
        # order, so a P at a rounding boundary lands one bf16 ulp apart
        tol = 2.0 ** -7 * o_r.abs().max().item()
    m_err = (m_k[live] - m_r[live]).abs().max().item()
    dead_ok = bool((m_k[~live] == NEG_INF).all() and (l_k[~live] > 0).all()
                   and torch.isfinite(acc_k).all() and torch.isfinite(l_k).all())
    kd, vd = (ref.dequant_kv(s, sc, d, qdtype) for s, sc in
              ((k_st, ks_), (v_st, vs_)))
    # yardstick: SDPA on the dequantized cache, GQA expanded, same masks
    qh = (q.float() * d ** -0.5).to(qdtype).transpose(1, 2)
    kh = kd.repeat_interleave(q_per_kv, 2).transpose(1, 2)
    vh = vd.repeat_interleave(q_per_kv, 2).transpose(1, 2)
    valid = (pos[:, None, :] >= 0) & (pos[:, None, :] <= q_pos[:, :, None])
    if window > 0:
        valid &= pos[:, None, :] > q_pos[:, :, None] - window
    mask = valid[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = lambda: sdpa(qh, kh, vh, attn_mask=mask, scale=1.0)
    esz = 2 if qdtype == torch.bfloat16 else 4
    kv_bytes = 2 * k_st.numel() * k_st.element_size()
    sc_bytes = 0 if ks_ is None else 2 * ks_.numel() * 4
    nbytes = (q.numel() * esz + kv_bytes + sc_bytes + pos.numel() * 4
              + q_pos.numel() * 4 + acc_k.numel() * 4 + 2 * m_k.numel() * 4)
    b_ms, b_by = bound(nbytes, 4.0 * b * c * h * t * d)
    row = {"shape": {"B": b, "C": c, "H": h, "Hkv": hkv, "T": t, "D": d,
                     "storage": storage, "window": window, "softcap": softcap,
                     "q": str(qdtype).replace("torch.", "")},
           "plan": da.decode_plan(t, c * q_per_kv, qdtype == torch.bfloat16),
           "repeat": repeat, "max_abs_err": err, "tol": tol, "ms": timer.ms(kern),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"  pooled_decode_attention {storage} q={row['shape']['q']} C={c} "
        f"T={t} window={window} softcap={softcap}: max|err| {err:.3e} "
        f"(tol {tol:.3e}), max|dm| {m_err:.2e}, masked rows ok {dead_ok}, "
        f"repeat {'ok' if repeat else 'DIFFERS'} [plan: {row['plan']['splits']} "
        f"splits x {da.KV_SPLIT} keys, {row['plan']['row_tiles']} x "
        f"{row['plan']['rows']} rows]; "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"sdpa(dequant) {row['library_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    if not err <= tol:
        fail(f"decode attention {storage} C={c} disagrees: {err} > {tol}")
    if not m_err <= 1e-4 * max(1.0, m_r[live].abs().max().item()):
        fail(f"decode attention {storage} C={c}: running max differs by {m_err}")
    if not dead_ok:
        fail(f"decode attention {storage} C={c}: fully masked rows not finite "
             "with m = NEG_INF, l > 0")
    if not repeat:
        fail(f"decode attention {storage} C={c}: a second launch gave other bits")
    return row


def check_slot_independence(torch, da, *, storage: str, c: int, gen, qdtype=None,
                            hkv=8, q_per_kv=4, d=128) -> dict:
    """A slot's triple is the same bits in a pool of 4 slots, alone (B 1),
    and with the pool's T of 160 grown to 256 by idle rows (pos -1, random
    codes): the key splits sit at fixed keys and a wholly masked split adds
    nothing."""
    dev = "cuda"
    qdtype = qdtype or torch.bfloat16
    b, t, t_big = 4, 160, 256
    q = torch.randn((b, c, hkv * q_per_kv, d), generator=gen, device=dev).to(qdtype)
    kv = torch.randn((2, b, t_big, hkv, d), generator=gen, device=dev)
    if storage == "fp":
        stores, scales = [kv[0].to(qdtype), kv[1].to(qdtype)], [None, None]
    else:
        from repro_torch.core.quantizer import QuantSpec, pack_int4
        from repro_torch.models.attention import _quantize_kv
        spec = QuantSpec(bits=8 if storage == "int8" else 4)
        stores, scales = zip(*(_quantize_kv(kv[i], spec) for i in range(2)))
        if storage == "int4":
            stores = [pack_int4(st, -1) for st in stores]
    pos = torch.full((b, t_big), -1, dtype=torch.int32, device=dev)
    pos[:, :t] = torch.arange(t, device=dev)
    pos[0, 100:t] = -1
    q_pos = (t - c + torch.arange(c, device=dev, dtype=torch.int32))[None].repeat(b, 1)
    kw = dict(q_per_kv=q_per_kv, window=0, softcap=0.0)

    def run(rows, tt):
        sl = lambda x: None if x is None else x[rows, :tt].contiguous()
        return da.pooled_decode_attention(q[rows], sl(stores[0]), sl(stores[1]),
                                          sl(scales[0]), sl(scales[1]),
                                          pos[rows, :tt].contiguous(), q_pos[rows], **kw)

    pool, alone, grown = run(slice(0, 4), t), run(slice(1, 2), t), run(slice(1, 2), t_big)
    torch.cuda.synchronize()
    b_ok = all(_same_bits(torch, u[1:2], w) for u, w in zip(pool, alone))
    t_ok = all(_same_bits(torch, u, w) for u, w in zip(alone, grown))
    name = f"{storage} q={str(qdtype).replace('torch.', '')} C={c}"
    log(f"  pooled_decode_attention {name}: slot 1 in a pool of 4 == alone: {b_ok}; "
        f"alone at T {t} == at T {t_big} (idle rows): {t_ok}")
    if not (b_ok and t_ok):
        fail(f"decode attention {name}: a slot's bits depend on the pool")
    return {"storage": storage, "C": c, "q": str(qdtype).replace("torch.", ""),
            "pool_eq_alone": b_ok, "t_eq_grown": t_ok}


# (M, K, N) rows of phase 2 (`chip_compare.py` runs the same ones):
# int4_matmul at granite-8b's w4a4 linears at decode and prefill; int_matmul
# at its head at decode and prefill, then the w8a8 model's other N-side
# linears at decode (w_gate / w_in, w_out, wq, wk / wv)
INT4_ROWS = ((4, 4096, 14336), (4, 14336, 4096), (4, 4096, 4096), (4, 4096, 1024),
             (32, 4096, 14336), (32, 14336, 4096))
INT8_ROWS = ((4, 4096, 49152), (32, 4096, 49152), (4, 4096, 14336), (4, 14336, 4096),
             (4, 4096, 4096), (4, 4096, 1024))


def serving_kernel_rows(torch, timer, qmm, da, ref, gen) -> dict:
    """Phase 2: the serving kernels against their plain versions at
    granite-8b's shapes, each run twice for identical bits; int4_matmul's
    and int_matmul's M-independence and the attention's B- and
    T-independence."""
    rows = {"int4_matmul": [], "int_matmul": [], "pooled_decode_attention": []}
    for m, k, n in INT4_ROWS:
        rows["int4_matmul"].append(check_matmul(torch, timer, qmm, ref, True,
                                                m, k, n, gen))
    for m, k, n in INT8_ROWS:
        rows["int_matmul"].append(check_matmul(torch, timer, qmm, ref, False,
                                               m, k, n, gen))
    for storage, c, window, softcap, qd in (
            ("int8", 1, 0, 0.0, None), ("fp", 1, 0, 0.0, None),
            ("int4", 1, 0, 0.0, None), ("int8", 32, 0, 0.0, None),
            ("int8", 1, 64, 50.0, None), ("int4", 32, 64, 50.0, None),
            ("fp", 32, 0, 50.0, None), ("int8", 1, 0, 0.0, torch.float32),
            ("int4", 32, 64, 50.0, torch.float32)):
        rows["pooled_decode_attention"].append(check_attention(
            torch, timer, da, ref, storage=storage, c=c, window=window,
            softcap=softcap, gen=gen, qdtype=qd))
    indep = {"int4_matmul": [check_m_independence(torch, qmm, k, n, gen) for k, n in
                             ((4096, 14336), (14336, 4096), (4096, 1024))],
             "int_matmul": [check_m_independence(torch, qmm, k, n, gen, packed=False)
                            for k, n in ((4096, 49152), (4096, 14336))],
             "pooled_decode_attention": [
                 check_slot_independence(torch, da, storage=st, c=c, gen=gen, qdtype=qd)
                 for st, c, qd in (("int8", 1, None), ("int8", 32, None), ("int4", 1, None),
                                   ("fp", 32, None), ("int8", 1, torch.float32))]}
    return {"rows": rows, "independence": indep}


# musicgen-medium's serving shapes (phase 13's path, run in phase 2 after
# granite-8b's rows): int4_matmul at its w4a4 N-side linears (wq / wk / wv,
# w_in, w_out) at decode and prefill, int_matmul at its untied 8-bit head,
# the attention at D 64 over 24 kv heads (q_per_kv 1) with int8 KV
MUSICGEN_INT4_ROWS = ((4, 1536, 1536), (4, 1536, 6144), (4, 6144, 1536),
                      (32, 1536, 6144), (32, 6144, 1536))
MUSICGEN_INT8_ROWS = ((4, 1536, 2048), (32, 1536, 2048))


def musicgen_kernel_rows(torch, timer, qmm, da, ref, gen, rows: dict) -> None:
    """Kernels 7-9 against their plain versions at musicgen-medium's
    serving shapes, appended to phase 2's rows."""
    for m, k, n in MUSICGEN_INT4_ROWS:
        rows["int4_matmul"].append(check_matmul(torch, timer, qmm, ref, True,
                                                m, k, n, gen))
    for m, k, n in MUSICGEN_INT8_ROWS:
        rows["int_matmul"].append(check_matmul(torch, timer, qmm, ref, False,
                                               m, k, n, gen))
    for c in (1, 32):
        rows["pooled_decode_attention"].append(check_attention(
            torch, timer, da, ref, storage="int8", c=c, window=0, softcap=0.0,
            gen=gen, hkv=24, q_per_kv=1, d=64))


# ---------------------------------------------------------------------------
# phases 3-4: the serving path
# ---------------------------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def check_against_cpu(torch, M, run, qcfg, n_tok: int = 16) -> None:
    """The same params and prompt through the port on the CPU, where every
    kernel wrapper takes its plain version: the reference for the card's
    logits. The two sum in other orders, so isolated bf16 activations land
    one ulp apart and spread. With an fp KV cache that is all: 90th
    percentile |dlogit| <= 2**-7 * max|logit|, max |dp| < 0.02, argmax equal
    at >= 15 of 16 positions. A quantized KV cache turns such an ulp, where
    it crosses a rounding boundary, into a whole code step (amax/7 of the
    head at 4 bits), so there the bar is on what the model decides: max |dp|
    < 0.02 and equal argmax at every position whose top-2 gap in the
    reference exceeds twice that position's largest |dlogit|."""
    prompt = torch.from_numpy(run.prompts[:1, :n_tok])
    pos = torch.arange(n_tok, dtype=torch.int32)[None]
    out = {}
    for dev, params in ((run.device, run.params), ("cpu", _to(run.params, "cpu"))):
        cache = M.init_cache(run.cfg, qcfg, 1, n_tok, dev)
        lg, _ = M.prefill_step(params, cache, {"tokens": prompt.to(dev),
                                               "pos": pos.to(dev)},
                               run.cfg, qcfg)
        out[str(dev)] = lg[0, :, :run.cfg.vocab_size].float().cpu()
    a, b = out[str(run.device)], out["cpu"]
    if not (torch.isfinite(a).all() and a.shape == (n_tok, run.cfg.vocab_size)):
        fail("card logits not finite / wrong shape")
    d = (a - b).abs()
    q90 = torch.quantile(d.flatten(), 0.9).item()
    dp = (torch.softmax(a, -1) - torch.softmax(b, -1)).abs().max().item()
    same = a.argmax(-1) == b.argmax(-1)
    top2 = torch.topk(b, 2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * d.max(-1).values
    scale = b.abs().max().item()
    kv = f"int{qcfg.kv_cache_bits}" if qcfg.kv_cache_bits else "fp"
    log(f"  card vs CPU plain versions, {kv} KV, "
        f"{n_tok}-token prefill: max|dlogit| {d.max().item():.3e}, q90 "
        f"{q90:.3e} (max|logit| {scale:.2f}), max|dp| {dp:.3e}, argmax equal "
        f"{int(same.sum())}/{n_tok} ({int(decided.sum())} decided beyond "
        f"the difference, all equal: {bool(same[decided].all())})")
    if qcfg.kv_cache_bits:
        ok = dp < 0.02 and bool(same[decided].all())
    else:
        ok = q90 <= 2 ** -7 * scale and dp < 0.02 and int(same.sum()) >= n_tok - 1
    if not ok:
        fail("card logits depart from the CPU reference")


def _first_difference(a: list, b: list):
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)


def check_stream_contract(torch, M, serve, run, new_tokens: int, chunk: int):
    """The engine's determinism contract: each request's stream equals its
    own single-request greedy_generate stream. greedy_generate prefills the
    whole prompt in one call and decodes one row; the engine prefills in
    chunks and decodes the pooled slots together. On the kernel route the
    chunking itself changes rounding (the flash-decode kernel rounds P to
    bf16 against each partial's running max, as the TPU kernel does, and
    the merge rescales it), so the contract is held with the engine's chunk
    equal to the prompt length, decoding in a pool of 4 slots; the main
    run's chunked streams are compared and reported. Printed beside it: how
    far a 4-row step's logits are from the same rows run one at a time."""
    from repro_torch.serve import (ModelExecutor, SamplingParams, Scheduler,
                                   ServeEngine)
    cfg, qcfg, params, dev = run.cfg, run.qcfg, run.params, run.device
    plen = run.prompts.shape[1]
    max_len = plen + new_tokens
    step = lambda p, c, b: M.prefill_step(p, c, b, cfg, qcfg)
    rids = (0, len(run.prompts) - 1)
    refs = {}
    for rid in rids:
        cache = M.init_cache(cfg, qcfg, 1, max_len, dev)
        prompt = torch.from_numpy(run.prompts[rid:rid + 1]).to(dev)
        toks, _ = serve.greedy_generate(step, params, cache, prompt, new_tokens)
        refs[rid] = toks[0].tolist()
        got = run.engine.results[f"req-{rid}"].tokens
        log(f"  req-{rid}: chunk-{chunk} engine stream == greedy_generate "
            f"stream: {got == refs[rid]} (first difference at token "
            f"{_first_difference(got, refs[rid])})")

    # rows batched vs one at a time, same inputs: prefill, then one decode
    prompts = torch.from_numpy(run.prompts[:4]).to(dev)
    pos = torch.arange(plen, dtype=torch.int32, device=dev)[None].expand(4, -1)
    pool = M.init_cache(cfg, qcfg, 4, max_len, dev)
    lg4, _ = step(params, pool, {"tokens": prompts, "pos": pos})
    nxt = torch.argmax(lg4[:, -1], -1)[:, None].to(torch.int32)
    dpos = torch.full((4, 1), plen, dtype=torch.int32, device=dev)
    dl4, _ = step(params, pool, {"tokens": nxt, "pos": dpos})
    gaps = []
    for r in range(4):
        single = M.init_cache(cfg, qcfg, 1, max_len, dev)
        lg1, _ = step(params, single, {"tokens": prompts[r:r + 1], "pos": pos[:1]})
        dl1, _ = step(params, single, {"tokens": nxt[r:r + 1], "pos": dpos[:1]})
        gaps.append(((lg4[r, -1] - lg1[0, -1]).abs().max().item(),
                     (dl4[r, 0] - dl1[0, 0]).abs().max().item()))
    log(f"  4 rows together vs one at a time: max|dlogit| prefill "
        f"{max(g[0] for g in gaps):.3e}, decode {max(g[1] for g in gaps):.3e}")

    ex = ModelExecutor(params, cfg, qcfg, n_slots=4, max_len=max_len, chunk=plen)
    eng = ServeEngine(ex, Scheduler(max_len=max_len))
    for rid in rids:
        ok, reason = eng.submit(run.prompts[rid],
                                SamplingParams(max_new_tokens=new_tokens),
                                rid=f"r{rid}")
        if not ok:
            fail(f"engine refused req-{rid}: {reason}")
    eng.run_until_idle()
    for rid in rids:
        got = eng.results[f"r{rid}"].tokens
        first = _first_difference(got, refs[rid])
        log(f"  req-{rid}: chunk-{plen} engine stream (4-slot pool) == "
            f"greedy_generate stream: {first is None}")
        if first is not None:
            fail(f"req-{rid} engine stream departs from greedy_generate at "
                 f"token {first}: {got} vs {refs[rid]}")


def serve_phase(torch, ops, serve, M, argv: list, path_kernels: tuple,
                check_streams: bool, cpu_reference: bool, extra=None) -> dict:
    """Serve through the CLI with the launch counts set to 0 just before and
    read just after; then the stream contract, the CPU reference and
    `extra(run)` (its dict under "extra") as asked."""
    log(f"serve: python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    tp = run.summary["throughput"]
    log(f"  wall {wall:.1f} s (params built on the card included); prefill "
        f"{tp['prefill_tok_s']:.1f} tok/s, decode {tp['decode_tok_s']:.1f} "
        f"tok/s, peak {(run.peak_bytes or 0) / 2**30:.2f} GiB; launches {counts}")
    for name in path_kernels:
        if counts[name] <= 0:
            fail(f"{name} was never launched on the main path: {counts}")
    faults = {k: v for k, v in run.summary["faults"].items() if v}
    if faults:
        fail(f"serving faults: {faults}")
    n_req = len(run.prompts)
    new_tokens = int(argv[argv.index("--new-tokens") + 1])
    for i in range(n_req):
        res = run.engine.results[f"req-{i}"]
        if res.finish_reason != "length" or len(res.tokens) != new_tokens:
            fail(f"req-{i}: {res.finish_reason}, {len(res.tokens)} tokens")
        if not all(0 <= t < run.cfg.vocab_size for t in res.tokens):
            fail(f"req-{i}: token out of vocabulary: {res.tokens}")

    if check_streams:
        chunk = int(argv[argv.index("--chunk") + 1])
        check_stream_contract(torch, M, serve, run, new_tokens, chunk)

    if cpu_reference:  # the run's own KV cache, and an fp one
        check_against_cpu(torch, M, run, run.qcfg)
        check_against_cpu(torch, M, run, run.qcfg.replace(kv_cache_bits=0))
    return {"counts": counts, "summary": run.summary, "peak": run.peak_bytes,
            "wall": wall, "extra": extra(run) if extra else None}


# ---------------------------------------------------------------------------
# phase 12: MoE serving
# ---------------------------------------------------------------------------

def slot_independence(torch, M, run) -> dict:
    """A slot's decode logits are the same bits alone, in a pool of 4 and
    beside 3 idle slots (pos = -1), after the same 16-token prefill of each
    slot inserted as the engine does."""
    cfg, qcfg, params, dev = run.cfg, run.qcfg, run.params, run.device
    plen, max_len = 16, 20
    prompts = torch.from_numpy(run.prompts[:4, :plen]).to(dev)
    nxt = torch.from_numpy(run.prompts[:4, plen:plen + 1]).to(dev)
    pos = torch.arange(plen, dtype=torch.int32, device=dev)[None]

    def decode(rows, idle=()):
        pool = M.init_cache(cfg, qcfg, rows, max_len, dev)
        for r in range(rows):  # each slot's own prefill, inserted as the engine does
            one = M.init_cache(cfg, qcfg, 1, max_len, dev)
            M.prefill_step(params, one, {"tokens": prompts[r:r + 1], "pos": pos}, cfg, qcfg)
            M.cache_slot_insert(pool, one, r)
        dpos = torch.full((rows, 1), plen, dtype=torch.int32, device=dev)
        dpos[list(idle)] = -1
        lg, _ = M.decode_step(params, pool, {"tokens": nxt[:rows], "pos": dpos}, cfg, qcfg)
        return lg[0, 0]

    alone, pooled, beside_idle = decode(1), decode(4), decode(4, (1, 2, 3))
    torch.cuda.synchronize()
    return {"pool_eq_alone": _same_bits(torch, pooled, alone),
            "idle_eq_alone": _same_bits(torch, beside_idle, alone)}


def check_moe_row_independence(torch, M, run) -> dict:
    """A token's MoE-layer output (router, experts, combine) is the same bits
    at M 1, 4 and 32 (capacities 8, 8 and 16), and a slot's decode logits
    the same bits alone, in a pool of 4 and beside 3 idle slots (pos = -1:
    routed, taking capacity), after the same 16-token prefill: the router's
    f32 product runs in fixed 128-row blocks, the experts' bf16 products in
    8-row blocks, and softmax, the stable sort and the k-sum are per row.
    The token is first in every expert's capacity order, so never dropped."""
    from repro_torch.models import moe
    cfg, qcfg, params, dev = run.cfg, run.qcfg, run.params, run.device
    gen = torch.Generator(device=dev).manual_seed(100 * SEED + 12)
    p = params["layers"][0]["moe"]
    x = torch.randn((1, 32, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    outs = [moe.moe_ffn(p, x[:, :m], cfg, qcfg, torch.bfloat16)[0][0, 0]
            for m in (1, 4, 32)]
    torch.cuda.synchronize()
    res = {"moe_m_1_4_32": all(_same_bits(torch, o, outs[0]) for o in outs[1:]),
           **slot_independence(torch, M, run)}
    log(f"  MoE layer 0, token 0 at M 1, 4, 32: same bits {res['moe_m_1_4_32']}; "
        f"decode logits of slot 0 in a pool of 4 == alone: {res['pool_eq_alone']}; "
        f"beside 3 idle slots == alone: {res['idle_eq_alone']}")
    if not all(res.values()):
        fail(f"MoE serving: a row's bits depend on its pool: {res}")
    return res


def expert_dequant(torch, run) -> dict:
    """What the serving fallback's expert dequantization costs a decode step:
    every layer's three expert weights unpacked and scaled to bf16 as
    `common._serving_linear` does (bf16(code) x bf16(scale)); CUDA events
    around the whole step's set (72 weights, far past L2), median of 5."""
    from repro_torch.core.quantizer import unpack_int4
    from repro_torch.models.common import pack_axis_of
    ws = [(lay["moe"][n], n) for lay in run.params["layers"]
          for n in ("moe_in", "moe_gate", "moe_out") if n in lay["moe"]]

    def step():
        for p, n in ws:
            codes = p["codes4"]
            unpack_int4(codes, pack_axis_of(n) % codes.dim()).to(torch.bfloat16) \
                * p["w_scale"].to(torch.bfloat16)

    step()
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    read = sum(p["codes4"].numel() for p, _ in ws)
    written = 2 * 2 * read  # two codes a byte, two bytes a bf16 weight
    ms = statistics.median(times)
    res = {"ms_per_decode_step": ms, "weights": len(ws), "bytes_read": read,
           "bytes_written": written,
           "bound_ms": bound(read + written, 0)[0]}
    log(f"  expert dequantization a decode step: {ms:.3f} ms for {len(ws)} weights "
        f"({read / 1e9:.3f} GB of codes read, {written / 1e9:.3f} GB bf16 written; "
        f"bound {res['bound_ms']:.3f} ms)")
    return res


def moe_serve_checks(torch, M):
    """Phase 12's checks beyond serve_phase's: row independence, the expert
    dequantization's cost, and a 4-layer cut's logits against the CPU."""
    def checks(run) -> dict:
        indep = check_moe_row_independence(torch, M, run)
        dq = expert_dequant(torch, run)
        cut_against_cpu(torch, M, run)
        return {"independence": indep, "expert_dequant": dq}
    return checks


def cut_against_cpu(torch, M, run, layers: int = 4) -> None:
    """The run's model cut to its first `layers` layers, its logits on a
    16-token prompt against the CPU's (phase 4's bars), at the run's KV
    cache and at an fp one."""
    cut = copy.copy(run)
    cut.cfg = run.cfg.replace(n_layers=layers)
    cut.params = dict(run.params, layers=run.params["layers"][:layers])
    log(f"  {layers}-layer cut against the CPU:")
    check_against_cpu(torch, M, cut, run.qcfg)
    check_against_cpu(torch, M, cut, run.qcfg.replace(kv_cache_bits=0))


def dense_serve_checks(torch, M):
    """Phase 13's checks beyond serve_phase's: a slot's decode logits the
    same bits alone, pooled and beside idle slots (layernorm's f64 row
    means, learned positions gathered per row at max(pos, 0)), and a
    4-layer cut's logits against the CPU."""
    def checks(run) -> dict:
        res = slot_independence(torch, M, run)
        log(f"  decode logits of slot 0 in a pool of 4 == alone: "
            f"{res['pool_eq_alone']}; beside 3 idle slots == alone: "
            f"{res['idle_eq_alone']}")
        if not all(res.values()):
            fail(f"{run.cfg.name} serving: a row's bits depend on its pool: {res}")
        cut_against_cpu(torch, M, run)
        return {"independence": res}
    return checks


# ---------------------------------------------------------------------------
# phase 5: the QAT kernels against their plain versions
# ---------------------------------------------------------------------------

QAT_QS = dict(q_n_a=0, q_p_a=15, q_n_w=8, q_p_w=7)    # w4a4: LSQ+ acts, 4-bit w
HEAD_QS = dict(q_n_a=0, q_p_a=255, q_n_w=128, q_p_w=127)  # 8-bit edges


def _bf16_ulp(torch, v):
    a = v.abs().double()
    e = torch.floor(torch.log2(torch.where(a > 0, a, torch.ones_like(a))))
    return torch.where(a > 0, 2.0 ** (e - 7), torch.zeros_like(a))


def _bf16_close(torch, got, want, abs_products, length) -> tuple[float, float]:
    """The CPU tests' bar for dX / dW: each element within one bf16 ulp plus
    the order-independent bound on two f32 sums of `length` products
    (2 * length * 2**-24 * sum|products|), and at most 1% differing.
    Returns (worst excess over the bound, fraction differing)."""
    d = (got.double() - want.double()).abs()
    tol = (_bf16_ulp(torch, torch.maximum(got.abs(), want.abs()))
           + 2 * length * 2.0 ** -24 * abs_products.double())
    return (d - tol).max().item(), (d > 0).double().mean().item()


def qat_operands(torch, m, k, n, k_side, gen, qs, x_dtype=None):
    dev = "cuda"
    x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
        x_dtype or torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    ws = torch.rand((k, 1) if k_side else (1, n), generator=gen, device=dev)
    ws = ws * 0.05 + 0.02
    if qs["q_p_w"] > 7:  # 8-bit edge: scales that use the 8-bit range
        ws = ws * 0.1
    a_s = torch.tensor({15: 0.3, 7: 0.6}.get(qs["q_p_a"], 0.02), device=dev)
    a_b = torch.tensor(-0.2, device=dev)
    return x, w, a_s, a_b, ws


def _order_excess(torch, got, want, xd, wd, length) -> float:
    """Worst excess of |got - want| over the order-independent bound on two
    f32 sums of the same `length` exact products, 2 * length * 2**-24 *
    (|xd| @ |wd|) (<= 0: every element within it)."""
    abs_products = torch.matmul(xd.abs(), wd.abs())
    excess = ((got - want).abs() - 2 * length * 2.0 ** -24 * abs_products).max().item()
    del abs_products
    return excess


def check_qat_fwd(torch, timer, qmm, ref, m, k, n, k_side, gen, qs,
                  x_dtype=None) -> dict:
    """quant_matmul (the tensor-core path) against its plain version: within
    1e-5 x max|y| and, element by element, within the f32 order bound; a
    second launch on the same inputs gives the same bits; the prologue alone
    bit-equal to the plain dequantization."""
    x, w, a_s, a_b, ws = qat_operands(torch, m, k, n, k_side, gen, qs, x_dtype)
    args = (x, w, a_s, a_b, ws)
    kern = lambda: qmm.quant_matmul(*args, **qs)
    plain = lambda: ref.quant_matmul(*args, **qs)
    y_k, y_r = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    repeat = _same_bits(torch, y_k, again)
    del again
    err = (y_k - y_r).abs().max().item()
    tol = 1e-5 * y_r.abs().max().item()
    _, _, xd = ref._act_codes(x, a_s, a_b, qs["q_n_a"], qs["q_p_a"])
    _, _, wd = ref._weight_codes(w, ws, qs["q_n_w"], qs["q_p_w"])
    excess = _order_excess(torch, y_k, y_r, xd, wd, k)
    del y_k, y_r
    same, prologue_ms, _ = check_prologue(torch, timer, qmm, ref, args, qs)
    xd, wd = xd.to(torch.bfloat16), wd.to(torch.bfloat16)
    lib = lambda: torch.matmul(xd, wd)
    checks = [("max|err|", err <= tol, f"{err:.3e}, tol {tol:.3e}"),
              ("order", excess <= 0, f"excess {excess:.2e}"),
              ("repeat", repeat, "same bits on a second launch"),
              ("prologue", same, "bit-equal to the plain dequantization")]
    nbytes = m * k * x.element_size() + k * n * 4 + ws.numel() * 4 + 8 + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
    row = {"shape": [m, k, n], "w_scale": "rows" if k_side else "cols",
           "x": str(x.dtype)[6:], "path": "tc", "max_abs_err": err, "tol": tol,
           "order_excess": excess, "ms": timer.ms(kern),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib),
           "bound_ms": b_ms, "bound_by": b_by, "prologue_ms": prologue_ms}
    log(f"  quant_matmul [tc] M={m} K={k} N={n} ({row['w_scale']} scales, "
        f"{row['x']} x): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, prologue {prologue_ms:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.matmul(bf16 dequant) "
        f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"quant_matmul {m}x{k}x{n} disagrees with its plain version on {bad}")
    return row


def check_prologue(torch, timer, qmm, ref, args, qs, planes=None):
    """A tensor-core prologue alone against the plain dequantization: the
    forward's (args x, w, a_s, a_b, ws; x (M, K) or (E, M, K)) xd and wd, or
    the backward's (dY first) xd, wd and the cotangent's `planes` bf16
    planes (1: bf16(dY); 3: its exact split), zero-padded; bit for bit.
    Returns (equal, its ms, the kernel's planes or None)."""
    name, scratch = (("fwd_prologue", qmm._fwd_tc_scratch) if len(args) == 5
                     else ("bwd_prologue", qmm._bwd_tc_scratch))
    kw = dict(qs) if planes is None else dict(qs, planes=planes)
    kern = lambda: getattr(qmm, name)(*args, **kw)
    m, k = args[-5].shape[-2:]
    lds, _ = scratch(m, k, args[-4].shape[-1])
    got = kern()
    want = getattr(ref, name)(*args, lds=lds, **kw)
    torch.cuda.synchronize()
    same = all(_same_bits(torch, a, b) for a, b in zip(got, want))
    del want
    return same, timer.ms(kern), (got[2] if planes else None)


def check_split(torch, planes, dy, n) -> tuple[bool, int, float]:
    """The kernel's three planes (3, M, ld_y) against the exact split's
    contract: hi + mid + lo == dY in f64 for every |dY| >= 2**-110, and
    within 2**-134 below that. Returns (holds, the count of nonzero |dY|
    below 2**-110, the worst error below it)."""
    holds, below, worst = True, 0, 0.0
    for r0 in range(0, dy.shape[0], 512):  # row blocks: f64 copies of the head are 5 GB
        y = dy[r0:r0 + 512].double()
        s = sum(planes[p, r0:r0 + 512, :n].double() for p in range(3))
        tiny = (y.abs() < 2.0 ** -110) & (y != 0)
        err = (s - y).abs()
        holds = holds and bool((err[~tiny] == 0).all()) and bool((err[tiny] <= 2.0 ** -134).all())
        below += int(tiny.sum().item())
        worst = max(worst, err[tiny].max().item() if bool(tiny.any()) else 0.0)
    return holds, below, worst


def check_qat_bwd(torch, timer, qmm, ref, name, m, k, n, k_side, round_cot,
                  gen, qs, x_dtype=None) -> dict:
    """quant_matmul_bwd (combined) or quant_matmul_dx / _dw (split) against
    the plain versions; the scalar and per-column sums within 1e-4 of their
    sum of |summands| (on the tensor cores dws, as in phase 5b, may also
    differ by its differing bf16(xd^T dY) summands x |q - mf u|, read from
    a launch with w = 0: those must be the real dW where w is in range and
    meet the dW bar); a second launch on the same inputs gives the same
    bits; on the tensor-core path, the prologue bit-equal to the plain
    dequantization and the cotangent's planes. The split dx / dw run on the
    tensor cores, f32 cotangents as three planes whose sum must be dY
    exactly; with bf16 cotangents, where quant_matmul_bwd's route is the
    tensor cores' too, their outputs must equal its bits."""
    x, w, a_s, a_b, ws = qat_operands(torch, m, k, n, k_side, gen, qs, x_dtype)
    dy = torch.randn((m, n), generator=gen, device="cuda")
    kw = dict(round_cot=round_cot, **qs)
    args = (dy, x, w, a_s, a_b, ws)
    fn = getattr(qmm, name)
    plain_fn = getattr(ref, name)
    kern = lambda: fn(*args, **kw)
    plain = lambda: plain_fn(*args, **kw)
    path = (qmm.bwd_route(m, k, n, round_cot) if name == "quant_matmul_bwd"
            else "tc")
    planes = qmm.plane_count(round_cot) if path == "tc" else None
    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    repeat = all(_same_bits(torch, a, b) for a, b in zip(got, again))
    del again
    u_x, q_x, xd = ref._act_codes(x, a_s, a_b, qs["q_n_a"], qs["q_p_a"])
    u_w, q_w, wd = ref._weight_codes(w, ws, qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(dy, round_cot)
    checks, worst = [("repeat", repeat, "same bits on a second launch")], 0.0
    prologue_ms, split = None, None
    if path == "tc":
        same, prologue_ms, dyb = check_prologue(torch, timer, qmm, ref, args, qs, planes)
        checks.append(("prologue", same, f"bit-equal to the plain dequantization, "
                       f"{planes} plane{'s' * (planes > 1)}"))
        if planes == 3:
            holds, below, err = check_split(torch, dyb, dy, n)
            split = {"exact": holds, "below_2^-110": below, "worst_below": err}
            checks.append(("split", holds, f"hi + mid + lo == dY in f64 over all {m * n} "
                           f"cotangents; {below} below 2^-110"))
        del dyb
    if name != "quant_matmul_bwd" and round_cot and qmm.bwd_route(m, k, n, True) == "tc":
        both = qmm.quant_matmul_bwd(*args, **kw)
        mine = both[:3] if name == "quant_matmul_dx" else both[3:]
        checks.append(("as combined", all(_same_bits(torch, a, b) for a, b in zip(got, mine)),
                       "bit-equal to quant_matmul_bwd's tensor-core outputs"))
        del both, mine
    if name in ("quant_matmul_bwd", "quant_matmul_dx"):
        dx_abs = cot.abs() @ wd.abs().T
        ex, frac = _bf16_close(torch, got[0], want[0], dx_abs, n)
        del dx_abs
        mf = ref._in_range(u_x, qs["q_n_a"], qs["q_p_a"])
        dxd = ref._bf16(cot @ wd.T)
        l1a = (dxd * (q_x - mf * u_x)).abs().sum().item()
        l1b = (dxd * (1 - mf)).abs().sum().item()
        del dxd, mf
        checks += [("dX", ex <= 0 and frac <= 0.01, f"excess {ex:.2e}, differing {frac:.2e}"),
                   ("dsa", abs(got[1].item() - want[1].item()) <= 1e-4 * l1a,
                    f"{abs(got[1].item() - want[1].item()):.3e} vs 1e-4 x {l1a:.3e}"),
                   ("dba", abs(got[2].item() - want[2].item()) <= 1e-4 * l1b,
                    f"{abs(got[2].item() - want[2].item()):.3e} vs 1e-4 x {l1b:.3e}")]
        worst = max(worst, (got[0] - want[0]).abs().max().item())
    if name in ("quant_matmul_bwd", "quant_matmul_dw"):
        at = 3 if name == "quant_matmul_bwd" else 0
        gw, ww, rw, rws = got[at], got[at + 1], want[at], want[at + 1]
        dw_abs = xd.abs().T @ cot.abs()
        ex, frac = _bf16_close(torch, gw, rw, dw_abs, m)
        mf = ref._in_range(u_w, qs["q_n_w"], qs["q_p_w"])
        dwd = ref._bf16(xd.T @ cot)
        fac = (q_w - mf * u_w).abs()
        axis = 1 if k_side else 0
        l1 = (dwd.abs() * fac).sum(dim=axis, keepdim=True)
        flips = torch.zeros_like(l1)
        if path == "tc":
            # phase 5b's allowance (ROADMAP Queue 3): the tile's f32 order
            # rounds some bf16(xd^T dY) summands to the other bf16
            # neighbour (the dW bar allows that), and at clipped weights
            # (|q - mf u| up to 4 at 3 bits) one such flip can move a sum
            # past 1e-4 x sum|summands|; so each sum may also differ by its
            # differing summands x |q - mf u|. The kernel's summands come
            # from a launch with w = 0 (every code in range): they must be
            # the real dW wherever w is in range and meet the dW bar.
            dwd_k = fn(dy, x, torch.zeros_like(w), a_s, a_b, ws, **kw)[at]
            real = bool(torch.equal(gw, dwd_k * mf))
            ex_d, fr_d = _bf16_close(torch, dwd_k, dwd, dw_abs, m)
            flips = ((dwd_k - dwd).abs() * fac).sum(dim=axis, keepdim=True)
            checks += [("summands", real, "the w = 0 launch's bf16(xd^T dY) is the real dW "
                        "where in range"),
                       ("xd^T dY", ex_d <= 0 and fr_d <= 0.01,
                        f"every element: excess {ex_d:.2e}, differing {fr_d:.2e}")]
            del dwd_k
        simt_info = None
        if path == "simt":
            # not a check: the shares of bf16(xd^T dY) off its correctly
            # rounded value (f64 product), in the kernel (its w = 0 launch)
            # and in the plain version, and how far correctly rounded
            # summands would put dws from the plain dws (ROADMAP Queue 3)
            dwd_k = fn(dy, x, torch.zeros_like(w), a_s, a_b, ws, **kw)[at]
            dwe = ref._bf16((xd.double().T @ cot.double()).float())
            dws_e = (dwe * (q_w - mf * u_w)).sum(dim=axis, keepdim=True)
            simt_info = {"kernel_off": (dwd_k != dwe).float().mean().item(),
                         "plain_off": (dwd != dwe).float().mean().item(),
                         "exact_vs_plain_bar": ((dws_e - rws).abs()
                                                / (1e-4 * l1).clamp_min(1e-30)).max().item()}
            del dwd_k, dwe, dws_e
        del dw_abs, dwd, fac, mf
        gap = (ww - rws).abs()
        allowed = 1e-4 * l1 + flips
        dws_ok = bool((gap <= allowed).all())
        past = int((gap > 1e-4 * l1).sum().item())
        vs_plain = (gap / (1e-4 * l1).clamp_min(1e-30)).max().item()
        use = (gap / allowed.clamp_min(1e-30)).max().item()
        checks += [("dW", ex <= 0 and frac <= 0.01, f"excess {ex:.2e}, differing {frac:.2e}"),
                   ("dws", dws_ok, f"max {gap.max().item():.3e}, {vs_plain:.3f} x the plain "
                    f"bar, {use:.3f} of the allowance; {past} sums past the plain bar")]
        del gap, l1, flips, allowed
        worst = max(worst, (gw - rw).abs().max().item())
    del got, want
    # yardstick: the two products on operands dequantized beforehand
    ct = cot.to(torch.bfloat16) if round_cot else cot
    xl = xd.to(torch.bfloat16) if round_cot else xd
    wl = wd.to(torch.bfloat16) if round_cot else wd
    libs = {"quant_matmul_dx": lambda: ct @ wl.T, "quant_matmul_dw": lambda: xl.T @ ct,
            "quant_matmul_bwd": lambda: (ct @ wl.T, xl.T @ ct)}
    products = 2 if name == "quant_matmul_bwd" else 1
    outs = {"quant_matmul_dx": m * k * 4 + 8, "quant_matmul_dw": k * n * 4 + ws.numel() * 4,
            "quant_matmul_bwd": m * k * 4 + 8 + k * n * 4 + ws.numel() * 4}[name]
    nbytes = (m * n * 4 + m * k * x.element_size() + k * n * 4 + ws.numel() * 4
              + 8 + outs)
    ops = 2.0 * m * k * n * products
    # f32 cotangents: the f32 SIMT line, and the line of the three planes'
    # bf16 products on the tensor cores (the least time for this kernel's work)
    b32 = None if round_cot else bound(nbytes, ops, F32_OPS_PER_S)[0]
    b_ms, b_by = (bound(nbytes, ops * planes) if planes else
                  bound(nbytes, ops, BF16_OPS_PER_S if round_cot else F32_OPS_PER_S))
    row = {"shape": [m, k, n], "w_scale": "rows" if k_side else "cols",
           "round_cot": round_cot, "path": path, "planes": planes, "x": str(x.dtype)[6:],
           "max_abs_err": worst,
           "tol": "bf16 ulp + f32 order bound; sums 1e-4 x sum|summands|",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(libs[name]), "bound_ms": b_ms, "bound_by": b_by,
           "bound_f32_ms": b32, "prologue_ms": prologue_ms, "split": split}
    if name != "quant_matmul_bwd":  # the grid and its finish: the call less its prologue
        row["grid_tflops"] = ops * planes / (row["ms"] - prologue_ms) / 1e9
    simt_txt = ""
    if path == "simt":  # the split route's three planes on the same inputs, for comparison
        row["split_route_ms"] = timer.ms(lambda: qmm._split_bwd(*args, qs, round_cot))
        row["summands"] = simt_info
        simt_txt = (f"; bf16(xd^T dY) off the correctly rounded value: kernel "
                    f"{simt_info['kernel_off']:.2e}, plain {simt_info['plain_off']:.2e}; "
                    f"correctly rounded summands {simt_info['exact_vs_plain_bar']:.3f} x the "
                    f"plain dws bar")
    pro = "" if prologue_ms is None else f", prologue {prologue_ms:.4f} ms"
    tag = f"{path}, {planes} plane{'s' * (planes > 1)}" if planes else path
    b32_txt = "" if b32 is None else f", f32 SIMT line {b32:.4f} ms"
    log(f"  {name} [{tag}] M={m} K={k} N={n} ({row['w_scale']} scales, "
        f"{row['x']} x, {'bf16' if round_cot else 'f32'} cotangents): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms{pro}, plain {row['plain_ms']:.4f} ms, "
        f"torch.matmul(dequant) {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})"
        + b32_txt + (f", grid {row['grid_tflops']:.1f} TFLOP/s" if "grid_tflops" in row
                     else "")
        + (f", split route {row['split_route_ms']:.4f} ms" if path == "simt" else "")
        + simt_txt)
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"{name} {m}x{k}x{n} disagrees with its plain version on {bad}")
    return row


def split_edges(torch, timer, qmm, ref, gen) -> dict:
    """Two edges of the three-plane split on the card. (1) A head cotangent
    as training makes it, (softmax(z) - onehot) / M over the qwen head's
    152,064 columns with confident logits z = 8 x randn, whose smallest
    entries fall below 2**-110: the prologue's planes bit-equal to the plain
    split and within its contract (`check_split`). (2) Whether mma.sync keeps
    a bf16 subnormal lo: a dX whose hi and mid products cancel exactly,
    leaving lo = 2**-132 (a bf16 subnormal) times wd = 1 (a subnormal
    product) and times wd = 1024 (a normal one, 2**-122). Reported, not
    held: the plain version keeps both."""
    m, n = 8 * 512, 152064
    x, w, a_s, a_b, ws = qat_operands(torch, m, 1024, n, False, gen, HEAD_QS)
    z = torch.randn((m, n), generator=gen, device="cuda") * 8
    dy = torch.softmax(z, dim=1)
    del z
    tgt = torch.randint(0, n, (m,), generator=gen, device="cuda")
    dy[torch.arange(m, device="cuda"), tgt] -= 1.0
    dy /= m
    args = (dy, x, w, a_s, a_b, ws)
    same, _, dyb = check_prologue(torch, timer, qmm, ref, args, HEAD_QS, 3)
    holds, below, err = check_split(torch, dyb, dy, n)
    del dyb, dy, args
    torch.cuda.empty_cache()
    # (2) rows of dY: [y, -(hi + mid)] with y = 2^-115 (1 + 2^-9 + 2^-17):
    # hi = 2^-115, mid = 2^-124, lo = 2^-132; wd rows 1 and 1024 (K-side
    # scales 2^-6 and 16, codes 64); x in range, so dX = bf16(lo x wd)
    y = 2.0 ** -115 * (1 + 2.0 ** -9 + 2.0 ** -17)
    dy = torch.tensor([[y, -(2.0 ** -115 + 2.0 ** -124)]] * 16, device="cuda")
    xs = torch.full((16, 2), 0.5, device="cuda").to(torch.bfloat16)
    wk = torch.tensor([[1.0, 1.0], [1024.0, 1024.0]], device="cuda")
    sk = torch.tensor([[2.0 ** -6], [16.0]], device="cuda")
    probe = (dy, xs, wk, torch.tensor(0.1, device="cuda"), torch.tensor(0.0, device="cuda"),
             sk)
    lo_plane = qmm.bwd_prologue(*probe, planes=3, **HEAD_QS)[2][2, 0, 0].item()
    dx = qmm.quant_matmul_dx(*probe, round_cot=False, **HEAD_QS)[0]
    plain = ref.quant_matmul_dx(*probe, round_cot=False, **HEAD_QS)[0]
    out = {"head_cotangent": {"planes_bit_equal": same, "exact": holds,
                              "below_2^-110": below, "worst_below": err},
           "lo_plane": lo_plane, "kernel_dx": [dx[0, 0].item(), dx[0, 1].item()],
           "plain_dx": [plain[0, 0].item(), plain[0, 1].item()]}
    out["subnormal_lo_kept"] = {"subnormal product": out["kernel_dx"][0] == 2.0 ** -132,
                                "normal product": out["kernel_dx"][1] == 2.0 ** -122}
    log(f"  split edges: softmax head cotangent (z = 8 x randn) planes "
        f"{'ok' if same else 'FAIL'} (bit-equal to the plain split), split "
        f"{'ok' if holds else 'FAIL'} ({below} nonzero below 2^-110, worst error there "
        f"{err:.3e}); subnormal lo: prologue lo {lo_plane:.6e} (2^-132 = "
        f"{2.0 ** -132:.6e}), kernel dX {out['kernel_dx']}, plain {out['plain_dx']}: "
        f"mma.sync kept it {out['subnormal_lo_kept']}")
    if not (same and holds and lo_plane == 2.0 ** -132):
        fail("the three-plane split broke its contract on the card")
    return out


MOE_QS = dict(q_n_a=0, q_p_a=7, q_n_w=4, q_p_w=3)     # w3a3


def batched_operands(torch, e, m, k, n, gen, qs, x_dtype=None):
    dev = "cuda"
    x = (torch.randn((e, m, k), generator=gen, device=dev) * 2).to(
        x_dtype or torch.bfloat16)
    w = torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5
    a_s = torch.rand((e, 1), generator=gen, device=dev) * 0.3 + 0.2
    a_b = torch.randn((e, 1), generator=gen, device=dev) * 0.1
    ws = torch.rand((e, n), generator=gen, device=dev) * 0.01 + 0.005
    return x, w, a_s, a_b, ws


def check_batched_fwd(torch, timer, qmm, ref, e, m, k, n, gen, qs,
                      x_dtype=None) -> dict:
    """quant_matmul_batched (the tensor-core path) against its plain
    version, with check_qat_fwd's bars; and experts 0 and E-1 bit-equal to
    quant_matmul on their slices."""
    x, w, a_s, a_b, ws = batched_operands(torch, e, m, k, n, gen, qs, x_dtype)
    args = (x, w, a_s, a_b, ws)
    kern = lambda: qmm.quant_matmul_batched(*args, **qs)
    plain = lambda: ref.quant_matmul_batched(*args, **qs)
    y_k, y_r = kern(), plain()
    again = kern()
    ends = sorted({0, e - 1})
    per_expert = [qmm.quant_matmul(x[i], w[i], a_s[i, 0], a_b[i, 0], ws[i:i + 1], **qs)
                  for i in ends]
    torch.cuda.synchronize()
    repeat = _same_bits(torch, y_k, again)
    as_2d = all(_same_bits(torch, y_k[i], y2) for i, y2 in zip(ends, per_expert))
    del again, per_expert
    err = (y_k - y_r).abs().max().item()
    tol = 1e-5 * y_r.abs().max().item()
    s_a, b_a, s_w = ref._expert_scales(a_s, a_b, ws)
    xd = ref._act_codes(x, s_a, b_a, qs["q_n_a"], qs["q_p_a"])[2]
    wd = ref._weight_codes(w, s_w, qs["q_n_w"], qs["q_p_w"])[2]
    excess = _order_excess(torch, y_k, y_r, xd, wd, k)
    del y_k, y_r
    same, prologue_ms, _ = check_prologue(torch, timer, qmm, ref, args, qs)
    xd, wd = xd.to(torch.bfloat16), wd.to(torch.bfloat16)
    lib = lambda: torch.bmm(xd, wd)
    checks = [("max|err|", err <= tol, f"{err:.3e}, tol {tol:.3e}"),
              ("order", excess <= 0, f"excess {excess:.2e}"),
              ("repeat", repeat, "same bits on a second launch"),
              ("prologue", same, "bit-equal to the plain dequantization"),
              ("per-expert", as_2d, f"experts {ends} bit-equal to quant_matmul")]
    nbytes = e * (m * k * x.element_size() + k * n * 4 + 8 + n * 4 + m * n * 4)
    b_ms, b_by = bound(nbytes, 2.0 * e * m * k * n)
    row = {"shape": [e, m, k, n], "x": str(x.dtype)[6:], "path": "tc",
           "max_abs_err": err, "tol": tol, "order_excess": excess,
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "prologue_ms": prologue_ms}
    log(f"  quant_matmul_batched [tc] E={e} M={m} K={k} N={n} ({row['x']} x): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, prologue {prologue_ms:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.bmm(bf16 dequant) "
        f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"quant_matmul_batched {e}x{m}x{k}x{n} disagrees with its plain "
             f"version on {bad}")
    return row


def check_batched_bwd(torch, timer, qmm, ref, e, m, k, n, gen, qs,
                      x_dtype=None, round_cot=True) -> dict:
    """quant_matmul_bwd_batched against its plain version, with the bars of
    check_qat_bwd per expert; the path is `bwd_route` on the per-expert
    shape (the tensor cores for bf16 cotangents, the SIMT tile for f32
    ones, or split expert by expert through the split dx / dw grids on the
    tensor cores past the reference's scratch budget). A second launch
    gives the same bits; experts 0 and E-1 are bit-equal, in all five
    outputs, to quant_matmul_bwd on their slices; on the tensor cores (tc
    and split) the prologue alone is bit-equal to the plain dequantization,
    and dws may differ from the plain dws by 1e-4 x sum|summands| plus what
    its differing summands account for (below)."""
    x, w, a_s, a_b, ws = batched_operands(torch, e, m, k, n, gen, qs, x_dtype)
    dy = torch.randn((e, m, n), generator=gen, device="cuda")
    path = qmm.bwd_route(m, k, n, round_cot)
    kw = dict(round_cot=round_cot, **qs)
    args = (dy, x, w, a_s, a_b, ws)
    kern = lambda: qmm.quant_matmul_bwd_batched(*args, **kw)
    plain = lambda: ref.quant_matmul_bwd_batched(*args, **kw)
    got, want = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    checks = [("repeat", all(_same_bits(torch, a, b) for a, b in zip(got, again)),
               "same bits on a second launch")]
    del again
    ends = sorted({0, e - 1})
    as_2d = True
    for i in ends:
        two_d = qmm.quant_matmul_bwd(dy[i], x[i], w[i], a_s[i, 0], a_b[i, 0],
                                     ws[i:i + 1], **kw)
        mine = (got[0][i], got[1][i, 0], got[2][i, 0], got[3][i], got[4][i:i + 1])
        as_2d = as_2d and all(_same_bits(torch, a, b) for a, b in zip(mine, two_d))
        del two_d
    checks.append(("per-expert", as_2d,
                   f"experts {ends} bit-equal to quant_matmul_bwd in all five"))
    tensor_cores = path in ("tc", "split")  # the split route: the 2D split grids
    prologue_ms = None
    if tensor_cores:
        same, prologue_ms, _ = check_prologue(torch, timer, qmm, ref, args, qs,
                                              qmm.plane_count(round_cot))
        checks.append(("prologue", same, "bit-equal to the plain dequantization"))
    s_a, b_a, s_w = ref._expert_scales(a_s, a_b, ws)
    u, q, xd = ref._act_codes(x, s_a, b_a, qs["q_n_a"], qs["q_p_a"])
    uw, qw, wd = ref._weight_codes(w, s_w, qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(dy, round_cot)
    ex_x, fr_x = _bf16_close(torch, got[0], want[0],
                             cot.abs() @ wd.abs().transpose(1, 2), n)
    dw_abs = xd.abs().transpose(1, 2) @ cot.abs()
    ex_w, fr_w = _bf16_close(torch, got[3], want[3], dw_abs, m)
    dxd = ref._bf16(cot @ wd.transpose(1, 2))
    mf = ref._in_range(u, qs["q_n_a"], qs["q_p_a"])
    l1a = (dxd * (q - mf * u)).abs().sum(dim=(1, 2)).reshape(e, 1)
    l1b = (dxd * (1 - mf)).abs().sum(dim=(1, 2)).reshape(e, 1)
    del dxd, mf
    dwd = ref._bf16(xd.transpose(1, 2) @ cot)
    fac = (qw - ref._in_range(uw, qs["q_n_w"], qs["q_p_w"]) * uw).abs()
    l1w = (dwd.abs() * fac).sum(dim=1)
    flips = torch.zeros_like(l1w)
    summand_checks = []
    if tensor_cores:
        # dws sums the summands bf16(xd^T dY) x (q - mf u) over K. The tile's
        # f32 order rounds some of bf16(xd^T dY) to the other bf16 neighbour
        # of the plain version's (the dW bar allows that), and at clipped
        # weights (|q - mf u| up to 4) one such flip can move a K = 512
        # column's dws past 1e-4 x sum|summands|. So each column's allowance
        # adds, to that, |its kernel summand - the plain one| x |q - mf u|
        # summed over the summands that differ. The kernel's summands come
        # from a launch with w = 0 (every code in range, so dW is
        # bf16(xd^T dY) on every element): they must be the real launch's dW
        # wherever w is in range, and meet the dW bar against the plain ones
        # on every element, clipped ones included.
        dwd_k = qmm.quant_matmul_bwd_batched(dy, x, torch.zeros_like(w), a_s, a_b,
                                             ws, **kw)[3]
        mfw = ref._in_range(uw, qs["q_n_w"], qs["q_p_w"])
        real = bool(torch.equal(got[3], dwd_k * mfw))
        ex_d, fr_d = _bf16_close(torch, dwd_k, dwd, dw_abs, m)
        flips = ((dwd_k - dwd).abs() * fac).sum(dim=1)
        summand_checks = [
            ("summands", real, "the w = 0 launch's bf16(xd^T dY) is the real dW where in range"),
            ("xd^T dY", ex_d <= 0 and fr_d <= 0.01,
             f"every element: excess {ex_d:.2e}, differing {fr_d:.2e}")]
        del dwd_k, mfw
    del dw_abs, dwd, fac
    gap = (got[4] - want[4]).abs()
    allowed = 1e-4 * l1w + flips
    dws_ok = bool((gap <= allowed).all())
    vs_plain = (gap / l1w.clamp_min(1e-30)).max().item()
    flip_cols = int((gap > 1e-4 * l1w).sum().item())
    use = (gap / allowed.clamp_min(1e-30)).max().item()
    del l1w, flips, allowed
    checks += [("dX", ex_x <= 0 and fr_x <= 0.01, f"excess {ex_x:.2e}, differing {fr_x:.2e}"),
               ("dsa", bool(((got[1] - want[1]).abs() <= 1e-4 * l1a).all()),
                f"max {(got[1] - want[1]).abs().max().item():.3e}"),
               ("dba", bool(((got[2] - want[2]).abs() <= 1e-4 * l1b).all()),
                f"max {(got[2] - want[2]).abs().max().item():.3e}"),
               ("dW", ex_w <= 0 and fr_w <= 0.01, f"excess {ex_w:.2e}, differing {fr_w:.2e}"),
               *summand_checks,
               ("dws", dws_ok, f"max {vs_plain:.3e} x sum|summands| from the plain dws, "
                f"{use:.3f} of the allowance; {flip_cols} columns past 1e-4 x sum|summands|")]
    worst = max((got[0] - want[0]).abs().max().item(),
                (got[3] - want[3]).abs().max().item())
    del got, want
    # yardstick: the two products on operands dequantized beforehand
    lt = torch.bfloat16 if round_cot else torch.float32
    ct, xl, wl = cot.to(lt), xd.to(lt), wd.to(lt)
    lib = lambda: (torch.bmm(ct, wl.transpose(1, 2)), torch.bmm(xl.transpose(1, 2), ct))
    nbytes = e * (m * n * 4 + m * k * x.element_size() + k * n * 4 + 8 + n * 4
                  + m * k * 4 + 8 + k * n * 4 + n * 4)
    b_ms, b_by = bound(nbytes, 4.0 * e * m * k * n,
                       BF16_OPS_PER_S if round_cot else F32_OPS_PER_S)
    row = {"shape": [e, m, k, n], "path": path, "x": str(x.dtype)[6:],
           "round_cot": round_cot, "max_abs_err": worst,
           "tol": "bf16 ulp + f32 order bound; sums 1e-4 x sum|summands| per expert "
                  "(tc dws: + the differing summands x |q - mf u|)",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by,
           "prologue_ms": prologue_ms, "dws_vs_plain": vs_plain,
           "dws_allowance_used": use, "dws_flip_cols": flip_cols}
    pro = "" if prologue_ms is None else f", prologue {prologue_ms:.4f} ms"
    log(f"  quant_matmul_bwd_batched [{path}] E={e} M={m} K={k} N={n} ({row['x']} x, "
        f"{'bf16' if round_cot else 'f32'} cotangents): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms{pro}, plain {row['plain_ms']:.4f} ms, "
        f"torch.bmm(dequant) {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"quant_matmul_bwd_batched {e}x{m}x{k}x{n} disagrees with its "
             f"plain version on {bad}")
    return row


# ---------------------------------------------------------------------------
# phases 6-7: QAT training
# ---------------------------------------------------------------------------

QAT_KERNELS = ("quant_matmul", "quant_matmul_bwd", "quant_matmul_dx",
               "quant_matmul_dw", "quant_matmul_batched",
               "quant_matmul_bwd_batched")


def qat_linears(cfg, qcfg, tokens: int) -> list:
    """Every linear of a train step that takes the QAT kernels, as
    (name, count in the model, M, K, N, f32 cotangent, batched, remat):
    a block linear whose kind quantizes both its input and its weight (not
    at 1 bit), with its (K, N) from the config (wq / wk / wv, wo, the dense
    FFN's, an MoE FFN's expert linears at the per-expert capacity rows; the
    router stays on the f32 einsum), and the head (untied, or tied as the
    transposed per-tensor embedding). Block linears run their forward twice
    (remat recomputes the block in the backward); the head once."""
    from repro_torch.core.policy import act_spec, weight_spec
    from repro_torch.models.common import NAME2KIND
    from repro_torch.models.moe import capacity

    def fused(name, wname=None):
        a, w = act_spec(qcfg, NAME2KIND[name]), weight_spec(qcfg, NAME2KIND[wname or name])
        return a is not None and w is not None and a.bits != 1 and w.bits != 1

    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    moe = sum(cfg.block_at(i).ffn == "moe" for i in range(cfg.n_layers))
    dense = cfg.n_layers - moe
    out = []
    for name, k, n in (("wq", d, h * hd), ("wk", d, hkv * hd), ("wv", d, hkv * hd),
                       ("wo", h * hd, d)):
        if fused(name):
            out.append((name, cfg.n_layers, tokens, k, n, False, False, True))
    ffn = (("w_gate", d, f),) if cfg.ffn_gated else ()
    ffn += (("w_in", d, f), ("w_out", f, d))
    for name, k, n in ffn:
        if dense and fused(name):
            out.append((name, dense, tokens, k, n, False, False, True))
        moe_name = {"w_gate": "moe_gate", "w_in": "moe_in", "w_out": "moe_out"}[name]
        if moe and fused(moe_name):
            groups = cfg.moe_dispatch_groups
            rows = groups * capacity(tokens // groups, cfg)
            out.append((moe_name, moe, rows, k, n, False, True, True))
    tied_ok = (cfg.tie_embeddings and fused("lm_head", "embed")
               and weight_spec(qcfg, "embed").granularity == "per_tensor")
    if tied_ok or (not cfg.tie_embeddings and fused("lm_head")):
        out.append(("lm_head", 1, tokens, d, cfg.padded_vocab, True, False, False))
    return out


def qat_launches_per_step(cfg, qcfg, tokens: int) -> dict:
    """Launches a train step makes, from `qat_linears`: each linear's
    forward (twice for a block linear), and its backward on the route the
    dispatcher takes (`quant_matmul.bwd_route` on the padded shape, the
    per-expert shape for the batched kernels): the combined backward once
    ("tc" for bf16 cotangents, "simt" for the head's f32 ones), or, past
    the reference's scratch budget, the split dx / dw once each (expert by
    expert for the batched kernels)."""
    from repro_torch.kernels.quant_matmul import bwd_route
    c = dict.fromkeys(QAT_KERNELS, 0)
    for _, count, m, k, n, f32_cot, batched, remat in qat_linears(cfg, qcfg, tokens):
        e = cfg.n_experts if batched else 1
        c["quant_matmul_batched" if batched else "quant_matmul"] += count * (2 if remat else 1)
        if bwd_route(m, k, n, not f32_cot) == "split":
            c["quant_matmul_dx"] += count * e
            c["quant_matmul_dw"] += count * e
        else:
            c["quant_matmul_bwd_batched" if batched else "quant_matmul_bwd"] += count
    return c


def formula(cfg, qcfg, tokens: int) -> str:
    """`qat_launches_per_step`'s terms: each linear, its count, its
    forwards and its backward route."""
    from repro_torch.kernels.quant_matmul import bwd_route
    parts = []
    for name, count, m, k, n, f32_cot, batched, remat in qat_linears(cfg, qcfg, tokens):
        route = bwd_route(m, k, n, not f32_cot)
        route += " (3 planes)" if route == "split" and f32_cot else (
            " (1 plane)" if route == "split" else "")
        each = f" x {cfg.n_experts} experts" if batched and route.startswith("split") else ""
        parts.append(f"{name} ({m}, {k}, {n}) x {count}: fwd {2 if remat else 1}, "
                     f"bwd {route}{each}")
    return "; ".join(parts)


def train_phase(torch, ops, train, argv: list, expect_start: int,
                steps: int) -> dict:
    log(f"train: python -m repro_torch.launch.train {' '.join(argv)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ops.launch_counts()[k] for k in QAT_KERNELS}
    tokens = int(argv[argv.index("--batch") + 1]) * int(argv[argv.index("--seq") + 1])
    steady = rep.step_seconds[1:] or rep.step_seconds
    s_step = statistics.median(steady)
    log(f"  wall {wall:.1f} s (params built on the card included), steps "
        f"{rep.start_step}..{rep.final_step}, s/step {[round(v, 3) for v in rep.step_seconds]}"
        f" (median after the first {s_step:.3f} s, {tokens / s_step:.0f} tokens/s), "
        f"losses {rep.losses}, health {rep.healths}, peak "
        f"{(rep.peak_bytes or 0) / 2**30:.2f} GiB; launches {counts}")
    if rep.start_step != expect_start or rep.steps_run != steps:
        fail(f"train run started at {rep.start_step} and ran {rep.steps_run} "
             f"steps; expected {expect_start} and {steps}")
    if not all(map(lambda v: v == v and abs(v) < float("inf"), rep.losses)):
        fail(f"non-finite training loss: {rep.losses}")
    if any(rep.healths) or len(rep.healths) != steps:
        fail(f"sentinel health bits set: {rep.healths}")
    return {"report": rep, "counts": counts, "wall": wall, "s_step": s_step,
            "tokens_s": tokens / s_step}


def route_check(torch, arch: str = "qwen1.5-0.5b", quant: str = "w4a4",
                gen_seed: int = 0) -> dict:
    """Gradients of full-width `arch` cut to 2 layers (batch 2 x 256, one
    step from init) on the kernel route against the unfused composition,
    both on the card: loss within 1e-3 relative, every non-scalar gradient
    leaf within 1e-2 relative L2, the scalar quantizer leaves pooled per
    kind (a single near-zero scalar's relative error means little). For an
    MoE model, also the share of (token, slot) expert choices that differ
    between the routes (the router is an f32 einsum on both, fed by
    activations that may differ in an ulp: a top-k flip is a discontinuity,
    reported, not hidden). The bar is held with the kernels' rule at the
    clip edge on both routes (see below): the router, unfused on both,
    sees exact zeros at init too (the embedding's code-0 entries), and must
    take one rule on both.

    At init the forward is exact on both routes (scales 1, offsets 0:
    integer codes times bf16 weights sum without rounding), so the routes
    differ only where a quantizer input sits exactly on the clip edge
    u = -Q_N (the 8-bit embedding's code-0 zeros, silu underflow): there the
    reference's kernels pass the whole gradient and its unfused clip half
    (PERF.md, ROADMAP Queue 3). The bar is held against the unfused route
    run with the kernels' edge rule (torch.clamp: same forward, whole
    gradient at the edge); the gaps against the unfused route as it is are
    printed beside it."""
    import numpy as np
    from repro_torch import tree as T
    from repro_torch.configs.registry import get_config
    from repro_torch.core import quantizer
    from repro_torch.core.policy import get_preset
    from repro_torch.data.mckd_store import synthetic_kd_labels
    from repro_torch.data.synthetic import DataConfig, sample_batch
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig, init_state
    from repro_torch.train.train_step import make_grad_fn
    from repro_torch.models import moe
    cfg = get_config(arch).replace(n_layers=2)
    qcfg = get_preset(quant)
    tcfg = TrainConfig(total_steps=10, warmup_steps=0, kd="mckd",
                       sentinel=SentinelConfig())
    state = init_state(cfg, qcfg, tcfg,
                       torch.Generator(device="cuda").manual_seed(gen_seed), "cuda")
    b = sample_batch(cfg, DataConfig(), 0, 2, 256)
    b["kd_idx"], b["kd_p"] = synthetic_kd_labels(b["labels"], cfg.vocab_size, 16, seed=0)
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in b.items()}

    choices = {}

    def grads(route, clip=None):
        orig, orig_route = quantizer._clip, moe._route_group
        seen = choices.setdefault((route, clip is not None), [])

        def recording(xt, exp_idx, *a):
            seen.append(exp_idx.detach().clone())
            return orig_route(xt, exp_idx, *a)

        if clip is not None:
            quantizer._clip = clip
        moe._route_group = recording
        try:
            loss, _, g = make_grad_fn(cfg, qcfg.replace(fused_matmul=route), tcfg)(
                state["params"], b, state["step"])
        finally:
            quantizer._clip, moe._route_group = orig, orig_route
        return loss.item(), {T.path_str(p): v for p, v in T.flatten(g)}

    def gaps(a, o):
        res, pools = {}, {k: ([], []) for k in ("w_scale", "a_scale", "a_offset")}
        for k, go in o[1].items():
            ga = a[1][k]
            kind = k.rsplit("/", 1)[-1]
            if kind in pools and go.numel() == 1:
                pools[kind][0].append(ga.reshape(()))
                pools[kind][1].append(go.reshape(()))
                continue
            res[k] = ((ga - go).norm() / go.norm().clamp_min(1e-30)).item()
        for kind, (x, y) in pools.items():
            x, y = torch.stack(x), torch.stack(y)
            res["pooled " + kind] = ((x - y).norm() / y.norm().clamp_min(1e-30)).item()
        top = sorted(res.items(), key=lambda kv: -kv[1])[:5]
        return abs(a[0] - o[0]) / abs(o[0]), [(k, round(v, 7)) for k, v in top]

    # the edge rule on both routes: a linear that is unfused on both (the
    # MoE router) then keeps one rule, and only the kernels' linears differ
    d_edge, top_edge = gaps(grads("auto", torch.clamp), grads("off", torch.clamp))
    d_raw, top_raw = gaps(grads("auto"), grads("off"))
    flips = None
    if choices[("auto", True)]:
        a, o = choices[("auto", True)], choices[("off", True)]
        if len(a) != len(o):
            fail(f"routes routed {len(a)} and {len(o)} times")
        flips = (sum(int((x != y).sum()) for x, y in zip(a, o))
                 / sum(x.numel() for x in a))
    log(f"route check ({cfg.name}, {quant}): kernel route vs unfused (kernels' "
        f"edge rule): loss gap {d_edge:.3e} (bar 1e-3), worst leaves {top_edge} "
        f"(bar 1e-2)" + ("" if flips is None else
                         f"; expert choices that differ {flips:.3e}"))
    log(f"  vs unfused as it is (clip splits the gradient at the edge): loss "
        f"gap {d_raw:.3e}, worst leaves {top_raw}")
    if not (d_edge <= 1e-3 and top_edge[0][1] <= 1e-2):
        fail(f"kernel route departs from the unfused route: loss {d_edge}, {top_edge[0]}")
    return {"edge_rule": {"loss": d_edge, "worst": top_edge},
            "as_is": {"loss": d_raw, "worst": top_raw}, "choice_flips": flips}


def training_run(torch, ops, cfg, qcfg, *, batch: int, seq: int, steps: int,
                 tag: str, strict_health: bool) -> dict:
    """`run_training` on the card with the launch counts set to 0 just
    before and read just after: MCKD top-16, sentinel on, seed 0, the CLI's
    optimizer settings, no checkpoint written (save_every beyond the run).
    Finite losses; health 0 every step (strict_health) or no fatal bit;
    with OBR on, obr_lambda 0 at step 0 and > 0 after and loss_obr > 0;
    with oscillation tracked, osc_frac every step."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig
    import shutil
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, kd="mckd", kd_topk=16,
                       adamw=AdamWConfig(lr_peak=3e-3), sentinel=SentinelConfig())
    ckpt_dir = ROOT / "build" / f"chip_smoke_{tag}_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"train: run_training({cfg.name}, {cfg.n_layers} layers, "
        f"w{qcfg.w_bits}a{qcfg.a_bits}{' + OBR' if qcfg.obr_lambda else ''}"
        f"{', track_oscillation' if qcfg.track_oscillation else ''}, batch "
        f"{batch} x {seq}, {steps} steps)")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = train.run_training(cfg, qcfg, tcfg, DataConfig(seed=0), steps=steps,
                             batch_size=batch, seq_len=seq, ckpt_dir=str(ckpt_dir),
                             save_every=10 ** 6, log_every=1, seed=0,
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: ops.launch_counts()[k] for k in QAT_KERNELS}
    written = sorted(p.name for p in ckpt_dir.glob("*")) if ckpt_dir.exists() else []
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    steady = rep.step_seconds[1:] or rep.step_seconds
    s_step = statistics.median(steady)
    log(f"  wall {wall:.1f} s (params built on the card included), s/step "
        f"{[round(v, 3) for v in rep.step_seconds]} (median after the first "
        f"{s_step:.3f} s, {batch * seq / s_step:.0f} tokens/s), losses {rep.losses}, "
        f"health {rep.healths}, peak {(rep.peak_bytes or 0) / 2**30:.2f} GiB, "
        f"checkpoint files {written}")
    for i, mm in enumerate(rep.metrics):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in mm.items()))
    if rep.steps_run != steps or len(rep.healths) != steps:
        fail(f"{cfg.name} train run ran {rep.steps_run} steps; expected {steps}")
    if not all(v == v and abs(v) < float("inf") for v in rep.losses):
        fail(f"non-finite {cfg.name} training loss: {rep.losses}")
    bad = [h for h in rep.healths if (h if strict_health
                                      else h & SentinelConfig().fatal_bits)]
    if bad:
        fail(f"sentinel health bits in the {cfg.name} run: {rep.healths}")
    if qcfg.obr_lambda > 0:
        lams = [mm["obr_lambda"] for mm in rep.metrics]
        if lams[0] != 0.0 or not all(v > 0 for v in lams[1:]):
            fail(f"obr_lambda should be 0 at step 0 and > 0 after: {lams}")
        if not all(mm["loss_obr"] > 0 for mm in rep.metrics):
            fail(f"OBR metrics missing: {rep.metrics}")
    if qcfg.track_oscillation and not all("osc_frac" in mm for mm in rep.metrics):
        fail(f"oscillation metrics missing: {rep.metrics}")
    return {"report": rep, "counts": counts, "wall": wall, "s_step": s_step,
            "tokens_s": batch * seq / s_step, "cfg": cfg, "qcfg": qcfg}


def moe_train_phase(torch, ops, steps: int = 3) -> dict:
    """The MoE training path through `run_training` (the CLI has no flag for
    oscillation tracking, as in the reference): full-width 24-layer
    granite-moe-1b-a400m, w3a3 (OBR lambda 0.1 on a cosine ramp over the
    run), track_oscillation, batch 8 x 512 (`training_run`; no checkpoint:
    the full state with its oscillation state is ~24 GB)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    return training_run(torch, ops, get_config("granite-moe-1b-a400m"),
                        get_preset("w3a3").replace(track_oscillation=True),
                        batch=8, seq=512, steps=steps, tag="moe",
                        strict_health=False)


def check_launches(run: dict, steps: int, tokens: int,
                   every_kernel: bool = False) -> dict:
    """A run's QAT launches equal `qat_launches_per_step` x steps (and,
    with every_kernel, each QAT kernel was launched)."""
    per_step = qat_launches_per_step(run["cfg"], run["qcfg"], tokens)
    want = {k: v * steps for k, v in per_step.items()}
    log(f"  launches {run['counts']}; per step {per_step} "
        f"({formula(run['cfg'], run['qcfg'], tokens)}) x {steps} steps = {want}")
    if (run["counts"] != want or not any(want.values())
            or (every_kernel and not all(want.values()))):
        fail(f"{run['cfg'].name} QAT launches {run['counts']} != {per_step} "
             f"per step x {steps}")
    return per_step


# ---------------------------------------------------------------------------
# phase 14: the MCKD store on the card
# ---------------------------------------------------------------------------

def mckd_store_phase(torch) -> dict:
    """Full-width paper-bert-base's fp teacher (random, seed 0) builds one
    MCKD shard: 2 batches of 8 x 256 tokens, 4 window_crop views of 128
    each, top-16 labels. iter_shard reads every item back bit for bit
    against the labels of the teacher's logits as it built them; then one
    make_train_step step (w2a2, MCKD from the shard's first item, no
    teacher in the loop) gives a finite loss and health 0."""
    import numpy as np
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.core.kd import make_topk_labels
    from repro_torch.core.policy import QuantConfig, get_preset
    from repro_torch.data.mckd_store import MCKDStore, window_crop
    from repro_torch.data.synthetic import DataConfig, sample_batch
    from repro_torch.models import model as M
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig, init_state
    from repro_torch.train.train_step import make_train_step
    cfg, fp = get_config("paper-bert-base"), QuantConfig(mode="off")
    root = ROOT / "build" / "chip_smoke_mckd"
    shutil.rmtree(root, ignore_errors=True)
    t_params = M.init_params(cfg, fp, torch.Generator(device="cuda").manual_seed(0), "cuda")
    built = []

    @torch.no_grad()
    def teacher_apply(view):
        b = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in view.items()}
        logits = M.forward(t_params, b, cfg, fp)[0]
        built.append([t.cpu().numpy() for t in make_topk_labels(logits, 16)])
        return logits

    store = MCKDStore(str(root), k=16, n_crops=4)
    batches = [sample_batch(cfg, DataConfig(), i, 8, 256) for i in range(2)]
    t0 = time.perf_counter()
    store.build_shard(0, teacher_apply, batches, lambda b, m: window_crop(b, m, 128))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    items = list(store.iter_shard(0))
    same = len(items) == len(built) == 8 and all(
        np.array_equal(it["kd_idx"], ki) and np.array_equal(
            it["kd_p"].view(np.int32), kp.view(np.int32))
        for it, (ki, kp) in zip(items, built))
    del t_params
    qcfg = get_preset("w2a2")
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, kd="mckd", kd_topk=16,
                       sentinel=SentinelConfig())
    state = init_state(cfg, qcfg, tcfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    _, m = make_train_step(cfg, qcfg, tcfg)(
        state, {k: torch.from_numpy(v).cuda() for k, v in items[0].items()})
    loss, health = float(m["loss"]), int(m["health"])
    shutil.rmtree(root, ignore_errors=True)
    log(f"mckd store: {cfg.name} fp teacher, 2 batches x 4 views of 8 x 128, "
        f"top-16: built in {build_s:.2f} s, {len(items)} items read back bit for bit: "
        f"{same}; one w2a2 MCKD step from the shard: loss {loss:.4f}, health {health}")
    if not same:
        fail("MCKD store: the shard read back differs from the labels built")
    if not (loss == loss and abs(loss) < float("inf")) or health:
        fail(f"MCKD step from the store: loss {loss}, health {health}")
    return {"items": len(items), "bit_equal": same, "build_s": build_s,
            "loss": loss, "health": health}


# ---------------------------------------------------------------------------
# phase 15: the paper-table twins
# ---------------------------------------------------------------------------

TABLES = ("table1_sensitivity", "table2_sdam", "table4_qat", "table5_kd",
          "table7_oscillation")
TABLE_STEPS = 20


def tables_phase(torch) -> dict:
    """Each paper-table twin at its reference size (reduced 2-layer
    qwen1.5-0.5b, batch 16 x 16) with its step count cut to TABLE_STEPS;
    prints its rows, every value finite."""
    import importlib
    import math
    out = {}
    for name in TABLES:
        mod = importlib.import_module(f"repro_torch.tables.{name}")
        t0 = time.perf_counter()
        rows = mod.run(steps=TABLE_STEPS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flat = (rows.items() if isinstance(rows, dict) else
                [(r[0] if len(r) == 3 else f"{r[0]} {r[1]}-bit", r[-2:]) for r in rows])
        log(f"table {name}: {TABLE_STEPS} steps a run, {wall:.1f} s")
        vals = []
        for key, v in flat:
            if isinstance(v, dict):
                vals += list(v.values())
                txt = ", ".join(f"{k} {x:.4g}" for k, x in v.items())
            elif isinstance(v, float):
                vals.append(v)
                txt = f"SDAM {v:.4e}"
            else:
                vals += list(v)
                txt = f"eval CE {v[0]:.4f}, acc {v[1]:.4f}"
            log(f"  {key}: {txt}")
        if not all(isinstance(x, float) and math.isfinite(x) for x in vals):
            fail(f"{name}: a value is not finite: {rows}")
        out[name] = {"steps": TABLE_STEPS, "wall_s": wall, "rows": rows}
    return out

# ---------------------------------------------------------------------------
# phase 10: the quantizer kernels (fake_quant_2d, fake_quant_rows,
# bin_stats_2d) and the kernel benchmark, their entry point
# ---------------------------------------------------------------------------

def _operand(torch, shape, dtype, std, gen, misaligned: bool):
    """randn * std on the card in `dtype`; misaligned: a contiguous view
    that starts one element past an aligned allocation (the kernels' scalar,
    unvectorised path)."""
    n = 1
    for d in shape:
        n *= d
    base = (torch.randn((n + 1,), generator=gen, device="cuda") * std).to(dtype)
    return base[1:].reshape(shape) if misaligned else base[:n].reshape(shape)


def check_fake_quant(torch, timer, fq, ref, label, shape, dtype, q_n, q_p,
                     gen, *, std=1.0, scale=None, offset=None,
                     misaligned=False) -> dict:
    """fake_quant_2d against its plain version: bit for bit. scale None =
    the LSQ init 2 mean|x| / sqrt(Q_P), computed on the card."""
    x = _operand(torch, shape, dtype, std, gen, misaligned)
    s = (2 * x.float().abs().mean() / q_p ** 0.5 if scale is None
         else torch.tensor(scale, device="cuda"))
    b = None if offset is None else torch.tensor(offset, device="cuda")
    kern = lambda: fq.fake_quant_2d(x, s, b, q_n=q_n, q_p=q_p)
    plain = lambda: ref.fake_quant_2d(x, s, b, q_n=q_n, q_p=q_p)
    y_k, y_r = kern(), plain()
    torch.cuda.synchronize()
    same = _same_bits(torch, y_k, y_r)
    err = (y_k.float() - y_r.float()).abs().max().item()
    nbytes = 2 * x.numel() * x.element_size() + 4 + (0 if b is None else 4)
    b_ms, b_by = bound(nbytes, 5.0 * x.numel(), F32_OPS_PER_S)
    lib_ms = None
    if dtype == torch.float32:  # offset 0; multiplies by 1/s: not bit-equal
        zp = torch.zeros((1,), dtype=torch.int32, device="cuda")
        sv = s.reshape(1)
        lib_ms = timer.ms(lambda: torch.fake_quantize_per_tensor_affine(
            x, sv, zp, -q_n, q_p))
    row = {"shape": list(shape), "case": label, "max_abs_err": err,
           "tol": "bit-equal", "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    lib = "n/a (bf16)" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  fake_quant_2d {label} {tuple(shape)} {str(dtype)[6:]} Q_N={q_n} "
        f"Q_P={q_p}{' offset' if b is not None else ''}"
        f"{' misaligned' if misaligned else ''}: bit-equal {same} (max|err| "
        f"{err:.3e}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
        f"ms, fake_quantize_per_tensor_affine {lib}, bound {b_ms:.4f} ms ({b_by})")
    if not same:
        fail(f"fake_quant_2d {label} {shape} differs from its plain version")
    return row


def check_fake_quant_rows(torch, timer, fq, ref, label, shape, dtype, q_n,
                          q_p, gen, *, std=1.0, misaligned=False) -> dict:
    """fake_quant_rows (one scale a row, the LSQ init of each row) against
    its plain version: bit for bit."""
    x = _operand(torch, shape, dtype, std, gen, misaligned)
    rs = 2 * x.float().abs().mean(dim=1, keepdim=True) / q_p ** 0.5
    kern = lambda: fq.fake_quant_rows(x, rs, q_n=q_n, q_p=q_p)
    plain = lambda: ref.fake_quant_rows(x, rs, q_n=q_n, q_p=q_p)
    y_k, y_r = kern(), plain()
    torch.cuda.synchronize()
    same = _same_bits(torch, y_k, y_r)
    err = (y_k.float() - y_r.float()).abs().max().item()
    nbytes = 2 * x.numel() * x.element_size() + 4 * shape[0]
    b_ms, b_by = bound(nbytes, 5.0 * x.numel(), F32_OPS_PER_S)
    lib_ms = None
    if dtype == torch.float32:
        zp = torch.zeros((shape[0],), dtype=torch.int32, device="cuda")
        sv = rs.reshape(-1)
        lib_ms = timer.ms(lambda: torch.fake_quantize_per_channel_affine(
            x, sv, zp, 0, -q_n, q_p))
    row = {"shape": list(shape), "case": label, "max_abs_err": err,
           "tol": "bit-equal", "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    lib = "n/a (bf16)" if lib_ms is None else f"{lib_ms:.4f} ms"
    log(f"  fake_quant_rows {label} {tuple(shape)} {str(dtype)[6:]} Q_N={q_n} "
        f"Q_P={q_p}{' misaligned' if misaligned else ''}: bit-equal {same} "
        f"(max|err| {err:.3e}); kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, fake_quantize_per_channel_affine {lib}, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if not same:
        fail(f"fake_quant_rows {label} {shape} differs from its plain version")
    return row


def check_bin_stats(torch, timer, bs, ref, label, shape, q_n, q_p, gen, *,
                    misaligned=False) -> dict:
    """bin_stats_2d against its plain version: counts equal (both round an
    exact count once, exact below 2^24), summing to the element count in
    f64 (within the f32 rounding of counts past 2^24); sum and sum of
    squares within 1e-5 of each bin's sum of |summands|."""
    w = _operand(torch, shape, torch.float32, shape[-1] ** -0.5, gen, misaligned)
    s = 2 * w.abs().mean() / q_p ** 0.5
    kern = lambda: bs.bin_stats_2d(w, s, q_n=q_n, q_p=q_p)
    plain = lambda: ref.bin_stats_2d(w, s, q_n=q_n, q_p=q_p)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    n_bins = q_n + q_p + 1
    codes = (torch.clamp(torch.round(w.reshape(-1) / torch.clamp(s, min=1e-9)),
                         -q_n, q_p).to(torch.int64) + q_n)
    wd = w.reshape(-1).double()
    mag = torch.zeros((2, n_bins), dtype=torch.float64, device="cuda")
    mag[0].index_add_(0, codes, wd.abs())
    mag[1].index_add_(0, codes, wd * wd)
    del codes, wd
    counts_equal = torch.equal(got[0], want[0])
    slack = torch.where(got[0] >= 2 ** 24, got[0].abs() * 2.0 ** -24,
                        torch.zeros_like(got[0])).double().sum().item()
    count_gap = abs(got[0].double().sum().item() - w.numel())
    d = (got[1:].double() - want[1:].double()).abs()
    sums_ok = bool((d <= 1e-5 * mag).all())
    err = d.max().item()
    nbytes = w.numel() * 4 + 4 + 3 * n_bins * 4
    b_ms, b_by = bound(nbytes, 8.0 * w.numel(), F32_OPS_PER_S)
    row = {"shape": list(shape), "case": label, "bins": n_bins,
           "max_abs_err": err,
           "tol": "counts equal; sums 1e-5 x per-bin sum|summands|",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": None,
           "library": "none: no one PyTorch call gives per-bin count, sum "
                      "and sum of squares (histc counts only; bincount "
                      "needs the codes)",
           "bound_ms": b_ms, "bound_by": b_by,
           "device_kernels": device_kernels(torch, kern)}
    log(f"  bin_stats_2d {label} {tuple(shape)} bins={n_bins}"
        f"{' misaligned' if misaligned else ''}: counts equal {counts_equal}, "
        f"count sum - n {count_gap:.0f} (slack {slack:.0f}), sums within bar "
        f"{sums_ok} (max|err| {err:.3e}); kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library n/a, bound {b_ms:.4f} ms ({b_by}); "
        f"{', '.join(row['device_kernels'])}")
    if not (counts_equal and count_gap <= slack and sums_ok):
        fail(f"bin_stats_2d {label} {shape} disagrees with its plain version")
    return row


# bin_stats_2d's rows of phase 10 (`chip_compare.py` runs the same ones):
# (label, shape, Q_N, Q_P), options
BIN_STATS_ROWS = ((("kernel_bench wq", (4096, 1024), 8, 7), {}),
                  (("granite-8b w_in w4", (4096, 14336), 8, 7), {}),
                  (("granite-8b w_in w8", (4096, 14336), 128, 127), {}),
                  (("odd", (513, 7), 4, 3), {}), (("odd", (1000, 33), 2, 1), {}),
                  (("odd", (100, 33), 128, 127), {"misaligned": True}),
                  (("odd", (64, 64), 1, 1), {}))


def quantizer_kernel_checks(torch, timer, ops, ref, gen) -> tuple[dict, int]:
    """Kernels 10-12 at the kernel benchmark's own shape, at full-width
    tensors of the models the repo trains, and at odd edges. Returns the
    rows and fake_quant_rows' launches here (no entry point reaches it)."""
    from repro_torch.kernels import bin_stats as bs, fake_quant as fq
    log("quantizer kernels (each against its plain version on the card):")
    f32, bf16 = torch.float32, torch.bfloat16
    rows = {"fake_quant_2d": [], "fake_quant_rows": [], "bin_stats_2d": []}
    for args, kw in (
            (("kernel_bench wq", (4096, 1024), f32, 8, 7),
             dict(std=0.1, scale=0.05)),
            (("granite-8b w_in w4", (4096, 14336), f32, 8, 7),
             dict(std=4096 ** -0.5)),
            (("granite-8b w_in w8", (4096, 14336), f32, 128, 127),
             dict(std=4096 ** -0.5)),
            (("qwen1.5-0.5b ffn act a4", (4096, 2816), bf16, 0, 15),
             dict(std=2.0, scale=0.3, offset=-0.2)),
            (("odd", (300, 700), f32, 0, 3), dict(scale=0.1, offset=0.05)),
            (("odd", (257, 129), bf16, 128, 127), dict(scale=0.07)),
            (("odd", (1, 640), f32, 2, 1), dict(scale=0.07)),
            (("odd", (1, 1001), bf16, 0, 15),
             dict(scale=0.1, offset=0.03, misaligned=True)),
            (("odd", (37, 53), f32, 4, 3), dict(scale=0.2, misaligned=True))):
        rows["fake_quant_2d"].append(check_fake_quant(
            torch, timer, fq, ref, *args, gen, **kw))
    ops.reset_launch_counts()
    for args, kw in (
            (("granite-moe experts w3", (32, 1024 * 512), f32, 4, 3),
             dict(std=1024 ** -0.5)),
            (("odd", (6, 960), bf16, 8, 7), {}),
            (("odd", (5, 35), f32, 2, 1), {}),
            (("odd", (70000, 3), f32, 8, 7), {}),
            (("odd", (3, 129), f32, 8, 7), dict(misaligned=True))):
        rows["fake_quant_rows"].append(check_fake_quant_rows(
            torch, timer, fq, ref, *args, gen, **kw))
    rows_launches = ops.launch_counts()["fake_quant_rows"]
    for args, kw in BIN_STATS_ROWS:
        rows["bin_stats_2d"].append(check_bin_stats(
            torch, timer, bs, ref, *args, gen, **kw))
        torch.cuda.empty_cache()
    return rows, rows_launches


def kernel_bench_phase(torch, ops) -> tuple[dict, dict]:
    """`repro_torch.launch.kernel_bench` on the card: --smoke, then the
    full run, whose launches of kernels 10 and 12 must be > 0."""
    from repro_torch.launch import kernel_bench
    out = ROOT / "build"
    argv = ["--smoke", "--out", str(out / "kernel_bench_smoke.json")]
    log(f"kernel bench: python -m repro_torch.launch.kernel_bench {' '.join(argv)}")
    if kernel_bench.main(argv) != 0:
        fail("kernel_bench --smoke failed a gate")
    argv = ["--out", str(out / "kernel_bench.json")]
    log(f"kernel bench: python -m repro_torch.launch.kernel_bench {' '.join(argv)}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = kernel_bench.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    log(f"  wall {wall:.1f} s; launches {counts}")
    if rc != 0:
        fail("kernel_bench (full run) failed a gate")
    for name in ("fake_quant_2d", "bin_stats_2d"):
        if counts[name] <= 0:
            fail(f"{name} was never launched by the kernel benchmark: {counts}")
    res = json.loads((out / "kernel_bench.json").read_text())
    return counts, res


def _kernel_name(sym: str) -> str:
    """The innermost name of a mangled kernel symbol: its length-prefixed
    components read in turn (the anonymous namespace's, then the kernel's)."""
    name, i = sym, 3 if sym.startswith("_ZN") else 2
    while (found := re.match(r"\d+", sym[i:])):
        n, i = int(found.group()), i + found.end()
        name, i = sym[i:i + n], i + n
    return name


def main() -> None:
    t_start = time.perf_counter()
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the unfused route's bf16 products: one f32 sum rounded once, as in
    # the reference (cuBLAS may otherwise reduce split-K partials in bf16)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import build, decode_attention as da, ops, ref
    from repro_torch.kernels import quant_matmul as qmm
    dev_name = torch.cuda.get_device_name(0)
    log(f"device: {dev_name}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 1. build
    t0 = time.perf_counter()
    report = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, all sources in parallel")
    for name, r in report.items():
        log(f"  {name}: {r['seconds']:.1f} s")
        entry = ""
        for line in r["log"].splitlines():
            if "Compiling entry function" in line:
                sym = line.split("'")[1]
                args = (["bf16"] if "bfloat16" in sym else []) + [
                    ("false", "true")[int(v)] for v in re.findall(r"Lb([01])E", sym)] + \
                    re.findall(r"Li(\d+)E", sym)
                entry = (_kernel_name(sym) + (f"<{', '.join(args)}>" if args else "")
                         + ": ")
            elif "Used" in line or "spill" in line.lower() and "0 bytes spill" not in line:
                log(f"    {entry}{line.strip()}")

    # 2. kernels
    def phase_gen(phase: int):
        return torch.Generator(device="cuda").manual_seed(100 * SEED + phase)

    gen = phase_gen(2)
    timer = Timer(torch)
    log("kernels (each against its plain version on the card):")
    serving = serving_kernel_rows(torch, timer, qmm, da, ref, gen)
    rows = serving["rows"]
    log("kernels at musicgen-medium's serving shapes:")
    musicgen_kernel_rows(torch, timer, qmm, da, ref, gen, rows)

    # 5. the QAT kernels at the training path's shapes (qwen1.5-0.5b,
    #    M = 8 x 512 tokens)
    log("qat kernels (each against its plain version on the card):")
    gen = phase_gen(5)
    m = 8 * 512
    qat_rows = {name: [] for name in QAT_KERNELS}
    # quant_matmul at qwen's FFN (w_in, then the down projection), a K-side
    # wo and the tied head; granite-moe's attention linears (w3a3: wk / wv,
    # and wq / wo K-side) and its head (8 bits); odd and misaligned shapes
    # (one with f32 x)
    for mm, k, n, k_side, qs, xdt in (
            (m, 1024, 2816, False, QAT_QS, None), (m, 1024, 1024, True, QAT_QS, None),
            (m, 1024, 152064, False, HEAD_QS, None), (m, 2816, 1024, False, QAT_QS, None),
            (m, 1024, 512, False, MOE_QS, None), (m, 1024, 1024, True, MOE_QS, None),
            (m, 1024, 49408, False, HEAD_QS, None),
            (1000, 700, 300, False, QAT_QS, torch.float32),
            (257, 129, 65, True, QAT_QS, None), (m, 1000, 2817, False, QAT_QS, None)):
        qat_rows["quant_matmul"].append(check_qat_fwd(
            torch, timer, qmm, ref, mm, k, n, k_side, gen, qs, xdt))
        torch.cuda.empty_cache()
    for k, n in ((1024, 2816), (2816, 1024)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", m, k, n, False, True,
            gen, QAT_QS))
    qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
        torch, timer, qmm, ref, "quant_matmul_bwd", m, 1024, 1024, True, True,
        gen, QAT_QS))
    # granite-moe's attention linears (w3a3: wk / wv, and wq / wo K-side),
    # odd and misaligned shapes on the combined route (one with f32 x), and
    # the f32-cotangent form on the SIMT path
    for mm, k, n, k_side, qs, xdt in (
            (m, 1024, 512, False, MOE_QS, None), (m, 1024, 1024, True, MOE_QS, None),
            (1000, 700, 300, False, QAT_QS, torch.float32),
            (257, 129, 65, True, QAT_QS, None), (m, 1000, 2817, False, QAT_QS, None)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", mm, k, n, k_side, True,
            gen, qs, xdt))
    qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
        torch, timer, qmm, ref, "quant_matmul_bwd", m, 1024, 2816, False, False,
        gen, QAT_QS))
    paths = [r["path"] for r in qat_rows["quant_matmul_bwd"]]
    if paths != ["tc"] * 8 + ["simt"]:
        fail(f"quant_matmul_bwd took paths {paths}")
    # the split dx / dw on the tensor cores: the tied head (f32 cotangents,
    # three planes), the FFN's shape with bf16 cotangents (one plane, held
    # to quant_matmul_bwd's bits) and an odd K-side shape with f32 ones
    for name in ("quant_matmul_dx", "quant_matmul_dw"):
        for mm, k, n, k_side, round_cot, qs in (
                (m, 1024, 152064, False, False, HEAD_QS), (m, 1024, 2816, False, True, QAT_QS),
                (257, 129, 65, True, False, QAT_QS)):
            qat_rows[name].append(check_qat_bwd(
                torch, timer, qmm, ref, name, mm, k, n, k_side, round_cot, gen, qs))
            torch.cuda.empty_cache()
        if [r["path"] for r in qat_rows[name]] != ["tc"] * 3:
            fail(f"{name} took paths {[r['path'] for r in qat_rows[name]]}")
    edges = split_edges(torch, timer, qmm, ref, gen)
    torch.cuda.empty_cache()
    # the learned-position models' training shapes, after the rows above
    # (which keep their inputs): the forward at musicgen-medium's w_in and
    # head and at paper-bert-base's and paper-deit-t's heads; the f32 SIMT
    # backward's training path, musicgen-medium's and paper-deit-t's heads;
    # the split dx / dw at musicgen-medium's w_in, one plane (the split
    # route of a dense FFN), and at paper-bert-base's head, three planes
    log("qat kernels at musicgen-medium's, paper-bert-base's and paper-deit-t's shapes:")
    for mm, k, n, qs in ((m, 1536, 6144, QAT_QS), (m, 1536, 2048, HEAD_QS),
                         (32 * 128, 768, 30720, HEAD_QS), (64 * 197, 192, 1024, HEAD_QS)):
        qat_rows["quant_matmul"].append(check_qat_fwd(
            torch, timer, qmm, ref, mm, k, n, False, gen, qs))
        torch.cuda.empty_cache()
    for mm, k, n in ((m, 1536, 2048), (64 * 197, 192, 1024)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", mm, k, n, False, False,
            gen, HEAD_QS))
        torch.cuda.empty_cache()
    if [r["path"] for r in qat_rows["quant_matmul_bwd"][-2:]] != ["simt"] * 2:
        fail("the f32 heads' quant_matmul_bwd did not take the SIMT path")
    for name in ("quant_matmul_dx", "quant_matmul_dw"):
        for mm, k, n, round_cot, qs in ((m, 1536, 6144, True, QAT_QS),
                                        (32 * 128, 768, 30720, False, HEAD_QS)):
            if qmm.bwd_route(mm, k, n, round_cot) != "split":
                fail(f"({mm}, {k}, {n}) would not take the split route in training")
            qat_rows[name].append(check_qat_bwd(
                torch, timer, qmm, ref, name, mm, k, n, False, round_cot, gen, qs))
            torch.cuda.empty_cache()

    # the batched (MoE expert) kernels at granite-moe's training shapes: 32
    # experts x 1280 capacity rows (8 x 512 tokens, top 8, factor 1.25),
    # w3a3; and one shape past the combined route's budget (split route)
    log("moe kernels (each against its plain version on the card):")
    for name in ("quant_matmul_batched", "quant_matmul_bwd_batched"):
        qat_rows[name] = []
    for k, n in ((1024, 512), (512, 1024)):
        qat_rows["quant_matmul_batched"].append(check_batched_fwd(
            torch, timer, qmm, ref, 32, 1280, k, n, gen, MOE_QS))
        qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
            torch, timer, qmm, ref, 32, 1280, k, n, gen, MOE_QS))
        torch.cuda.empty_cache()
    qat_rows["quant_matmul_batched"].append(check_batched_fwd(
        torch, timer, qmm, ref, 3, 257, 129, 65, gen, MOE_QS, torch.float32))
    # the batched backward at an odd shape with f32 x, with f32 cotangents
    # (the SIMT path), and past the reference's scratch budget (split)
    qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
        torch, timer, qmm, ref, 3, 257, 129, 65, gen, MOE_QS, torch.float32))
    qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
        torch, timer, qmm, ref, 32, 1280, 1024, 512, gen, MOE_QS, round_cot=False))
    torch.cuda.empty_cache()
    qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
        torch, timer, qmm, ref, 4, 256, 512, 8192, gen, MOE_QS))
    paths = [r["path"] for r in qat_rows["quant_matmul_bwd_batched"]]
    if paths != ["tc", "tc", "tc", "simt", "split"]:
        fail(f"quant_matmul_bwd_batched took paths {paths}")
    torch.cuda.empty_cache()

    # 10. the quantizer kernels (10-12) against their plain versions
    q_rows, rows_launches = quantizer_kernel_checks(torch, timer, ops, ref, phase_gen(10))
    torch.cuda.empty_cache()

    del timer  # its 2 GB buffer would count in the serving runs' peak memory
    torch.cuda.empty_cache()
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    # 3. the main path: full-width granite-8b, all 36 layers
    main_run = serve_phase(
        torch, ops, serve, M,
        ["--arch", "granite-8b", "--quant", "w4a4", "--kv-bits", "8",
         "--batch", "8", "--slots", "4", "--prompt-len", "128",
         "--new-tokens", "32", "--chunk", "32"],
        ("int4_matmul", "int_matmul", "pooled_decode_attention"), 2,
        cpu_reference=False)
    counts = main_run["counts"]
    # 4. second config: w8a8 weights, packed int4 KV, 4 layers
    serve_phase(
        torch, ops, serve, M,
        ["--arch", "granite-8b", "--quant", "w8a8", "--kv-bits", "4",
         "--layers", "4", "--batch", "8", "--slots", "4",
         "--prompt-len", "128", "--new-tokens", "32", "--chunk", "32"],
        ("int_matmul", "pooled_decode_attention"), 0, cpu_reference=True)

    # 12. MoE serving: full-width granite-moe-1b-a400m, all 24 layers
    moe_serve = serve_phase(
        torch, ops, serve, M,
        ["--arch", "granite-moe-1b-a400m", "--quant", "w3a3", "--kv-bits", "8",
         "--batch", "8", "--slots", "4", "--prompt-len", "128",
         "--new-tokens", "32", "--chunk", "32"],
        ("int4_matmul", "pooled_decode_attention"), True, cpu_reference=False,
        extra=moe_serve_checks(torch, M))
    torch.cuda.empty_cache()

    # 13. learned positions and layernorm on the serving path: full-width
    #     musicgen-medium, all 48 layers
    music_serve = serve_phase(
        torch, ops, serve, M,
        ["--arch", "musicgen-medium", "--quant", "w4a4", "--kv-bits", "8",
         "--batch", "8", "--slots", "4", "--prompt-len", "128",
         "--new-tokens", "32", "--chunk", "32"],
        ("int4_matmul", "int_matmul", "pooled_decode_attention"), True,
        cpu_reference=False, extra=dense_serve_checks(torch, M))
    torch.cuda.empty_cache()

    # 6. QAT training, the main path of the training slice: full-width
    #    qwen1.5-0.5b, 3 steps saving at step 2, then a restored 4th step
    from repro_torch.launch import train
    import shutil
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    targv = ["--arch", "qwen1.5-0.5b", "--quant", "w4a4", "--kd", "mckd",
             "--batch", "8", "--seq", "512", "--save-every", "2",
             "--ckpt", str(ckpt_dir)]
    first = train_phase(torch, ops, train, targv + ["--steps", "3"], 0, 3)
    resumed = train_phase(torch, ops, train, targv + ["--steps", "4"], 3, 1)
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    for run, n_steps in ((first, 3), (resumed, 1)):
        run.update(cfg=get_config("qwen1.5-0.5b"), qcfg=get_preset("w4a4"))
        per_step = check_launches(run, n_steps, 8 * 512)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # 7. the kernel route against the unfused composition, on the card
    route = route_check(torch)
    torch.cuda.empty_cache()
    # 8. MoE QAT training with OBR and oscillation tracking, full width
    moe_run = moe_train_phase(torch, ops)
    moe_step = check_launches(moe_run, 3, 8 * 512, every_kernel=True)
    torch.cuda.empty_cache()
    # 9. the MoE kernel route against the unfused composition, at init
    moe_route = route_check(torch, "granite-moe-1b-a400m", "w3a3")
    torch.cuda.empty_cache()
    # 14. training the learned-position models at full width: musicgen-medium
    #     through the CLI, the paper's BERT-base (w2a2, OBR, oscillation
    #     tracked) and DeiT-T (w3a3, 197 patches) through run_training; then
    #     the MCKD store on the card
    music_dir = ROOT / "build" / "chip_smoke_musicgen_ckpt"
    shutil.rmtree(music_dir, ignore_errors=True)
    music_train = train_phase(
        torch, ops, train, ["--arch", "musicgen-medium", "--quant", "w4a4",
                            "--kd", "mckd", "--batch", "8", "--seq", "512",
                            "--steps", "3", "--save-every", str(10 ** 6),
                            "--ckpt", str(music_dir)], 0, 3)
    shutil.rmtree(music_dir, ignore_errors=True)
    music_train.update(cfg=get_config("musicgen-medium"), qcfg=get_preset("w4a4"))
    music_step = check_launches(music_train, 3, 8 * 512)
    torch.cuda.empty_cache()
    paper_runs = {}
    for arch, qcfg, batch, seq in (
            ("paper-bert-base", get_preset("w2a2").replace(track_oscillation=True), 32, 128),
            ("paper-deit-t", get_preset("w3a3"), 64, 197)):
        run = training_run(torch, ops, get_config(arch), qcfg, batch=batch, seq=seq,
                           steps=3, tag=arch, strict_health=True)
        run["per_step"] = check_launches(run, 3, batch * seq)
        paper_runs[arch] = run
        torch.cuda.empty_cache()
    store = mckd_store_phase(torch)
    torch.cuda.empty_cache()
    # 15. the paper-table twins, steps cut
    tables = tables_phase(torch)
    torch.cuda.empty_cache()
    # 11. the kernel benchmark, the entry point of kernels 10 and 12
    bench_counts, bench = kernel_bench_phase(torch, ops)
    counts.update(first["counts"])
    for name in ("quant_matmul_batched", "quant_matmul_bwd_batched"):
        counts[name] = moe_run["counts"][name]
    for name in ("fake_quant_2d", "bin_stats_2d"):
        counts[name] = bench_counts[name]
    counts["fake_quant_rows"] = rows_launches
    rows.update(qat_rows)
    rows.update(q_rows)

    sources = {"int4_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                               "src/repro/kernels/quant_matmul.py:863"),
               "int_matmul": ("src/repro_torch/kernels/csrc/quant_matmul.cu",
                              "src/repro/kernels/quant_matmul.py:819"),
               "pooled_decode_attention": (
                   "src/repro_torch/kernels/csrc/decode_attention.cu",
                   "src/repro/kernels/decode_attention.py:137"),
               "quant_matmul": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                "src/repro/kernels/quant_matmul.py:81"),
               "quant_matmul_dx": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                   "src/repro/kernels/quant_matmul.py:241"),
               "quant_matmul_dw": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                   "src/repro/kernels/quant_matmul.py:361"),
               "quant_matmul_bwd": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                    "src/repro/kernels/quant_matmul.py:574"),
               "quant_matmul_batched": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                        "src/repro/kernels/quant_matmul.py:141"),
               "quant_matmul_bwd_batched": ("src/repro_torch/kernels/csrc/qat_matmul.cu",
                                            "src/repro/kernels/quant_matmul.py:743"),
               "fake_quant_2d": ("src/repro_torch/kernels/csrc/fake_quant.cu",
                                 "src/repro/kernels/fake_quant.py:48"),
               "fake_quant_rows": ("src/repro_torch/kernels/csrc/fake_quant.cu",
                                   "src/repro/kernels/fake_quant.py:73"),
               "bin_stats_2d": ("src/repro_torch/kernels/csrc/bin_stats.cu",
                                "src/repro/kernels/bin_stats.py:48")}
    kernels = []
    for name, rs in rows.items():
        r = rs[0]  # the decode shape of the main path
        kernels.append({"name": name, "route": "cuda", "source": sources[name][0],
                        "replaces": sources[name][1], "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "shape": r["shape"], "tol": r["tol"],
                        "checks": len(rs)})
        if name in ("int4_matmul", "pooled_decode_attention"):
            kernels[-1]["launches_moe_serve"] = moe_serve["counts"][name]
        if name in ("int4_matmul", "int_matmul", "pooled_decode_attention"):
            kernels[-1]["launches_musicgen_serve"] = music_serve["counts"][name]
        if name in QAT_KERNELS:
            kernels[-1]["launches_train"] = {
                "musicgen-medium": music_train["counts"][name],
                **{a: r["counts"][name] for a, r in paper_runs.items()}}
        if name in ("int4_matmul", "int_matmul", "pooled_decode_attention"):
            kernels[-1].update(plan=r["plan"], independence=serving["independence"][name],
                               rows=[{k: v for k, v in row.items() if k in (
                                   "shape", "ms", "plain_ms", "library_ms", "bound_ms")}
                                   for row in rs])
        if any("device_kernels" in row for row in rs):
            kernels[-1]["device_kernels"] = sorted(
                {d for row in rs for d in row.get("device_kernels", [])})
        if name == "fake_quant_rows":
            kernels[-1]["launches_from"] = ("the kernel checks: no entry point "
                                            "of the repo reaches fake_quant_rows")
        if name == "bin_stats_2d":
            kernels[-1]["library"] = r["library"]
        if name in ("quant_matmul", "quant_matmul_batched", "quant_matmul_bwd",
                    "quant_matmul_bwd_batched", "quant_matmul_dx", "quant_matmul_dw"):
            kernels[-1]["path"] = r["path"]
            kernels[-1]["prologue_ms"] = r["prologue_ms"]
        if name in ("quant_matmul_dx", "quant_matmul_dw"):
            kernels[-1].update(
                kernel=f"qat_{name[-2:]}_tc_kernel", planes=r["planes"],
                bound_f32_ms=r["bound_f32_ms"], grid_tflops=r["grid_tflops"],
                split=r["split"], rows=[{k: v for k, v in row.items() if k in (
                    "shape", "planes", "ms", "prologue_ms", "plain_ms", "library_ms",
                    "bound_ms", "bound_f32_ms", "grid_tflops")} for row in rs])
        if name == "quant_matmul_dx":
            kernels[-1]["split_edges"] = edges
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"chip_smoke: total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"train": {
        "s_per_step": first["s_step"], "tokens_per_s": first["tokens_s"],
        "peak_gib": (first["report"].peak_bytes or 0) / 2**30,
        "losses": first["report"].losses + resumed["report"].losses,
        "launches_per_step": per_step, "route": route},
        "moe_train": {
        "s_per_step": moe_run["s_step"], "tokens_per_s": moe_run["tokens_s"],
        "step_seconds": moe_run["report"].step_seconds,
        "peak_gib": (moe_run["report"].peak_bytes or 0) / 2**30,
        "losses": moe_run["report"].losses, "metrics": moe_run["report"].metrics,
        "launches_per_step": moe_step, "route": moe_route},
        "moe_serve": {
        "throughput": moe_serve["summary"]["throughput"],
        "peak_gib": (moe_serve["peak"] or 0) / 2**30, "launches": moe_serve["counts"],
        "wall_s": moe_serve["wall"], **moe_serve["extra"]},
        "musicgen_serve": {
        "throughput": music_serve["summary"]["throughput"],
        "peak_gib": (music_serve["peak"] or 0) / 2**30,
        "launches": music_serve["counts"], "wall_s": music_serve["wall"],
        **music_serve["extra"]},
        "learned_pos_train": {
        arch: {"s_per_step": r["s_step"], "tokens_per_s": r["tokens_s"],
               "step_seconds": r["report"].step_seconds,
               "peak_gib": (r["report"].peak_bytes or 0) / 2**30,
               "losses": r["report"].losses, "healths": r["report"].healths,
               "metrics": r["report"].metrics, "launches_per_step": per}
        for arch, r, per in (("musicgen-medium", music_train, music_step),
                             *((a, r, r["per_step"]) for a, r in paper_runs.items()))},
        "mckd_store": store,
        "tables": {k: {"steps": v["steps"], "wall_s": v["wall_s"], "rows": v["rows"]}
                   for k, v in tables.items()},
        "kernel_bench": {
        "launches": bench_counts, "equivalence": bench["equivalence"],
        "decode_parity": bench["decode_parity"],
        "standalone": bench["standalone"]}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
