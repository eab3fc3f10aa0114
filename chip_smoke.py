#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
  1. build   — nvcc builds every CUDA kernel of the serving path from
               src/repro_torch/kernels/csrc, one process per source, in
               parallel; prints the build seconds and ptxas' register use.
  2. kernels — each kernel against its plain PyTorch version on the card, at
               the shapes granite-8b's serving path gives it, with the stated
               tolerance; prints the kernel's median ms, the plain version's
               ms, one PyTorch library call computing the same function
               (timed here only, never used by the port) and the least time
               the card could take (bytes over 3.35 TB/s or operations over
               989 TFLOP/s, whichever is larger).
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
  5. qat kernels — each QAT kernel against its plain version at the shapes
               of the training path (M = 8 x 512 tokens of qwen1.5-0.5b):
               quant_matmul at an FFN, a K-side-scaled wo and the tied head;
               quant_matmul_bwd at the FFN's two shapes (bf16 cotangents);
               quant_matmul_dx / _dw at the head (f32 cotangents); with the
               same four numbers a kernel, and the bars of the CPU tests.
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
Then one JSON line with every kernel's numbers, the card's name and power
limit (nvidia-smi), and last `{"ok": true, "device": {...}}`.

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Imports
nothing of JAX.
"""
from __future__ import annotations

import json
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median of single-launch CUDA-event times. Before each launch a 2 GB
    buffer is read (not written: dirty lines would be written back during
    the timed launch): it evicts the 50 MB L2, so every launch finds its
    inputs in HBM as the serving path does (each weight is read once a
    step), and it keeps the device busy for ~0.7 ms while the host enqueues
    the timed call, so the events time the device's work and not the
    Python in front of the launch."""

    def __init__(self, torch, iters: int = 15):
        self.torch = torch
        self.iters = iters
        self.flush = torch.ones(512 * 2**20, dtype=torch.float32, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.iters):
            self.flush.sum()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, ops: float, ops_per_s: float = BF16_OPS_PER_S
          ) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_matmul(torch, timer, qmm, ref, packed: bool, m: int, k: int, n: int,
                 gen) -> dict:
    dev = "cuda"
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    lim = 8 if packed else 128
    codes = torch.randint(-lim, lim, (k, n), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int8)
    scale = torch.rand((n,), generator=gen, device=dev) * 0.02 + 1e-3
    if packed:
        from repro_torch.core.quantizer import pack_int4
        w = pack_int4(codes, 0)
        kern = lambda: qmm.int4_matmul(x, w, scale)
        plain = lambda: ref.int4_matmul(x, w, scale)
    else:
        w = codes
        kern = lambda: qmm.int_matmul(x, w, scale)
        plain = lambda: ref.int_matmul(x, w, scale)
    y_k = kern()
    y_r = plain()
    torch.cuda.synchronize()
    err = (y_k - y_r).abs().max().item()
    # only the f32 summation order differs (up to 14336 terms)
    tol = 1e-5 * y_r.abs().max().item()
    wd = (codes.float() * scale).to(torch.bfloat16)
    lib = lambda: torch.matmul(x, wd)
    nbytes = m * k * 2 + w.numel() + n * 4 + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
    row = {"shape": [m, k, n], "max_abs_err": err, "tol": tol,
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    name = "int4_matmul" if packed else "int_matmul"
    log(f"  {name} M={m} K={k} N={n}: max|err| {err:.3e} (tol {tol:.3e}) "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"torch.matmul(bf16 dequant) {row['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        fail(f"{name} {m}x{k}x{n} disagrees with its plain version: {err} > {tol}")
    return row


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
    acc_r, m_r, l_r = plain()
    torch.cuda.synchronize()
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
           "max_abs_err": err, "tol": tol, "ms": timer.ms(kern),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"  pooled_decode_attention {storage} q={row['shape']['q']} C={c} "
        f"T={t} window={window} softcap={softcap}: max|err| {err:.3e} "
        f"(tol {tol:.3e}), max|dm| {m_err:.2e}, masked rows ok {dead_ok}; "
        f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"sdpa(dequant) {row['library_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    if not err <= tol:
        fail(f"decode attention {storage} C={c} disagrees: {err} > {tol}")
    if not m_err <= 1e-4 * max(1.0, m_r[live].abs().max().item()):
        fail(f"decode attention {storage} C={c}: running max differs by {m_err}")
    if not dead_ok:
        fail(f"decode attention {storage} C={c}: fully masked rows not finite "
             "with m = NEG_INF, l > 0")
    return row


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
                check_streams: bool, cpu_reference: bool) -> dict:
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
            "wall": wall}


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


def qat_operands(torch, m, k, n, k_side, gen, qs):
    dev = "cuda"
    x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev) * k ** -0.5
    ws = torch.rand((k, 1) if k_side else (1, n), generator=gen, device=dev)
    ws = ws * 0.05 + 0.02
    if qs["q_p_w"] > 7:  # 8-bit edge: scales that use the 8-bit range
        ws = ws * 0.1
    a_s = torch.tensor(0.3 if qs["q_p_a"] == 15 else 0.02, device=dev)
    a_b = torch.tensor(-0.2, device=dev)
    return x, w, a_s, a_b, ws


def check_qat_fwd(torch, timer, qmm, ref, m, k, n, k_side, gen, qs) -> dict:
    x, w, a_s, a_b, ws = qat_operands(torch, m, k, n, k_side, gen, qs)
    kern = lambda: qmm.quant_matmul(x, w, a_s, a_b, ws, **qs)
    plain = lambda: ref.quant_matmul(x, w, a_s, a_b, ws, **qs)
    y_k, y_r = kern(), plain()
    torch.cuda.synchronize()
    err = (y_k - y_r).abs().max().item()
    tol = 1e-5 * y_r.abs().max().item()
    _, _, xd = ref._act_codes(x, a_s, a_b, qs["q_n_a"], qs["q_p_a"])
    _, _, wd = ref._weight_codes(w, ws, qs["q_n_w"], qs["q_p_w"])
    xd, wd = xd.to(torch.bfloat16), wd.to(torch.bfloat16)
    lib = lambda: torch.matmul(xd, wd)
    del y_k, y_r
    nbytes = m * k * 2 + k * n * 4 + ws.numel() * 4 + 8 + m * n * 4
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n)
    row = {"shape": [m, k, n], "w_scale": "rows" if k_side else "cols",
           "max_abs_err": err, "tol": tol, "ms": timer.ms(kern),
           "plain_ms": timer.ms(plain), "library_ms": timer.ms(lib),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"  quant_matmul M={m} K={k} N={n} ({row['w_scale']} scales): max|err| "
        f"{err:.3e} (tol {tol:.3e}); kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, torch.matmul(bf16 dequant) "
        f"{row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        fail(f"quant_matmul {m}x{k}x{n} disagrees with its plain version: {err} > {tol}")
    return row


def check_qat_bwd(torch, timer, qmm, ref, name, m, k, n, k_side, round_cot,
                  gen, qs) -> dict:
    """quant_matmul_bwd (combined) or quant_matmul_dx / _dw (split) against
    the plain versions; the scalar and per-column sums within 1e-4 of their
    sum of |summands|."""
    x, w, a_s, a_b, ws = qat_operands(torch, m, k, n, k_side, gen, qs)
    dy = torch.randn((m, n), generator=gen, device="cuda")
    kw = dict(round_cot=round_cot, **qs)
    args = (dy, x, w, a_s, a_b, ws)
    fn = getattr(qmm, name)
    plain_fn = getattr(ref, name)
    kern = lambda: fn(*args, **kw)
    plain = lambda: plain_fn(*args, **kw)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    u_x, q_x, xd = ref._act_codes(x, a_s, a_b, qs["q_n_a"], qs["q_p_a"])
    u_w, q_w, wd = ref._weight_codes(w, ws, qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(dy, round_cot)
    checks, worst = [], 0.0
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
        gw, ww = (got[3], got[4]) if name == "quant_matmul_bwd" else got
        rw, rws = (want[3], want[4]) if name == "quant_matmul_bwd" else want
        dw_abs = xd.abs().T @ cot.abs()
        ex, frac = _bf16_close(torch, gw, rw, dw_abs, m)
        del dw_abs
        mf = ref._in_range(u_w, qs["q_n_w"], qs["q_p_w"])
        part = (ref._bf16(xd.T @ cot) * (q_w - mf * u_w)).abs()
        l1 = part.sum(dim=1 if k_side else 0, keepdim=True)
        del part, mf
        dws_ok = bool(((ww - rws).abs() <= 1e-4 * l1).all())
        checks += [("dW", ex <= 0 and frac <= 0.01, f"excess {ex:.2e}, differing {frac:.2e}"),
                   ("dws", dws_ok, f"max {(ww - rws).abs().max().item():.3e}")]
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
    nbytes = m * n * 4 + m * k * 2 + k * n * 4 + ws.numel() * 4 + 8 + outs
    b_ms, b_by = bound(nbytes, 2.0 * m * k * n * products,
                       BF16_OPS_PER_S if round_cot else F32_OPS_PER_S)
    row = {"shape": [m, k, n], "w_scale": "rows" if k_side else "cols",
           "round_cot": round_cot, "max_abs_err": worst,
           "tol": "bf16 ulp + f32 order bound; sums 1e-4 x sum|summands|",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(libs[name]), "bound_ms": b_ms, "bound_by": b_by}
    log(f"  {name} M={m} K={k} N={n} ({row['w_scale']} scales, "
        f"{'bf16' if round_cot else 'f32'} cotangents): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"torch.matmul(dequant) {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    bad = [c for c, ok, _ in checks if not ok]
    if bad:
        fail(f"{name} {m}x{k}x{n} disagrees with its plain version on {bad}")
    return row


# ---------------------------------------------------------------------------
# phases 6-7: QAT training
# ---------------------------------------------------------------------------

QAT_KERNELS = ("quant_matmul", "quant_matmul_bwd", "quant_matmul_dx",
               "quant_matmul_dw")


def qat_launches_per_step(cfg) -> dict:
    """Launches a train step makes, from the model: every block linear runs
    its forward twice (remat recomputes the block in the backward) and its
    combined backward once; the tied head, whose vocab-wide N takes the
    split route, runs the forward once and dx / dw once each."""
    per_layer = 4 + (3 if cfg.ffn_gated else 2)
    return {"quant_matmul": 2 * per_layer * cfg.n_layers + 1,
            "quant_matmul_bwd": per_layer * cfg.n_layers,
            "quant_matmul_dx": 1, "quant_matmul_dw": 1}


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


def route_check(torch, gen_seed: int = 0) -> dict:
    """Gradients of full-width qwen1.5-0.5b cut to 2 layers (batch 2 x 256,
    one step from init) on the kernel route against the unfused composition,
    both on the card: loss within 1e-3 relative, every non-scalar gradient
    leaf within 1e-2 relative L2, the scalar quantizer leaves pooled per
    kind (a single near-zero scalar's relative error means little).

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
    cfg = get_config("qwen1.5-0.5b").replace(n_layers=2)
    qcfg = get_preset("w4a4")
    tcfg = TrainConfig(total_steps=10, warmup_steps=0, kd="mckd",
                       sentinel=SentinelConfig())
    state = init_state(cfg, qcfg, tcfg,
                       torch.Generator(device="cuda").manual_seed(gen_seed), "cuda")
    b = sample_batch(cfg, DataConfig(), 0, 2, 256)
    b["kd_idx"], b["kd_p"] = synthetic_kd_labels(b["labels"], cfg.vocab_size, 16, seed=0)
    b = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in b.items()}

    def grads(route, clip=None):
        orig = quantizer._clip
        if clip is not None:
            quantizer._clip = clip
        try:
            loss, _, g = make_grad_fn(cfg, qcfg.replace(fused_matmul=route), tcfg)(
                state["params"], b, state["step"])
        finally:
            quantizer._clip = orig
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

    kern = grads("auto")
    d_edge, top_edge = gaps(kern, grads("off", torch.clamp))
    d_raw, top_raw = gaps(kern, grads("off"))
    log(f"route check: kernel route vs unfused (kernels' edge rule): loss gap "
        f"{d_edge:.3e} (bar 1e-3), worst leaves {top_edge} (bar 1e-2)")
    log(f"  vs unfused as it is (clip splits the gradient at the edge): loss "
        f"gap {d_raw:.3e}, worst leaves {top_raw}")
    if not (d_edge <= 1e-3 and top_edge[0][1] <= 1e-2):
        fail(f"kernel route departs from the unfused route: loss {d_edge}, {top_edge[0]}")
    return {"edge_rule": {"loss": d_edge, "worst": top_edge},
            "as_is": {"loss": d_raw, "worst": top_raw}}

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
        for line in r["log"].splitlines():
            if "Used" in line or "spill" in line.lower() and "0 bytes spill" not in line:
                log(f"    {line.strip()}")

    # 2. kernels
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    log("kernels (each against its plain version on the card):")
    rows = {"int4_matmul": [], "int_matmul": [], "pooled_decode_attention": []}
    for m, k, n in ((4, 4096, 14336), (4, 14336, 4096), (4, 4096, 4096),
                    (4, 4096, 1024), (32, 4096, 14336), (32, 14336, 4096)):
        rows["int4_matmul"].append(check_matmul(torch, timer, qmm, ref, True,
                                                m, k, n, gen))
    for m, k, n in ((4, 4096, 49152), (32, 4096, 49152), (4, 4096, 14336)):
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

    # 5. the QAT kernels at the training path's shapes (qwen1.5-0.5b,
    #    M = 8 x 512 tokens)
    log("qat kernels (each against its plain version on the card):")
    m = 8 * 512
    qat_rows = {name: [] for name in QAT_KERNELS}
    for k, n, k_side, qs in ((1024, 2816, False, QAT_QS), (1024, 1024, True, QAT_QS),
                             (1024, 152064, False, HEAD_QS)):
        qat_rows["quant_matmul"].append(check_qat_fwd(
            torch, timer, qmm, ref, m, k, n, k_side, gen, qs))
        torch.cuda.empty_cache()
    for k, n in ((1024, 2816), (2816, 1024)):
        qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
            torch, timer, qmm, ref, "quant_matmul_bwd", m, k, n, False, True,
            gen, QAT_QS))
    qat_rows["quant_matmul_bwd"].append(check_qat_bwd(
        torch, timer, qmm, ref, "quant_matmul_bwd", m, 1024, 1024, True, True,
        gen, QAT_QS))
    for name in ("quant_matmul_dx", "quant_matmul_dw"):
        qat_rows[name].append(check_qat_bwd(
            torch, timer, qmm, ref, name, m, 1024, 152064, False, False, gen,
            HEAD_QS))
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
    per_step = qat_launches_per_step(get_config("qwen1.5-0.5b"))
    for run, n_steps in ((first, 3), (resumed, 1)):
        want = {k: v * n_steps for k, v in per_step.items()}
        if run["counts"] != want or min(run["counts"].values()) <= 0:
            fail(f"QAT launches {run['counts']} != {per_step} per step x {n_steps}")
    log(f"  launches per step {per_step}: both runs match")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # 7. the kernel route against the unfused composition, on the card
    route = route_check(torch)
    counts.update(first["counts"])
    rows.update(qat_rows)

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
                                    "src/repro/kernels/quant_matmul.py:574")}
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"chip_smoke: total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"train": {
        "s_per_step": first["s_step"], "tokens_per_s": first["tokens_s"],
        "peak_gib": (first["report"].peak_bytes or 0) / 2**30,
        "losses": first["report"].losses + resumed["report"].losses,
        "launches_per_step": per_step, "route": route}}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
