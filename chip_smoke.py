#!/usr/bin/env python3
"""Smoke run of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line is printed):
  1. build   — nvcc builds every CUDA kernel of the port from
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
  5b. moe kernels — quant_matmul_batched and quant_matmul_bwd_batched
               against their plain versions at granite-moe-1b-a400m's expert
               shapes (32 experts x 1280 capacity rows, K/N 1024/512 and
               512/1024, w3a3), and the batched backward once on its split
               route (a wide N past the reference's scratch budget); run
               with phase 5.
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


MOE_QS = dict(q_n_a=0, q_p_a=7, q_n_w=4, q_p_w=3)     # w3a3


def batched_operands(torch, e, m, k, n, gen, qs):
    dev = "cuda"
    x = (torch.randn((e, m, k), generator=gen, device=dev) * 2).to(torch.bfloat16)
    w = torch.randn((e, k, n), generator=gen, device=dev) * k ** -0.5
    a_s = torch.rand((e, 1), generator=gen, device=dev) * 0.3 + 0.2
    a_b = torch.randn((e, 1), generator=gen, device=dev) * 0.1
    ws = torch.rand((e, n), generator=gen, device=dev) * 0.01 + 0.005
    return x, w, a_s, a_b, ws


def check_batched_fwd(torch, timer, qmm, ref, e, m, k, n, gen, qs) -> dict:
    x, w, a_s, a_b, ws = batched_operands(torch, e, m, k, n, gen, qs)
    kern = lambda: qmm.quant_matmul_batched(x, w, a_s, a_b, ws, **qs)
    plain = lambda: ref.quant_matmul_batched(x, w, a_s, a_b, ws, **qs)
    y_k, y_r = kern(), plain()
    torch.cuda.synchronize()
    err = (y_k - y_r).abs().max().item()
    tol = 1e-5 * y_r.abs().max().item()
    s_a, b_a, s_w = ref._expert_scales(a_s, a_b, ws)
    xd = ref._act_codes(x, s_a, b_a, qs["q_n_a"], qs["q_p_a"])[2].to(torch.bfloat16)
    wd = ref._weight_codes(w, s_w, qs["q_n_w"], qs["q_p_w"])[2].to(torch.bfloat16)
    lib = lambda: torch.bmm(xd, wd)
    del y_k, y_r
    nbytes = e * (m * k * 2 + k * n * 4 + 8 + n * 4 + m * n * 4)
    b_ms, b_by = bound(nbytes, 2.0 * e * m * k * n)
    row = {"shape": [e, m, k, n], "max_abs_err": err, "tol": tol,
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    log(f"  quant_matmul_batched E={e} M={m} K={k} N={n}: max|err| {err:.3e} "
        f"(tol {tol:.3e}); kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"torch.bmm(bf16 dequant) {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        fail(f"quant_matmul_batched {e}x{m}x{k}x{n} disagrees with its plain "
             f"version: {err} > {tol}")
    return row


def check_batched_bwd(torch, timer, qmm, ref, e, m, k, n, gen, qs) -> dict:
    """quant_matmul_bwd_batched against its plain version, with the bars of
    check_qat_bwd per expert; the route (combined or split expert by expert
    through quant_matmul_dx / _dw) is the reference's on the padded shape."""
    x, w, a_s, a_b, ws = batched_operands(torch, e, m, k, n, gen, qs)
    dy = torch.randn((e, m, n), generator=gen, device="cuda")
    combined = qmm.bwd_uses_combined(*qmm.padded_dims(m, k, n))
    args = (dy, x, w, a_s, a_b, ws)
    kern = lambda: qmm.quant_matmul_bwd_batched(*args, **qs)
    plain = lambda: ref.quant_matmul_bwd_batched(*args, **qs)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    s_a, b_a, s_w = ref._expert_scales(a_s, a_b, ws)
    u, q, xd = ref._act_codes(x, s_a, b_a, qs["q_n_a"], qs["q_p_a"])
    uw, qw, wd = ref._weight_codes(w, s_w, qs["q_n_w"], qs["q_p_w"])
    cot = ref._cotangent(dy, True)
    ex_x, fr_x = _bf16_close(torch, got[0], want[0],
                             cot.abs() @ wd.abs().transpose(1, 2), n)
    ex_w, fr_w = _bf16_close(torch, got[3], want[3],
                             xd.abs().transpose(1, 2) @ cot.abs(), m)
    dxd = ref._bf16(cot @ wd.transpose(1, 2))
    mf = ref._in_range(u, qs["q_n_a"], qs["q_p_a"])
    l1a = (dxd * (q - mf * u)).abs().sum(dim=(1, 2)).reshape(e, 1)
    l1b = (dxd * (1 - mf)).abs().sum(dim=(1, 2)).reshape(e, 1)
    del dxd, mf
    dwd = ref._bf16(xd.transpose(1, 2) @ cot)
    mfw = ref._in_range(uw, qs["q_n_w"], qs["q_p_w"])
    l1w = (dwd * (qw - mfw * uw)).abs().sum(dim=1)
    del dwd, mfw
    checks = [("dX", ex_x <= 0 and fr_x <= 0.01, f"excess {ex_x:.2e}, differing {fr_x:.2e}"),
              ("dsa", bool(((got[1] - want[1]).abs() <= 1e-4 * l1a).all()),
               f"max {(got[1] - want[1]).abs().max().item():.3e}"),
              ("dba", bool(((got[2] - want[2]).abs() <= 1e-4 * l1b).all()),
               f"max {(got[2] - want[2]).abs().max().item():.3e}"),
              ("dW", ex_w <= 0 and fr_w <= 0.01, f"excess {ex_w:.2e}, differing {fr_w:.2e}"),
              ("dws", bool(((got[4] - want[4]).abs() <= 1e-4 * l1w).all()),
               f"max {(got[4] - want[4]).abs().max().item():.3e}")]
    worst = max((got[0] - want[0]).abs().max().item(),
                (got[3] - want[3]).abs().max().item())
    del got, want
    ct, xl, wl = cot.to(torch.bfloat16), xd.to(torch.bfloat16), wd.to(torch.bfloat16)
    lib = lambda: (torch.bmm(ct, wl.transpose(1, 2)), torch.bmm(xl.transpose(1, 2), ct))
    nbytes = e * (m * n * 4 + m * k * 2 + k * n * 4 + 8 + n * 4
                  + m * k * 4 + 8 + k * n * 4 + n * 4)
    b_ms, b_by = bound(nbytes, 4.0 * e * m * k * n)
    row = {"shape": [e, m, k, n], "route": "combined" if combined else "split",
           "max_abs_err": worst,
           "tol": "bf16 ulp + f32 order bound; sums 1e-4 x sum|summands| per expert",
           "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
           "library_ms": timer.ms(lib), "bound_ms": b_ms, "bound_by": b_by}
    log(f"  quant_matmul_bwd_batched E={e} M={m} K={k} N={n} ({row['route']} route): "
        + "; ".join(f"{c} {'ok' if ok else 'FAIL'} ({msg})" for c, ok, msg in checks)
        + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"torch.bmm(bf16 dequant) {row['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
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


def qat_launches_per_step(cfg) -> dict:
    """Launches a train step makes, from the model: every block linear runs
    its forward twice (remat recomputes the block in the backward) and its
    combined backward once: the 4 attention linears and a dense FFN's on
    the 2D kernels, an MoE FFN's expert linears on the batched ones (the
    router stays on the f32 einsum); the tied head, whose vocab-wide N
    takes the split route, runs the forward once and dx / dw once each."""
    ffn = 3 if cfg.ffn_gated else 2
    moe = sum(cfg.block_at(i).ffn == "moe" for i in range(cfg.n_layers))
    dense = 4 * cfg.n_layers + ffn * (cfg.n_layers - moe)
    return {"quant_matmul": 2 * dense + 1, "quant_matmul_bwd": dense,
            "quant_matmul_dx": 1, "quant_matmul_dw": 1,
            "quant_matmul_batched": 2 * ffn * moe,
            "quant_matmul_bwd_batched": ffn * moe}


def formula(cfg) -> str:
    ffn = 3 if cfg.ffn_gated else 2
    if cfg.pattern[0].ffn == "moe":
        return (f"quant_matmul 2 x 4 x {cfg.n_layers} + 1, quant_matmul_bwd 4 x "
                f"{cfg.n_layers}, dx / dw 1 (head), quant_matmul_batched 2 x "
                f"{ffn} x {cfg.n_layers}, quant_matmul_bwd_batched {ffn} x {cfg.n_layers}")
    return (f"quant_matmul 2 x (4 + {ffn}) x {cfg.n_layers} + 1, quant_matmul_bwd "
            f"(4 + {ffn}) x {cfg.n_layers}, dx / dw 1 (head)")


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


def moe_train_phase(torch, ops, steps: int = 3) -> dict:
    """The MoE training path through `run_training` (the CLI has no flag for
    oscillation tracking, as in the reference): full-width 24-layer
    granite-moe-1b-a400m, w3a3 (OBR lambda 0.1 on a cosine ramp over the
    run), track_oscillation, MCKD top-16, sentinel on, batch 8 x 512, seed
    0, the CLI's optimizer settings; no checkpoint is written (save_every
    beyond the run: the full state with its oscillation state is ~24 GB)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.policy import get_preset
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig
    import shutil
    cfg = get_config("granite-moe-1b-a400m")
    qcfg = get_preset("w3a3").replace(track_oscillation=True)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, kd="mckd", kd_topk=16,
                       adamw=AdamWConfig(lr_peak=3e-3), sentinel=SentinelConfig())
    ckpt_dir = ROOT / "build" / "chip_smoke_moe_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    log(f"train: run_training({cfg.name}, 24 layers, w3a3 + OBR, "
        f"track_oscillation, batch 8 x 512, {steps} steps)")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = train.run_training(cfg, qcfg, tcfg, DataConfig(seed=0), steps=steps,
                             batch_size=8, seq_len=512, ckpt_dir=str(ckpt_dir),
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
        f"{s_step:.3f} s, {8 * 512 / s_step:.0f} tokens/s), losses {rep.losses}, "
        f"health {rep.healths}, peak {(rep.peak_bytes or 0) / 2**30:.2f} GiB, "
        f"checkpoint files {written}")
    for i, mm in enumerate(rep.metrics):
        log(f"  step {i}: " + ", ".join(f"{k} {v:.6g}" for k, v in mm.items()))
    if rep.steps_run != steps or len(rep.healths) != steps:
        fail(f"MoE train run ran {rep.steps_run} steps; expected {steps}")
    if not all(v == v and abs(v) < float("inf") for v in rep.losses):
        fail(f"non-finite MoE training loss: {rep.losses}")
    if any(h & SentinelConfig().fatal_bits for h in rep.healths):
        fail(f"fatal sentinel health bits in the MoE run: {rep.healths}")
    lams = [mm["obr_lambda"] for mm in rep.metrics]
    if lams[0] != 0.0 or not all(v > 0 for v in lams[1:]):
        fail(f"obr_lambda should be 0 at step 0 and > 0 after: {lams}")
    if not all("osc_frac" in mm and mm["loss_obr"] > 0 for mm in rep.metrics):
        fail(f"OBR / oscillation metrics missing: {rep.metrics}")
    return {"report": rep, "counts": counts, "wall": wall, "s_step": s_step,
            "tokens_s": 8 * 512 / s_step, "cfg": cfg}

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


def _same_bits(torch, a, b) -> bool:
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


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
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"  bin_stats_2d {label} {tuple(shape)} bins={n_bins}"
        f"{' misaligned' if misaligned else ''}: counts equal {counts_equal}, "
        f"count sum - n {count_gap:.0f} (slack {slack:.0f}), sums within bar "
        f"{sums_ok} (max|err| {err:.3e}); kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library n/a, bound {b_ms:.4f} ms ({b_by})")
    if not (counts_equal and count_gap <= slack and sums_ok):
        fail(f"bin_stats_2d {label} {shape} disagrees with its plain version")
    return row


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
    for args, kw in (
            (("kernel_bench wq", (4096, 1024), 8, 7), {}),
            (("granite-8b w_in w4", (4096, 14336), 8, 7), {}),
            (("granite-8b w_in w8", (4096, 14336), 128, 127), {}),
            (("odd", (513, 7), 4, 3), {}),
            (("odd", (1000, 33), 2, 1), {}),
            (("odd", (100, 33), 128, 127), dict(misaligned=True)),
            (("odd", (64, 64), 1, 1), {})):
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
    qat_rows["quant_matmul_bwd_batched"].append(check_batched_bwd(
        torch, timer, qmm, ref, 4, 256, 512, 8192, gen, MOE_QS))
    if qat_rows["quant_matmul_bwd_batched"][-1]["route"] != "split":
        fail("the wide-N batched backward did not take the split route")
    torch.cuda.empty_cache()

    # 10. the quantizer kernels (10-12) against their plain versions
    q_rows, rows_launches = quantizer_kernel_checks(torch, timer, ops, ref, gen)
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
        if run["counts"] != want or any(run["counts"][k] <= 0 for k in want if want[k]):
            fail(f"QAT launches {run['counts']} != {per_step} per step x {n_steps}")
    log(f"  launches per step {per_step} ({formula(get_config('qwen1.5-0.5b'))}): "
        "both runs match")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    # 7. the kernel route against the unfused composition, on the card
    route = route_check(torch)
    torch.cuda.empty_cache()
    # 8. MoE QAT training with OBR and oscillation tracking, full width
    moe_run = moe_train_phase(torch, ops)
    moe_step = qat_launches_per_step(moe_run["cfg"])
    want = {k: v * 3 for k, v in moe_step.items()}
    log(f"  launches {moe_run['counts']}; per step {moe_step} "
        f"({formula(moe_run['cfg'])}) x 3 steps = {want}")
    if moe_run["counts"] != want or any(moe_run["counts"][k] <= 0 for k in want):
        fail(f"MoE QAT launches {moe_run['counts']} != {moe_step} per step x 3")
    torch.cuda.empty_cache()
    # 9. the MoE kernel route against the unfused composition, at init
    moe_route = route_check(torch, "granite-moe-1b-a400m", "w3a3")
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
        if name == "fake_quant_rows":
            kernels[-1]["launches_from"] = ("the kernel checks: no entry point "
                                            "of the repo reaches fake_quant_rows")
        if name == "bin_stats_2d":
            kernels[-1]["library"] = r["library"]
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
