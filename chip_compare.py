#!/usr/bin/env python3
"""Compare two checkouts of the port on one GPU: parent, change, change, parent.

    python3 chip_compare.py PARENT_ROOT TASK [TASK ...]

Runs each TASK four times, each time in a new process that imports only one
checkout: PARENT_ROOT (another checkout, for example `git archive` of the
parent commit unpacked into a directory that .gitignore lists), then this
one twice, then PARENT_ROOT again, so that both sides see the same card
and the drift of its clocks. Each process builds its checkout's kernels
(into that checkout's build/kernels) and prints its own result; this
process prints the card's name and power limit and one JSON line a task
with the four results, in run order. Tasks, on the shapes of
`chip_smoke.py` (training: M = 8 x 512 tokens), through each checkout's own
`chip_smoke.py` functions, so each side is held to its own bars:

  head       quant_matmul_dx / _dw at the qwen1.5-0.5b head (4096, 1024,
             152064) and the granite-moe head (4096, 1024, 49408) with f32
             cotangents, quant_matmul_bwd's split route there (as a
             training step runs it), and the batched backward's split route
             at (4, 256, 512, 8192): kernel, plain, library and prologue ms.
  tiles      the one-plane tensor-core tiles: quant_matmul at (4096, 1024,
             2816) and the qwen head, quant_matmul_bwd at (4096, 1024,
             2816), quant_matmul_bwd_batched at (32, 1280, 1024, 512).
  f32_bwd    the combined backward with f32 cotangents (the untied heads'):
             quant_matmul_bwd at paper-deit-t's head (12608, 192, 1024),
             musicgen-medium's (4096, 1536, 2048) and (4096, 1024, 2816),
             quant_matmul_bwd_batched at (32, 1280, 1024, 512): kernel,
             plain, library, bound and split-route ms, and each device
             kernel's ms a call (torch.profiler, 5 calls, fresh inputs).
  bwd_bits   a SHA-1 of the five outputs of quant_matmul_bwd with bf16
             cotangents at (4096, 1024, 2816), (4096, 1024, 1024) K-side
             and (257, 129, 65) K-side, of the split route (`_split_bwd`)
             at musicgen-medium's head with f32 cotangents and at (4096,
             1024, 2816) with bf16 ones, and of quant_matmul_bwd_batched
             at (32, 1280, 1024, 512) with bf16 cotangents, on inputs
             drawn the same way on both sides: equal digests are equal
             bits.
  steps_qwen `repro_torch.launch.train`, qwen1.5-0.5b w4a4, 4 steps, the
             profiler off: s/step, losses, peak memory.
  steps_moe  granite-moe-1b-a400m w3a3 + OBR, 5 steps through
             `run_training` (`chip_smoke.moe_train_phase`).
  steps_xlstm_tp
             `repro_torch.launch.train --model-parallel 2` on four gloo
             ranks sharing the card, a (2, 2) mesh: xlstm-350m one period
             (8 layers) w4a4, 8 x 512, 4 steps (cell V, `chip_smoke.py`
             phase 28): rank 0's s/step, losses, gradient norms, peak
             memory, collective bytes a step by kind and by use, and host
             seconds inside `spmd.collect`.
  prof_qwen, prof_moe
             `repro_torch.launch.profile_train` on the two archs: device
             busy ms a step and each QAT kernel's device ms, losses; and the
             process's peak device memory.
  quant_bits a SHA-1 of the outputs of every quantizer path on finite
             inputs drawn the same way on both sides (equal digests are
             equal bits): quant_matmul and its prologue at (4096, 1024,
             2816), a K-side (4096, 1024, 1024), an odd (257, 129, 65) and
             granite-moe's (4096, 1024, 512) w3a3; quant_matmul_batched at
             (32, 1280, 1024, 512); quant_matmul_dx / _dw at (4096, 1024,
             2816) with f32 cotangents; int_matmul / int4_matmul at (4,
             4096, 14336) and (32, 4096, 14336); fake_quant_2d (f32, and
             bf16 with an offset), fake_quant_rows and bin_stats_2d at
             phase 10's first shapes; and the ms of fake_quant_2d at
             (4096, 1024), fake_quant_rows at (32, 524288) and the QAT
             prologues at (4096, 1024, 2816) (the forward's, the
             backward's on one plane and on three).
  serving    the serving kernels at `chip_smoke.py` phase 2's shapes
             (granite-8b): int4_matmul at its six shapes (`INT4_ROWS`),
             int_matmul at its six (`INT8_ROWS`: the head at M 4 and 32, the
             w8a8 linears at M 4) and at the kernel bench's (256, 1024,
             512), pooled_decode_attention at its nine: kernel, plain,
             library and bound ms.
  quantizer  bin_stats_2d at `chip_smoke.py` phase 10's seven rows
             (`BIN_STATS_ROWS`: the kernel bench's (4096, 1024) at 16 bins,
             granite-8b's w_in at 16 and 256 bins, odd and misaligned
             edges): kernel, plain and bound ms, and each device kernel's
             ms a call (the partial pass and the finish).
  head_plans int_matmul at granite-8b's head (K 4096, N 49152), M 4 and 32,
             under its plan (`int4_plan`) and under plans of 2 and 3
             contraction splits: ms (the parent, whose int_matmul takes no
             such plan, reports none).
  prof_decode
             `repro_torch.launch.profile_decode` (cell A: granite-8b, 36
             layers, w4a4, int8 KV, 4 slots): host ms and device busy ms a
             decode step, and the device ms a step of int4_matmul's,
             int_matmul's (the head) and the decode attention's kernels
             (each checkout's own kernel names).

Needs one CUDA card and nvcc. Imports nothing of JAX.
"""
from __future__ import annotations

import importlib.util
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TASKS = ("head", "tiles", "f32_bwd", "bwd_bits", "quant_bits", "steps_qwen", "steps_moe",
         "steps_xlstm_tp", "prof_qwen", "prof_moe", "serving", "quantizer", "head_plans",
         "prof_decode")
ROW_TASKS = ("head", "tiles", "f32_bwd", "bwd_bits", "quant_bits", "serving", "quantizer",
             "head_plans")
# the serving kernels' device kernels, by name, in either checkout
DECODE_KERNELS = {"int4_matmul": ("int4_tc_kernel", "int_matmul_kernel<true"),
                  "int_matmul": ("int8_tc_kernel", "int_matmul_kernel<4"),
                  "pooled_decode_attention": ("decode_tc_kernel", "decode_f32_kernel",
                                              "flash_decode_kernel")}
# int_matmul at the kernel bench's shape (cell E), beside phase 2's rows
KERNEL_BENCH_INT8 = (256, 1024, 512)
# steps_xlstm_tp: the CLI's arguments and the ranks of one card
XLSTM_TP_ARGV = ["--arch", "xlstm-350m", "--quant", "w4a4", "--kd", "mckd", "--batch", "8",
                 "--seq", "512", "--layers", "8", "--steps", "4",
                 "--save-every", str(10 ** 6), "--model-parallel", "2"]
XLSTM_TP_RANKS = 4


def tp_rank(rank: int, port: int, root: Path, out: Path) -> None:
    """One of steps_xlstm_tp's ranks: the checkout's training CLI on its
    slices; writes its numbers to OUT/rank{R}.json."""
    import os
    os.environ.update(WORLD_SIZE=str(XLSTM_TP_RANKS), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, str(root / "src"))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.dist import spmd
    from repro_torch.launch import train
    rep = train.main(XLSTM_TP_ARGV + ["--ckpt", str(out / f"ckpt{rank}")])
    steps = len(rep.losses)
    (out / f"rank{rank}.json").write_text(json.dumps({
        "step_seconds": rep.step_seconds, "losses": rep.losses, "grad_norms": rep.grad_norms,
        "peak_gib": (rep.peak_bytes or 0) / 2**30,
        "moved_per_step": {k: v / steps for k, v in spmd.moved_bytes().items()},
        "moved_by_use_per_step": {k: v / steps for k, v in spmd.moved_bytes_by_use().items()},
        "collect_s": spmd.collect_seconds()}))


def xlstm_tp_steps(root: Path) -> dict:
    """steps_xlstm_tp: XLSTM_TP_RANKS processes of `tp_rank` on the
    checkout; rank 0's numbers."""
    import socket
    out = root / "build" / "chip_compare_tp"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank",
                               str(r), str(port), str(root), str(out)])
             for r in range(XLSTM_TP_RANKS)]
    rcs = [p.wait(timeout=600) for p in procs]
    if any(rcs):
        raise SystemExit(f"chip_compare: steps_xlstm_tp ranks exited {rcs}")
    res = json.loads((out / "rank0.json").read_text())
    shutil.rmtree(out, ignore_errors=True)
    return res


def own_rows():
    """This checkout's `chip_smoke.py` (not the one on sys.path, which may
    be the parent's), for its row lists: both sides run the same rows."""
    spec = importlib.util.spec_from_file_location("chip_smoke_rows", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _row(r: dict, name: str) -> dict:
    keep = ("shape", "path", "planes", "dw_splits", "plan", "ms", "plain_ms", "library_ms",
            "bound_ms", "bound_f32_ms", "split_route_ms", "prologue_ms", "device_kernels")
    return {"name": name, **{k: r[k] for k in keep if k in r}}


def device_ms(torch, fn, calls: int = 5) -> dict:
    """Each device kernel's ms a call of fn (torch.profiler over `calls`
    calls after one), by name without its namespace and arguments."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.split("(anonymous namespace)::")[-1].split("(")[0][:80]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def run_one(root: Path, task: str) -> dict:
    """One task on one checkout, in this process."""
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import quant_matmul as qmm
    build.build_all()
    out = {"root": str(root), "task": task}
    gen = torch.Generator(device="cuda").manual_seed(0)
    if task in ROW_TASKS:
        timer = cs.Timer(torch)
        rows = []
    if task == "head":
        m = 8 * 512
        for n in (152064, 49408):
            for name in ("quant_matmul_dx", "quant_matmul_dw"):
                rows.append(_row(cs.check_qat_bwd(torch, timer, qmm, ref, name, m, 1024, n,
                                                  False, False, gen, cs.HEAD_QS), name))
                torch.cuda.empty_cache()
            x, w, a_s, a_b, ws = cs.qat_operands(torch, m, 1024, n, False, gen, cs.HEAD_QS)
            dy = torch.randn((m, n), generator=gen, device="cuda")
            split = lambda: qmm.quant_matmul_bwd(dy, x, w, a_s, a_b, ws, round_cot=False,
                                                 **cs.HEAD_QS)
            rows.append({"name": "quant_matmul_bwd (split)", "shape": [m, 1024, n],
                         "ms": timer.ms(split)})
            del x, w, dy
            torch.cuda.empty_cache()
        rows.append(_row(cs.check_batched_bwd(torch, timer, qmm, ref, 4, 256, 512, 8192, gen,
                                              cs.MOE_QS), "quant_matmul_bwd_batched"))
    elif task == "tiles":
        m = 8 * 512
        for n, qs in ((2816, cs.QAT_QS), (152064, cs.HEAD_QS)):
            rows.append(_row(cs.check_qat_fwd(torch, timer, qmm, ref, m, 1024, n, False, gen,
                                              qs), "quant_matmul"))
            torch.cuda.empty_cache()
        rows.append(_row(cs.check_qat_bwd(torch, timer, qmm, ref, "quant_matmul_bwd", m, 1024,
                                          2816, False, True, gen, cs.QAT_QS),
                         "quant_matmul_bwd"))
        rows.append(_row(cs.check_batched_bwd(torch, timer, qmm, ref, 32, 1280, 1024, 512, gen,
                                              cs.MOE_QS), "quant_matmul_bwd_batched"))
    elif task == "f32_bwd":
        m = 8 * 512
        for mm, k, n, qs in ((64 * 197, 192, 1024, cs.HEAD_QS), (m, 1536, 2048, cs.HEAD_QS),
                             (m, 1024, 2816, cs.QAT_QS)):
            r = _row(cs.check_qat_bwd(torch, timer, qmm, ref, "quant_matmul_bwd", mm, k, n,
                                      False, False, gen, qs), "quant_matmul_bwd")
            x, w, a_s, a_b, ws = cs.qat_operands(torch, mm, k, n, False, gen, qs)
            dy = torch.randn((mm, n), generator=gen, device="cuda")
            r["device_ms"] = device_ms(torch, lambda: qmm.quant_matmul_bwd(
                dy, x, w, a_s, a_b, ws, round_cot=False, **qs))
            rows.append(r)
            del x, w, dy
            torch.cuda.empty_cache()
        r = _row(cs.check_batched_bwd(torch, timer, qmm, ref, 32, 1280, 1024, 512, gen,
                                      cs.MOE_QS, round_cot=False), "quant_matmul_bwd_batched")
        x, w, a_s, a_b, ws = cs.batched_operands(torch, 32, 1280, 1024, 512, gen, cs.MOE_QS)
        dy = torch.randn((32, 1280, 512), generator=gen, device="cuda")
        r["device_ms"] = device_ms(torch, lambda: qmm.quant_matmul_bwd_batched(
            dy, x, w, a_s, a_b, ws, round_cot=False, **cs.MOE_QS))
        rows.append(r)
    elif task == "bwd_bits":
        import hashlib

        def digest(outs):
            return hashlib.sha1(b"".join(t.contiguous().cpu().numpy().tobytes()
                                         for t in outs)).hexdigest()

        m = 8 * 512
        cases = (("quant_matmul_bwd", m, 1024, 2816, False, True, cs.QAT_QS),
                 ("quant_matmul_bwd", m, 1024, 1024, True, True, cs.QAT_QS),
                 ("quant_matmul_bwd", 257, 129, 65, True, True, cs.QAT_QS),
                 ("_split_bwd", m, 1536, 2048, False, False, cs.HEAD_QS),
                 ("_split_bwd", m, 1024, 2816, False, True, cs.QAT_QS))
        for name, mm, k, n, k_side, round_cot, qs in cases:
            x, w, a_s, a_b, ws = cs.qat_operands(torch, mm, k, n, k_side, gen, qs)
            dy = torch.randn((mm, n), generator=gen, device="cuda")
            if name == "_split_bwd":
                outs = qmm._split_bwd(dy, x, w, a_s, a_b, ws, qs, round_cot)
            else:
                outs = qmm.quant_matmul_bwd(dy, x, w, a_s, a_b, ws, round_cot=round_cot, **qs)
            rows.append({"name": name, "shape": [mm, k, n], "round_cot": round_cot,
                         "digest": digest(outs)})
        x, w, a_s, a_b, ws = cs.batched_operands(torch, 32, 1280, 1024, 512, gen, cs.MOE_QS)
        dy = torch.randn((32, 1280, 512), generator=gen, device="cuda")
        rows.append({"name": "quant_matmul_bwd_batched", "shape": [32, 1280, 1024, 512],
                     "round_cot": True, "digest": digest(qmm.quant_matmul_bwd_batched(
                         dy, x, w, a_s, a_b, ws, **cs.MOE_QS))})
    elif task == "quant_bits":
        import hashlib
        from repro_torch.kernels import bin_stats as bs, fake_quant as fq

        def digest(outs):  # bf16 read as its 16-bit patterns
            return hashlib.sha1(b"".join(
                (t.view(torch.int16) if t.dtype == torch.bfloat16 else t)
                .contiguous().cpu().numpy().tobytes() for t in outs)).hexdigest()

        def add(name, shape, outs, **kw):
            rows.append({"name": name, "shape": list(shape), "digest": digest(outs), **kw})

        m, f32, bf16 = 8 * 512, torch.float32, torch.bfloat16
        for mm, k, n, k_side, qs in ((m, 1024, 2816, False, cs.QAT_QS),
                                     (m, 1024, 1024, True, cs.QAT_QS),
                                     (257, 129, 65, True, cs.QAT_QS),
                                     (m, 1024, 512, False, cs.MOE_QS)):
            args = cs.qat_operands(torch, mm, k, n, k_side, gen, qs)
            add("quant_matmul", (mm, k, n), [qmm.quant_matmul(*args, **qs)])
            add("fwd_prologue", (mm, k, n), qmm.fwd_prologue(*args, **qs))
        args = cs.batched_operands(torch, 32, 1280, 1024, 512, gen, cs.MOE_QS)
        add("quant_matmul_batched", (32, 1280, 1024, 512),
            [qmm.quant_matmul_batched(*args, **cs.MOE_QS)])
        args = cs.qat_operands(torch, m, 1024, 2816, False, gen, cs.QAT_QS)
        dy = torch.randn((m, 2816), generator=gen, device="cuda")
        for name in ("quant_matmul_dx", "quant_matmul_dw"):
            add(name, (m, 1024, 2816), getattr(qmm, name)(dy, *args, round_cot=False,
                                                          **cs.QAT_QS))
        for planes in (1, 3):
            rows.append({"name": f"bwd_prologue ({planes})", "shape": [m, 1024, 2816],
                         "ms": timer.ms(lambda p=planes: qmm.bwd_prologue(
                             dy, *args, planes=p, **cs.QAT_QS))})
        rows.append({"name": "fwd_prologue", "shape": [m, 1024, 2816],
                     "ms": timer.ms(lambda: qmm.fwd_prologue(*args, **cs.QAT_QS))})
        del args, dy
        for packed in (False, True):
            x, _, w, scale = cs._int_operands(torch, packed, 32, 4096, 14336, gen)
            kern = qmm.int4_matmul if packed else qmm.int_matmul
            add(kern.__name__, (4, 4096, 14336), [kern(x[:4], w, scale)])
            add(kern.__name__, (32, 4096, 14336), [kern(x, w, scale)])
        x = torch.randn((4096, 1024), generator=gen, device="cuda") * 0.1
        add("fake_quant_2d", (4096, 1024), [fq.fake_quant_2d(
            x, torch.tensor(0.05, device="cuda"), None, q_n=8, q_p=7)])
        add("bin_stats_2d", (4096, 1024), [bs.bin_stats_2d(
            x, torch.tensor(0.05, device="cuda"), q_n=8, q_p=7)])
        xb = (torch.randn((4096, 2816), generator=gen, device="cuda") * 2).to(bf16)
        add("fake_quant_2d", (4096, 2816), [fq.fake_quant_2d(
            xb, torch.tensor(0.3, device="cuda"), torch.tensor(-0.2, device="cuda"),
            q_n=0, q_p=15)])
        xr = torch.randn((32, 1024 * 512), generator=gen, device="cuda") * 1024 ** -0.5
        rs = 2 * xr.abs().mean(dim=1, keepdim=True) / 3 ** 0.5
        add("fake_quant_rows", (32, 524288), [fq.fake_quant_rows(xr, rs, q_n=4, q_p=3)])
        del x, xb, xr
        rows.append({**_row(cs.check_fake_quant(
            torch, timer, fq, ref, "kernel_bench wq", (4096, 1024), f32, 8, 7, gen,
            std=0.1, scale=0.05), "fake_quant_2d")})
        rows.append({**_row(cs.check_fake_quant_rows(
            torch, timer, fq, ref, "granite-moe experts w3", (32, 1024 * 512), f32, 4, 3,
            gen, std=1024 ** -0.5), "fake_quant_rows")})
    elif task == "serving":
        from repro_torch.kernels import decode_attention as da
        own = own_rows()
        for m, k, n in own.INT4_ROWS:
            rows.append(_row(cs.check_matmul(torch, timer, qmm, ref, True, m, k, n, gen),
                             "int4_matmul"))
        for m, k, n in own.INT8_ROWS + (KERNEL_BENCH_INT8,):
            rows.append(_row(cs.check_matmul(torch, timer, qmm, ref, False, m, k, n, gen),
                             "int_matmul"))
        for storage, c, window, softcap, qd in (
                ("int8", 1, 0, 0.0, None), ("fp", 1, 0, 0.0, None),
                ("int4", 1, 0, 0.0, None), ("int8", 32, 0, 0.0, None),
                ("int8", 1, 64, 50.0, None), ("int4", 32, 64, 50.0, None),
                ("fp", 32, 0, 50.0, None), ("int8", 1, 0, 0.0, torch.float32),
                ("int4", 32, 64, 50.0, torch.float32)):
            rows.append(_row(cs.check_attention(
                torch, timer, da, ref, storage=storage, c=c, window=window,
                softcap=softcap, gen=gen, qdtype=qd), "pooled_decode_attention"))
    elif task == "quantizer":
        from repro_torch.kernels import bin_stats as bs
        for args, kw in own_rows().BIN_STATS_ROWS:
            r = cs.check_bin_stats(torch, timer, bs, ref, *args, gen, **kw)
            w = torch.randn(args[1], generator=gen, device="cuda") * args[1][-1] ** -0.5
            dev = device_ms(torch, lambda: bs.bin_stats_2d(
                w, torch.tensor(0.05, device="cuda"), q_n=args[2], q_p=args[3]))
            rows.append({**_row(r, "bin_stats_2d"), "bins": r["bins"], "case": r["case"],
                         "device_ms": dev})
            torch.cuda.empty_cache()
    elif task == "head_plans" and hasattr(qmm, "int8_col_tiles"):
        k, n = 4096, 49152
        x, _, w, scale = cs._int_operands(torch, False, 32, k, n, gen)
        plan = qmm.int4_plan
        try:
            for splits in (1, 2, 3):
                def variant(kk, nn, splits=splits):
                    pl = plan(kk, nn)
                    per = -(-pl["ksteps"] // splits)
                    return dict(pl, splits=-(-pl["ksteps"] // per), ksteps_per_split=per)
                qmm.int4_plan = variant
                for m in (4, 32):
                    rows.append({"name": "int_matmul", "shape": [m, k, n],
                                 "splits": variant(k, n)["splits"],
                                 "ms": timer.ms(lambda: qmm.int_matmul(x[:m], w, scale))})
        finally:
            qmm.int4_plan = plan
    elif task == "prof_decode":
        from repro_torch.launch import profile_decode
        r = profile_decode.main([])
        # the costliest kernels, and (where the checkout lists them) every
        # kernel of the port's sources, however small
        seen = {k["name"]: k for k in r["top_kernels"] + r.get("named_kernels", [])}
        per_kernel = {name: sum(k["ms_per_step"] for k in seen.values()
                                if any(p in k["name"] for p in pats))
                      for name, pats in DECODE_KERNELS.items()}
        out.update({k: r[k] for k in ("step_host_ms", "step_device_elapsed_ms",
                                      "device_busy_ms_per_step", "device_busy_share",
                                      "device_kernels_per_step", "top_kernels",
                                      "launches_per_step", "decode_tok_s")},
                   kernel_ms_per_step=per_kernel)
    elif task == "steps_qwen":
        from repro_torch.launch import train
        ckpt = root / "build" / "chip_compare_ckpt"
        shutil.rmtree(ckpt, ignore_errors=True)
        run = cs.train_phase(torch, ops, train, [
            "--arch", "qwen1.5-0.5b", "--quant", "w4a4", "--kd", "mckd", "--batch", "8",
            "--seq", "512", "--save-every", "100", "--ckpt", str(ckpt), "--steps", "4"], 0, 4)
        shutil.rmtree(ckpt, ignore_errors=True)
        rep = run["report"]
        out.update(step_seconds=rep.step_seconds, losses=rep.losses,
                   peak_gib=(rep.peak_bytes or 0) / 2**30)
    elif task == "steps_xlstm_tp":
        out.update(xlstm_tp_steps(root))
    elif task == "steps_moe":
        run = cs.moe_train_phase(torch, ops, steps=5)
        rep = run["report"]
        out.update(step_seconds=rep.step_seconds, losses=rep.losses,
                   peak_gib=(rep.peak_bytes or 0) / 2**30)
    elif task in ("prof_qwen", "prof_moe"):
        from repro_torch.launch import profile_train
        arch = "qwen1.5-0.5b" if task == "prof_qwen" else "granite-moe-1b-a400m"
        torch.cuda.reset_peak_memory_stats()
        r = profile_train.main(["--arch", arch])
        out.update({k: r[k] for k in ("step_host_ms", "device_busy_ms_per_step",
                                      "device_busy_share", "device_kernels_per_step",
                                      "named_kernels", "losses") if k in r},
                   **{k: r[k] for k in ("obr_ms", "osc_update_ms") if k in r},
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if task in ROW_TASKS:
        out["rows"] = rows
    return out


def main() -> None:
    if sys.argv[1:2] == ["--rank"]:
        tp_rank(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]), Path(sys.argv[5]))
        return
    if sys.argv[1:2] == ["--one"]:
        print("RESULT " + json.dumps(run_one(Path(sys.argv[2]).resolve(), sys.argv[3])),
              flush=True)
        return
    if len(sys.argv) < 3 or any(t not in TASKS for t in sys.argv[2:]):
        raise SystemExit(f"usage: chip_compare.py PARENT_ROOT TASK [TASK ...]; tasks {TASKS}")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_compare: torch.cuda.is_available() is False: this "
                         "comparison needs a GPU")
    parent = Path(sys.argv[1]).resolve()
    if not (parent / "chip_smoke.py").is_file():
        raise SystemExit(f"chip_compare: no chip_smoke.py in {parent}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for task in sys.argv[2:]:
        results = []
        for side, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                           ("parent", parent)):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--one",
                                   str(root), task], capture_output=True, text=True)
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode != 0 or not lines:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"chip_compare: {task} on {side} ({root}) failed")
            results.append({"side": side, "wall_s": time.perf_counter() - t0,
                            **json.loads(lines[-1][len("RESULT "):])})
            print(f"{task} {side}: {time.perf_counter() - t0:.1f} s", flush=True)
        print(json.dumps({"task": task, "device": smi, "runs": results}), flush=True)


if __name__ == "__main__":
    main()
