"""Where a pooled decode step's time goes on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode [--out FILE] \
        [--arch granite-moe-1b-a400m --quant w3a3]

The serving path of `chip_smoke.py`'s main run: full-width granite-8b, all
36 layers, w4a4 weights, int8 KV, 4 slots (or `--arch` / `--quant`, as
phase 12 serves granite-moe-1b-a400m at w3a3). Builds random serving params
(seed 0), prefills every slot with a 128-token prompt, then times 8 decode
steps the way the engine runs them (each step ends by copying its logits
to the host): host wall ms per step, the device's elapsed ms (CUDA
events), and, from torch.profiler over the same steps, the device time per
kernel and the device's busy share of the window: the costliest kernels
(`top_kernels`) and every kernel of the port's CUDA sources, which live in
an anonymous namespace (`named_kernels`), however small. Prints one JSON
line last; `--out` also writes it to a file.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.policy import get_preset
from repro_torch.kernels.ops import launch_counts, reset_launch_counts, resolve_device
from repro_torch.models import model as M

ARCH, QUANT, KV_BITS = "granite-8b", "w4a4", 8
SLOTS, PROMPT_LEN, STEPS = 4, 128, 8


def device_summary(prof, window_ms: float, steps: int, top_n: int,
                   named: str = "") -> dict:
    """What a torch.profiler window says of the device: busy ms a step and
    its share of the window, kernels a step, the `top_n` costliest kernel
    names with their calls and ms a step, and (`named`) every kernel whose
    name holds that string, however cheap."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    row = lambda e: {"name": e.key[:90], "calls_per_step": e.count / steps,
                     "ms_per_step": e.self_device_time_total / 1e3 / steps}
    out = {
        "device_busy_ms_per_step": busy_ms / steps,
        "device_busy_share": busy_ms / window_ms if window_ms else None,
        "device_kernels_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [row(e) for e in top[:top_n]],
    }
    if named:
        out["named_kernels"] = [row(e) for e in top if named in e.key]
    return out


def print_summary(result: dict) -> None:
    for k in result["top_kernels"] + result.get("named_kernels", []):
        print(f"  {k['ms_per_step']:9.3f} ms/step  {k['calls_per_step']:7.1f} calls  "
              f"{k['name']}")
    print(f"step: host {result['step_host_ms']:.2f} ms, device elapsed "
          f"{result['step_device_elapsed_ms']:.2f} ms, device busy "
          f"{result['device_busy_ms_per_step']:.2f} ms "
          f"(share {result['device_busy_share']}) in "
          f"{result['device_kernels_per_step']:.0f} kernels")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.profile_decode")
    ap.add_argument("--out", default="")
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--quant", default=QUANT)
    args = ap.parse_args(argv)
    device = resolve_device("cuda")
    cfg = get_config(args.arch)
    qcfg = get_preset(args.quant).replace(kv_cache_bits=KV_BITS, a_bits=32)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_serving_params(cfg, qcfg, gen, device)
    max_len = PROMPT_LEN + STEPS + 4
    pool = M.init_cache(cfg, qcfg, SLOTS, max_len, device)
    tokens = torch.randint(0, cfg.vocab_size, (SLOTS, PROMPT_LEN),
                           generator=gen, device=device, dtype=torch.int32)
    pos = torch.arange(PROMPT_LEN, device=device, dtype=torch.int32)
    logits, pool = M.prefill_step(params, pool, {
        "tokens": tokens, "pos": pos[None].expand(SLOTS, -1)}, cfg, qcfg)
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    p = PROMPT_LEN

    def step():
        nonlocal tok, pool, p
        lg, pool = M.decode_step(params, pool, {
            "tokens": tok, "pos": torch.full((SLOTS,), p, dtype=torch.int32,
                                             device=device)}, cfg, qcfg)
        host = lg[:, 0].float().cpu()  # the engine reads every step's logits
        tok = torch.from_numpy(host.numpy().argmax(-1)[:, None]).to(
            device=device, dtype=torch.int32)
        p += 1

    for _ in range(2):  # warm-up: kernel libraries loaded, allocator warm
        step()
    torch.cuda.synchronize()
    reset_launch_counts()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    host_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
    window_ms = start.elapsed_time(end)
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "quant": args.quant,
        "kv_bits": KV_BITS, "slots": SLOTS,
        "cache_len": p, "steps": STEPS,
        "device": torch.cuda.get_device_name(device),
        "step_host_ms": sorted(host_ms)[len(host_ms) // 2],
        "step_device_elapsed_ms": window_ms / STEPS,
        **device_summary(prof, window_ms, STEPS, top_n=40, named="(anonymous namespace)::"),
        "launches_per_step": {k: v / STEPS for k, v in launch_counts().items()},
        "decode_tok_s": SLOTS * 1e3 / (window_ms / STEPS),
    }
    print_summary(result)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return result


if __name__ == "__main__":
    main()
