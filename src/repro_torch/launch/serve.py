"""Serving launcher: continuous-batching engine over int-coded weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
        --quant w4a4 --kv-bits 8 --batch 8 --prompt-len 128 --new-tokens 32

PyTorch counterpart of `repro.launch.serve`, same flags (without
--model-parallel: sharding is not ported yet) plus --device (cuda unless
"cpu" is asked for; no silent fallback) and --layers (cut the depth of the
model, 0 = the config's). Params are random (torch generator seeded with
0), built directly as serving int codes (nibble-packed at <= 4 bits); one
pooled (optionally int8/int4) KV cache multiplexes all requests through
slot recycling. Prefill and decode tokens/sec are reported separately.

The serving sentinel is armed as in the JAX launcher: non-finite logits rows
fault only their request, a persistent executor failure rebuilds from params
and replays in-flight work, and SIGTERM/SIGINT (PreemptionGuard) triggers a
graceful drain bounded by --drain-timeout.

`greedy_generate` is the engine-free batched loop: ONE chunked-prefill step
over the whole prompt, then new_tokens - 1 single-token decode steps — the
engine's per-request outputs match it.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config, reduced_config
from repro_torch.core.policy import get_preset
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import (FaultPolicy, ModelExecutor, SamplingParams,
                               Scheduler, ServeEngine)
from repro_torch.train.fault_tolerance import PreemptionGuard


def greedy_generate(step, params, cache, prompts: torch.Tensor, new_tokens: int):
    """Greedy batched generation via the chunked prefill path.

    `step(params, cache, {"tokens": (B,C), "pos": (B,C)})` is a
    prefill_step. The prompt runs as ONE batched call, then
    `new_tokens - 1` C=1 decode calls; the first generated token is the
    argmax of the prefill's last-position logits and the final decode's
    argmax is emitted. Returns (tokens (batch, new_tokens), cache).
    """
    batch, prompt_len = prompts.shape
    assert prompt_len >= 1 or new_tokens <= 0, (
        "greedy_generate needs at least one prompt token to seed generation "
        f"(got prompt_len={prompt_len}, new_tokens={new_tokens})")
    dev = prompts.device
    if new_tokens <= 0:
        return torch.zeros((batch, 0), dtype=torch.int32, device=dev), cache
    pos = torch.arange(prompt_len, dtype=torch.int32, device=dev)[None].expand(
        batch, prompt_len)
    logits, cache = step(params, cache, {"tokens": prompts, "pos": pos})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    outs = []
    for i in range(new_tokens):
        outs.append(tok)
        if i + 1 < new_tokens:
            pos = torch.full((batch, 1), prompt_len + i, dtype=torch.int32,
                             device=dev)
            logits, cache = step(params, cache, {"tokens": tok, "pos": pos})
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    return torch.cat(outs, 1), cache


@dataclasses.dataclass
class ServeRun:
    """What one `main` run served, for callers that check it further."""
    cfg: object
    qcfg: object
    params: dict
    engine: ServeEngine
    summary: dict
    prompts: np.ndarray
    device: torch.device
    peak_bytes: Optional[int]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="granite-8b", choices=ARCH_IDS)
    ap.add_argument("--quant", default="w8a8")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests submitted")
    ap.add_argument("--slots", type=int, default=0,
                    help="KV pool slots (0 = min(batch, 4))")
    ap.add_argument("--prompt-len", type=int, default=16, dest="prompt_len")
    ap.add_argument("--new-tokens", type=int, default=8, dest="new_tokens")
    ap.add_argument("--chunk", type=int, default=8,
                    help="prefill chunk width (tokens per prefill step)")
    ap.add_argument("--kv-bits", type=int, default=8, dest="kv_bits")
    ap.add_argument("--drain-timeout", type=float, default=30.0,
                    dest="drain_timeout",
                    help="graceful-drain budget (s) on SIGTERM/preemption")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0 = all)")
    return ap


def main(argv=None) -> ServeRun:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced_config(cfg)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    qcfg = get_preset(args.quant).replace(kv_cache_bits=args.kv_bits,
                                          a_bits=32)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_serving_params(cfg, qcfg, gen, device)

    max_len = args.prompt_len + args.new_tokens
    n_slots = args.slots or min(args.batch, 4)

    def make_executor():
        # sentinel rebuild path: params/cfg stay valid, only the executor
        # (its caches) is rebuilt; in-flight work is replayed
        return ModelExecutor(params, cfg, qcfg, n_slots=n_slots,
                             max_len=max_len, chunk=args.chunk)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    guard = PreemptionGuard()
    try:
        engine = ServeEngine(
            make_executor(), Scheduler(max_len=max_len, max_queue=args.batch),
            executor_factory=make_executor, guard=guard,
            faults=FaultPolicy(drain_timeout_s=args.drain_timeout))
        prompts = sample_batch(cfg, DataConfig(), 0, args.batch,
                               args.prompt_len)["tokens"]
        for i in range(args.batch):
            ok, reason = engine.submit(
                prompts[i], SamplingParams(max_new_tokens=args.new_tokens),
                rid=f"req-{i}")
            if not ok:
                raise RuntimeError(f"request req-{i} refused: {reason}")
        summary = engine.run_until_idle()
    finally:
        guard.restore_handlers()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)

    tp = summary["throughput"]
    print(f"arch={cfg.name} layers={cfg.n_layers} device={device} "
          f"quant={args.quant} int{args.kv_bits}-KV slots={n_slots} "
          f"requests={args.batch}: prefill {tp['prefill_tok_s']:.0f} tok/s, "
          f"decode {tp['decode_tok_s']:.0f} tok/s "
          f"(occupancy {summary['occupancy']['mean']:.2f})")
    if peak is not None:
        print(f"peak device memory {peak / 2**30:.2f} GiB "
              f"({torch.cuda.get_device_name(device)})")
    faults = summary["faults"]
    if any(faults.values()):
        print("faults:", {k: v for k, v in faults.items() if v})
    print("sample:", engine.results["req-0"].tokens)
    return ServeRun(cfg, qcfg, params, engine, summary, prompts, device, peak)


if __name__ == "__main__":
    main()
