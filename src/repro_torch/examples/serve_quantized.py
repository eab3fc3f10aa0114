"""Batched serving of a quantized model: prefill + decode with int8 weights
and an int8 per-head-scaled KV cache (the paper's MDQ granularity applied to
inference state); twin of `examples/serve_quantized.py`.

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized \
        --new-tokens 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.policy import QuantConfig
from repro_torch.data.synthetic import DataConfig, sample_batch
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.models.common import convert_to_serving
from repro_torch.tree import leaves


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32, dest="prompt_len")
    ap.add_argument("--new-tokens", type=int, default=16, dest="new_tokens")
    ap.add_argument("--kv-bits", type=int, default=8, dest="kv_bits")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(get_config(args.arch))
    qcfg = QuantConfig(w_bits=8, a_bits=32, mode="mdq",
                       kv_cache_bits=args.kv_bits)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, qcfg, gen, device)
    sparams = convert_to_serving(params, qcfg)

    fp_bytes, srv_bytes = _bytes(params), _bytes(sparams)
    print(f"arch={cfg.name}  weights: {fp_bytes / 2**20:.1f}MiB fp -> "
          f"{srv_bytes / 2**20:.1f}MiB int-coded "
          f"({fp_bytes / srv_bytes:.1f}x smaller)")

    b, s = args.batch, args.prompt_len
    total = s + args.new_tokens
    prompts = torch.from_numpy(sample_batch(cfg, DataConfig(), 0, b, s)["tokens"]).to(device)

    # a full-size cache, the prompt replayed through decode_step token by
    # token (simple, robust path; launch.serve prefills in chunks instead)
    cache = M.init_cache(cfg, qcfg, b, total, device)
    pos = lambda t: torch.full((b,), t, dtype=torch.int32, device=device)  # noqa: E731

    t0 = time.monotonic()
    last = None
    with torch.no_grad():
        for t in range(s):
            last, cache = M.decode_step(sparams, cache,
                                        {"tokens": prompts[:, t:t + 1], "pos": pos(t)},
                                        cfg, qcfg)
        out_tokens = []
        tok = torch.argmax(last[:, 0], -1)[:, None].to(torch.int32)
        for t in range(s, total):
            out_tokens.append(tok)
            logits, cache = M.decode_step(sparams, cache, {"tokens": tok, "pos": pos(t)},
                                          cfg, qcfg)
            tok = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    gen_toks = torch.cat(out_tokens, dim=1)
    print(f"generated {args.new_tokens} tokens x {b} sequences "
          f"in {dt:.2f}s ({b * total / dt:.0f} tok/s incl. prompt replay)")
    print("sample continuation ids:", gen_toks[0].tolist())

    cache_bytes = _bytes(cache)
    print(f"KV cache: {cache_bytes / 2**20:.2f}MiB at int{args.kv_bits} "
          f"(bf16 would be ~{cache_bytes * (2 if args.kv_bits == 8 else 4) / 2**20:.2f}MiB)")
    return gen_toks


if __name__ == "__main__":
    main()
