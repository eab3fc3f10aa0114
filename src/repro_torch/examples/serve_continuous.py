"""Continuous-batching serving: one pooled KV cache, slot recycling, chunked
prefill, the deterministic request/metrics lifecycle — and the serving
sentinel's deadline + graceful-drain paths (twin of
`examples/serve_continuous.py`).

    PYTHONPATH=src python -m repro_torch.examples.serve_continuous \
        --kv-bits 8 [--device cpu]

Submits a burst of mixed-length requests against a 2-slot engine — more
requests than slots, so finished slots are recycled mid-flight. One request
carries a tight end-to-end deadline (`deadline_s`): it is cut with
finish_reason "deadline" (partial tokens kept) or shed at admission if it
never reaches a slot. With --drain-after N the example calls
`engine.drain(timeout_s=0)` after N engine steps — the SIGTERM/preemption
path — which stops admission, sheds the queue, and cuts in-flight work
with partial results (finish_reason "drained"). No request is ever
silently lost: every admitted rid lands in `engine.results`, queue-side
sheds land in the metrics `faults` section. Fault-free streams are
identical to what each request would produce alone
(tests/test_torch_serve_engine.py pins this).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.policy import QuantConfig
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as M
from repro_torch.serve import ModelExecutor, SamplingParams, Scheduler, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b",
                    help="attention-only pattern (local ring + global)")
    ap.add_argument("--kv-bits", type=int, default=8, dest="kv_bits")
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--drain-after", type=int, default=0, dest="drain_after",
                    help="engine steps before a graceful drain "
                         "(0 = run to completion, no drain)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = reduced_config(get_config(args.arch))
    qcfg = QuantConfig(w_bits=8, a_bits=32, mode="mdq",
                       kv_cache_bits=args.kv_bits)
    gen = torch.Generator(device=device).manual_seed(0)
    params = M.init_params(cfg, qcfg, gen, device)

    max_len = 48
    executor = ModelExecutor(params, cfg, qcfg, n_slots=args.slots,
                             max_len=max_len, chunk=8)
    engine = ServeEngine(executor, Scheduler(max_len=max_len))

    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(3, 20))
        ok, reason = engine.submit(
            prompt, SamplingParams(max_new_tokens=int(rng.integers(4, 9))),
            rid=f"req-{i}")
        if not ok:
            raise RuntimeError(f"req-{i} refused: {reason}")
    # one more request with a tight end-to-end deadline: it finishes with
    # reason "deadline" (partial tokens) or is shed at admission — either
    # way it can never rot in the queue or hog a slot past its budget
    engine.submit(rng.integers(1, cfg.vocab_size, 8),
                  SamplingParams(max_new_tokens=8), rid="req-deadline",
                  deadline_s=0.25)

    if args.drain_after > 0:
        # the preemption path: run a few steps, then drain gracefully —
        # admission stops, the queue is shed, in-flight work is cut with
        # partial results (timeout_s=0 cuts immediately)
        for _ in range(args.drain_after):
            engine.step()
        summary = engine.drain(timeout_s=0.0)
    else:
        summary = engine.run_until_idle()

    print(f"{args.requests}+1 requests over {args.slots} slots "
          f"(int{args.kv_bits} KV, {cfg.name}):")
    for rid in sorted(engine.results):
        r = engine.results[rid]
        print(f"  {rid}: prompt {r.prompt_len:2d} tok -> "
              f"{r.tokens} ({r.finish_reason})")
    shed = [rid for rid, rec in sorted(engine.metrics.records.items())
            if rid not in engine.results and rec.finish_reason is not None]
    for rid in shed:
        print(f"  {rid}: shed in queue "
              f"({engine.metrics.records[rid].finish_reason})")
    print(json.dumps(summary, indent=2, sort_keys=True))
    return engine


if __name__ == "__main__":
    main()
