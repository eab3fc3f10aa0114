"""Deterministic serving load benchmark: continuous vs static batching.

    PYTHONPATH=src python -m repro_torch.launch.serving_bench          # sweep
    PYTHONPATH=src python -m repro_torch.launch.serving_bench --smoke  # gate

The port's twin of `benchmarks/serving_bench.py`, with the same workload,
sweep, gates and JSON schema, over the port's own engine and simulation
(`repro_torch.serve`). A seeded load generator (Poisson arrivals, mixed
prompt/output lengths) drives `ServeEngine` over `SimExecutor`, a
cost-modeled fake with an injectable `SimClock`, so every number replays
bit for bit: no device, no wall-clock noise, and no number it writes is a
measurement of any hardware. The sweep runs each offered load under both
admission policies at EQUAL slot count; the headline claim (continuous
batching beats one-batch-at-a-time static admission on total throughput)
is asserted at the saturating rate (under-saturated rates tie exactly,
since no queue ever forms) and recorded per rate as
`continuous_beats_static`. The JSON goes to `--out` only (default
`build/serving_bench.json` at the root of the checkout).

`--smoke` runs one tiny config and fails nonzero unless (a) throughput is
nonzero, (b) every request's token stream is strictly increasing (the sim
model's argmax is pos+1, so any scheduler/slot-recycling bug that feeds a
wrong position or crosses streams breaks monotonicity), (c) a replay
with the same seed reproduces the streams exactly, (d) continuous
batching beats static admission, and (e) a degraded engine (one
quarantined slot of three) matches an equivalent 2-slot engine exactly:
capacity degrades proportionally, never collapses (the serving-sentinel
contract).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np

from repro_torch.serve import (SamplingParams, Scheduler, ServeEngine,
                               SimClock, SimCost, SimExecutor, poisson_arrivals)

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "serving_bench.json"
PROMPT_LENS = (8, 24, 48)
NEW_TOKENS = (4, 16, 32)


def make_workload(seed: int, n_requests: int, rate: float):
    """(arrival_time, prompt_tokens, max_new) triples, fully seeded."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(rng, n_requests, rate)
    reqs = []
    for i in range(n_requests):
        plen = int(rng.choice(PROMPT_LENS))
        nnew = int(rng.choice(NEW_TOKENS))
        prompt = rng.integers(1, 1000, size=plen).astype(np.int32)
        reqs.append((float(arrivals[i]), prompt, nnew))
    return reqs


def run_load(policy: str, workload, *, n_slots: int, max_len: int,
             chunk: int = 16, max_queue: int = 1024,
             quarantine: tuple = ()) -> dict:
    """Replay one workload under one admission policy; returns the metrics
    summary plus the per-request token streams (for determinism checks).
    `quarantine` pre-fences slots (degraded-capacity scenario: the engine
    must keep serving on the remaining slots)."""
    clk = SimClock()
    ex = SimExecutor(clk, n_slots=n_slots, max_len=max_len, chunk=chunk,
                     cost=SimCost())
    eng = ServeEngine(ex, Scheduler(max_len=max_len, max_queue=max_queue,
                                    policy=policy), clock=clk.now)
    for slot in quarantine:
        eng.quarantine(slot, reason="bench_degraded")
    pending = list(workload)
    guard = 0
    while pending or eng.has_work:
        while pending and pending[0][0] <= clk.now():
            _, prompt, nnew = pending.pop(0)
            ok, reason = eng.submit(prompt,
                                    SamplingParams(max_new_tokens=nnew))
            assert ok, reason
        worked = eng.step()
        if not worked:
            if pending:
                clk.advance(pending[0][0] - clk.now())
            else:
                break
        guard += 1
        assert guard < 2_000_000, "simulation failed to drain"
    out = eng.metrics.summary()
    out["streams"] = {rid: r.tokens for rid, r in sorted(eng.results.items())}
    return out


def sweep(seed: int, *, n_requests: int, rates, n_slots: int,
          max_len: int) -> dict:
    cells = []
    beats = {}
    for rate in rates:
        workload = make_workload(seed, n_requests, rate)
        row = {"offered_rate_req_s": rate}
        for policy in ("continuous", "static"):
            s = run_load(policy, workload, n_slots=n_slots, max_len=max_len)
            s.pop("streams")
            row[policy] = s
        cont = row["continuous"]["throughput"]["total_tok_s"]
        stat = row["static"]["throughput"]["total_tok_s"]
        row["continuous_over_static"] = cont / stat if stat > 0 else 0.0
        beats[str(rate)] = bool(cont > stat)
        cells.append(row)
    return {
        "schema": "serving-bench/v1",
        "seed": seed,
        "config": {"n_requests": n_requests, "n_slots": n_slots,
                   "max_len": max_len, "prompt_lens": list(PROMPT_LENS),
                   "new_tokens": list(NEW_TOKENS),
                   "cost_model": dataclasses.asdict(SimCost())},
        "sweep": cells,
        # under-saturated rates tie exactly (no queue forms, the policies
        # make identical decisions); the claim that matters is at saturation
        "continuous_beats_static": beats,
        "continuous_beats_static_at_saturation": beats[str(max(rates))],
    }


def smoke() -> int:
    workload = make_workload(seed=7, n_requests=12, rate=30.0)
    a = run_load("continuous", workload, n_slots=3, max_len=96, chunk=8)
    if a["throughput"]["total_tok_s"] <= 0.0:
        print("FAIL: zero throughput")
        return 1
    if a["requests"]["finished"] != 12:
        print(f"FAIL: {a['requests']['finished']}/12 requests finished")
        return 1
    for rid, stream in a["streams"].items():
        if not stream or any(b <= x for x, b in zip(stream, stream[1:])):
            print(f"FAIL: non-monotone token stream for {rid}: {stream}")
            return 1
    b = run_load("continuous", workload, n_slots=3, max_len=96, chunk=8)
    if a["streams"] != b["streams"]:
        print("FAIL: replay with the same seed diverged")
        return 1
    s = run_load("static", workload, n_slots=3, max_len=96, chunk=8)
    cont, stat = (a["throughput"]["total_tok_s"],
                  s["throughput"]["total_tok_s"])
    print(f"[smoke] 12 requests, 3 slots: continuous {cont:.0f} tok/s vs "
          f"static {stat:.0f} tok/s; streams monotone, replay exact")
    if cont <= stat:
        print("FAIL: continuous batching did not beat static admission")
        return 1
    # degraded mode (serving sentinel): one quarantined slot must degrade
    # throughput PROPORTIONALLY — the engine behaves exactly like a fresh
    # (n_slots - 1)-slot engine (slot numbering never leaks into streams or
    # timings) — instead of collapsing or losing requests
    d = run_load("continuous", workload, n_slots=3, max_len=96, chunk=8,
                 quarantine=(0,))
    ref = run_load("continuous", workload, n_slots=2, max_len=96, chunk=8)
    deg, full = (d["throughput"]["total_tok_s"], cont)
    print(f"[smoke] degraded (3 slots, 1 quarantined): {deg:.0f} tok/s vs "
          f"{full:.0f} healthy, == 2-slot {ref['throughput']['total_tok_s']:.0f}")
    if d["requests"]["finished"] != 12:
        print(f"FAIL: degraded run lost requests "
              f"({d['requests']['finished']}/12 finished)")
        return 1
    if d["streams"] != ref["streams"] or \
            d["throughput"]["total_tok_s"] != ref["throughput"]["total_tok_s"]:
        print("FAIL: quarantined-slot run diverged from the equivalent "
              "2-slot engine")
        return 1
    if deg < 0.5 * full:
        print(f"FAIL: one quarantined slot of three collapsed throughput "
              f"({deg:.0f} vs {full:.0f} tok/s)")
        return 1
    if d["faults"]["quarantined_slots"] != 1:
        print("FAIL: degraded run did not report its quarantined slot")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny deterministic gate, no JSON output")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128, dest="max_len")
    ap.add_argument("--rates", type=float, nargs="+",
                    default=[2.0, 8.0, 32.0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke()

    result = sweep(args.seed, n_requests=args.requests, rates=args.rates,
                   n_slots=args.slots, max_len=args.max_len)
    for row in result["sweep"]:
        c, s = row["continuous"], row["static"]
        print(f"rate {row['offered_rate_req_s']:6.1f} req/s | "
              f"continuous {c['throughput']['total_tok_s']:7.0f} tok/s "
              f"(ttft p95 {c['ttft_s']['p95']:.3f}s, occ "
              f"{c['occupancy']['mean']:.2f}) | "
              f"static {s['throughput']['total_tok_s']:7.0f} tok/s "
              f"(ttft p95 {s['ttft_s']['p95']:.3f}s, occ "
              f"{s['occupancy']['mean']:.2f}) | "
              f"{row['continuous_over_static']:.2f}x")
    # continuous must never LOSE to static, and must strictly win once the
    # offered load saturates the slots (low rates tie: no queue ever forms)
    for row in result["sweep"]:
        if (row["continuous"]["throughput"]["total_tok_s"]
                < row["static"]["throughput"]["total_tok_s"] - 1e-9):
            print("FAIL: continuous batching lost to static at rate "
                  f"{row['offered_rate_req_s']}")
            return 1
    if not result["continuous_beats_static_at_saturation"]:
        print("FAIL: continuous batching did not beat static at saturation")
        return 1
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
