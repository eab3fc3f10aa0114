"""Serving metrics: per-request latency accounting + engine-level summary.

All timestamps come from the engine's injectable clock (monotonic seconds —
real or simulated), so the same collector backs production logs, the
deterministic load benchmark, and tests. `summary()` returns a plain dict
(schema below) that BENCH_serving.json and sentinel-style logs consume:

  schema: "serving-metrics/v1"
  requests: {submitted, admitted, rejected, expired, finished}
  ttft_s / itl_s / queue_wait_s: {p50, p95, mean, max}  (seconds)
  throughput: {prefill_tok_s, decode_tok_s, total_tok_s}
  occupancy: {mean, max}     (generating slots / total slots per decode step)
  tokens: {prompt, generated}
  wall_s: first-arrival .. last-finish span
  faults: {nonfinite_rows, faulted, quarantined_slots, executor_retries,
           executor_rebuilds, replayed, deadline, cancelled, drained,
           shed_queued}   (serving-sentinel events; all zero when healthy)

Every field is present on every run — empty / all-rejected / all-expired
runs emit the same schema with zeroed values, never a KeyError or a
division by zero (pinned by tests/test_serve_faults.py).

"finished" counts requests that held a slot and reached ANY terminal
reason ("eos"/"length", but also "fault"/"deadline"/"cancelled"/"drained"
— they produced a partial GenResult); queue-side terminations (expiry,
deadline shed, cancel, drain shed) never held a slot and are tallied in
`requests.expired` / `faults` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SCHEMA = "serving-metrics/v1"

# serving-sentinel event counters (ROADMAP.md "Serving contract"): the
# schema is fixed so consumers can rely on every key existing, zeroed
FAULT_KEYS = (
    "nonfinite_rows",      # non-finite logits rows detected (prefill+decode)
    "faulted",             # requests finished with reason "fault"
    "quarantined_slots",   # slots fenced out of the free pool
    "executor_retries",    # transient executor-exception retries
    "executor_rebuilds",   # executor rebuilt from params
    "replayed",            # in-flight requests replayed after a rebuild
    "deadline",            # requests terminated by their deadline (any stage)
    "cancelled",           # requests cancelled via cancel(rid) (any stage)
    "drained",             # in-flight requests cut by a graceful drain
    "shed_queued",         # queue-side sheds (deadline/cancel/drain subset)
)


@dataclasses.dataclass
class RequestRecord:
    rid: str
    prompt_len: int
    arrival: float
    admitted: Optional[float] = None
    first_token: Optional[float] = None
    finished: Optional[float] = None
    n_generated: int = 0
    finish_reason: Optional[str] = None
    token_times: list = dataclasses.field(default_factory=list)


def _pct(xs: list, q: float) -> float:
    """Nearest-rank percentile (no numpy: metrics must not touch devices)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    i = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[i])


def _stats(xs: list) -> dict:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "mean": 0.0, "max": 0.0}
    return {"p50": _pct(xs, 50), "p95": _pct(xs, 95),
            "mean": float(sum(xs) / len(xs)), "max": float(max(xs))}


class MetricsCollector:
    """Event sink the engine drives; pure bookkeeping, no clock of its own."""

    def __init__(self):
        self.records: dict[str, RequestRecord] = {}
        self.rejected: int = 0
        self.expired: int = 0
        self.faults: dict[str, int] = {k: 0 for k in FAULT_KEYS}
        self._occupancy: list[float] = []
        self._prefill_tokens = 0
        self._prefill_time = 0.0
        self._decode_tokens = 0
        self._decode_time = 0.0

    # -- request lifecycle ---------------------------------------------------
    def on_submit(self, rid: str, prompt_len: int, now: float) -> None:
        self.records[rid] = RequestRecord(rid, prompt_len, arrival=now)

    def on_reject(self, rid: str, reason: str, now: float) -> None:
        self.rejected += 1

    def on_admit(self, rid: str, now: float) -> None:
        self.records[rid].admitted = now

    def on_expire(self, rid: str, now: float) -> None:
        self.expired += 1
        rec = self.records.get(rid)
        if rec is not None:
            rec.finished = now
            rec.finish_reason = "expired"

    def on_shed(self, rid: str, reason: str, now: float) -> None:
        """A QUEUED request was terminated before ever holding a slot
        (deadline passed at admission, cancel(rid), or a graceful drain)."""
        self.faults["shed_queued"] += 1
        if reason in self.faults:
            self.faults[reason] += 1
        rec = self.records.get(rid)
        if rec is not None:
            rec.finished = now
            rec.finish_reason = reason

    def on_token(self, rid: str, now: float) -> None:
        rec = self.records[rid]
        if rec.first_token is None:
            rec.first_token = now
        rec.token_times.append(now)
        rec.n_generated += 1

    def on_finish(self, rid: str, reason: str, now: float) -> None:
        rec = self.records[rid]
        rec.finished = now
        rec.finish_reason = reason
        if reason == "fault":
            self.faults["faulted"] += 1
        elif reason in ("deadline", "cancelled", "drained"):
            self.faults[reason] += 1

    # -- serving-sentinel events ---------------------------------------------
    def on_nonfinite(self, rid: str, slot: Optional[int], now: float) -> None:
        """A NaN/inf logits row was detected (slot is None for prefill rows,
        which run in the scratch cache, not a pool slot)."""
        self.faults["nonfinite_rows"] += 1

    def on_quarantine(self, slot: int, now: float) -> None:
        self.faults["quarantined_slots"] += 1

    def on_executor_retry(self, op: str) -> None:
        self.faults["executor_retries"] += 1

    def on_executor_rebuild(self) -> None:
        self.faults["executor_rebuilds"] += 1

    def on_replay(self, rid: str) -> None:
        self.faults["replayed"] += 1

    # -- engine-step accounting ----------------------------------------------
    def on_prefill_chunk(self, n_tokens: int, dt: float) -> None:
        self._prefill_tokens += n_tokens
        self._prefill_time += dt

    def on_decode_step(self, n_active: int, n_slots: int, dt: float) -> None:
        self._decode_tokens += n_active
        self._decode_time += dt
        self._occupancy.append(n_active / max(n_slots, 1))

    # -- summary -------------------------------------------------------------
    def summary(self) -> dict:
        # terminal-with-result = was admitted (held a slot) and has a finish
        # reason; queue-side terminations (expired/shed) have admitted=None
        done = [r for r in self.records.values()
                if r.admitted is not None and r.finish_reason is not None]
        ttft = [r.first_token - r.arrival for r in done
                if r.first_token is not None]
        waits = [r.admitted - r.arrival for r in self.records.values()
                 if r.admitted is not None]
        itl = []
        for r in done:
            itl.extend(b - a for a, b in zip(r.token_times, r.token_times[1:]))
        arrivals = [r.arrival for r in self.records.values()]
        ends = [r.finished for r in done if r.finished is not None]
        wall = float(max(ends) - min(arrivals)) if arrivals and ends else 0.0
        gen = sum(r.n_generated for r in done)
        return {
            "schema": SCHEMA,
            "requests": {
                "submitted": len(self.records) + self.rejected,
                "admitted": len(waits),
                "rejected": self.rejected,
                "expired": self.expired,
                "finished": len(done),
            },
            "ttft_s": _stats(ttft),
            "itl_s": _stats(itl),
            "queue_wait_s": _stats(waits),
            "throughput": {
                "prefill_tok_s": float(self._prefill_tokens / self._prefill_time
                                       if self._prefill_time > 0 else 0.0),
                "decode_tok_s": float(self._decode_tokens / self._decode_time
                                      if self._decode_time > 0 else 0.0),
                "total_tok_s": float(gen / wall if wall > 0 else 0.0),
            },
            "occupancy": {
                "mean": (sum(self._occupancy) / len(self._occupancy)
                         if self._occupancy else 0.0),
                "max": max(self._occupancy) if self._occupancy else 0.0,
            },
            "tokens": {"prompt": self._prefill_tokens, "generated": gen},
            "wall_s": wall,
            "faults": dict(self.faults),
        }
