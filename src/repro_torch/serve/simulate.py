"""Deterministic serving simulation: injectable clock + cost-modeled executor.

A copy of the JAX package's `repro.serve.simulate` (numpy only), as the
engine itself is copied: the engine takes `clock=SimClock().now`, the
SimExecutor advances that clock by a fixed step-cost model, and a seeded
workload replays identically on every run, so the serving benchmark
(`repro_torch.launch.serving_bench`) and the fault tests are reproducible
bit for bit with no model or device involved.

The fake model emits one-hot logits with argmax (pos + 1) % vocab: each
request's stream is its positions in order, so streams are strictly
increasing (monotone) for any prompt shorter than vocab (an invariant the
smoke gate checks) and depend only on the request itself, never on batch
composition (the same row-independence contract as the real model).
"""
from __future__ import annotations

import dataclasses

import numpy as np


class SimClock:
    """Monotonic simulated time in seconds."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0.0
        self._t += float(dt)


@dataclasses.dataclass(frozen=True)
class SimCost:
    """Step-cost model (seconds), the reference's defaults: a fixed
    dispatch overhead plus a per-token term, with prefill cheaper per token
    than decode (parallel over the chunk). A model of no device: no number
    it yields is a measurement.

    decode_per_ctx_token charges attention's KV-read cost: each active
    slot contributes its LIVE context length (pos + 1), so a pool full of
    long-context requests decodes slower than one full of short ones and
    the Poisson sweep stresses long-context scheduling, not just slot
    occupancy."""
    prefill_base: float = 2e-3
    prefill_per_token: float = 1e-4
    decode_base: float = 4e-3
    decode_per_token: float = 2e-4
    decode_per_ctx_token: float = 5e-6
    insert: float = 5e-4


class SimExecutor:
    """ServeEngine-compatible executor over the fake model + cost model."""

    def __init__(self, clock: SimClock, *, n_slots: int, max_len: int,
                 chunk: int = 16, vocab: int = 50_000,
                 cost: SimCost = SimCost()):
        self.clock = clock
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.vocab = vocab
        self.cost = cost

    def _one_hot(self, tok: int) -> np.ndarray:
        z = np.zeros((self.vocab,), np.float32)
        z[tok % self.vocab] = 1.0
        return z

    def scratch_reset(self) -> None:
        pass

    def prefill_chunk(self, tokens: np.ndarray, start_pos: int) -> np.ndarray:
        n = int(tokens.shape[0])
        self.clock.advance(self.cost.prefill_base
                           + self.cost.prefill_per_token * n)
        last_pos = start_pos + n - 1
        return self._one_hot(last_pos + 1)

    def commit_prefill(self, slot: int) -> None:
        self.clock.advance(self.cost.insert)

    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        active = pos >= 0
        n_active = int(np.sum(active))
        # per-slot live context length: the token being fed sits at pos, so
        # attention reads pos + 1 cached entries for that slot
        ctx_tokens = int(np.sum(pos[active] + 1))
        self.clock.advance(self.cost.decode_base
                           + self.cost.decode_per_token * n_active
                           + self.cost.decode_per_ctx_token * ctx_tokens)
        out = np.zeros((self.n_slots, self.vocab), np.float32)
        for s in range(self.n_slots):
            if pos[s] >= 0:
                out[s] = self._one_hot(int(pos[s]) + 1)
        return out

    def reset_slot(self, slot: int) -> None:
        self.clock.advance(self.cost.insert)


def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate: float) -> np.ndarray:
    """n cumulative arrival times at `rate` requests/second (seeded)."""
    gaps = rng.exponential(1.0 / rate, size=n)
    return np.cumsum(gaps)
