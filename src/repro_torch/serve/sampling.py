"""Per-request token sampling for the serving engine.

Host-side numpy on purpose: logits already crossed the device boundary to
drive the scheduler (finish checks gate admission), and a (seed, token_index)
keyed generator makes every draw independent of batch composition — the same
request produces the same tokens no matter how its decode steps interleave
with other requests' (the engine's determinism contract).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class NonFiniteLogits(ValueError):
    """A logits row contained NaN/inf. Sampling from it would emit a
    garbage-but-valid-looking token id (argmax over NaN is position 0), so
    `sample_token` refuses outright; the serving engine detects the row
    first and fails only the offending request (finish_reason "fault") —
    this exception is the defense-in-depth backstop."""


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decoding contract for one request.

    Generation stops when `eos_id` is sampled (the eos token IS emitted,
    finish_reason "eos") or after `max_new_tokens` tokens (finish_reason
    "length"), whichever comes first. temperature <= 0 means greedy;
    top_k <= 0 means no truncation.
    """
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None


def sample_token(logits: np.ndarray, sp: SamplingParams,
                 token_index: int) -> int:
    """Draw one token id from a (V,) logits row.

    token_index is the request-local index of the token being sampled
    (0 = the first generated token, from the prefill logits). The rng is
    re-seeded per draw from (sp.seed, token_index) so draws commute with
    scheduling order.
    """
    logits = np.asarray(logits, np.float64).reshape(-1)
    if not np.all(np.isfinite(logits)):
        raise NonFiniteLogits(
            f"non-finite logits row at token_index {token_index}: a NaN/inf "
            "row must fault the request, never emit a token")
    if sp.temperature <= 0.0:
        return int(np.argmax(logits))
    z = logits / sp.temperature
    if sp.top_k > 0 and sp.top_k < z.size:
        kth = np.partition(z, -sp.top_k)[-sp.top_k]
        z = np.where(z < kth, -np.inf, z)
    z = z - np.max(z)
    p = np.exp(z)
    p /= p.sum()
    rng = np.random.default_rng((sp.seed, token_index))
    return int(rng.choice(p.size, p=p))


def is_finished(tokens: list[int], sp: SamplingParams) -> Optional[str]:
    """finish_reason for a generated-token stream, or None if still going."""
    if sp.eos_id is not None and tokens and tokens[-1] == sp.eos_id:
        return "eos"
    if len(tokens) >= sp.max_new_tokens:
        return "length"
    return None
