"""Admission control for the serving engine: FIFO queue + backpressure.

Preemption-free by design: once a request holds a slot it runs to
completion (the engine's per-request deadline and `cancel` are the only
mid-flight exits); pressure is absorbed at the boundary instead — `submit`
rejects when the queue is full or the request can never fit the cache
(prompt + max_new > max_len), queued requests that out-wait `max_wait` are
expired before admission, and requests whose deadline already passed are
shed at admission instead of being handed a slot they can no longer use.
Two admission policies share the queue:

  "continuous"  refill any free slot immediately (continuous batching)
  "static"      admit only when ALL slots are idle, up to n_free at once —
                the one-batch-at-a-time baseline the serving benchmark
                compares against
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.sampling import SamplingParams

POLICIES = ("continuous", "static")


@dataclasses.dataclass
class Request:
    rid: str
    tokens: np.ndarray  # (prompt_len,) int32
    sampling: SamplingParams
    arrival: float = 0.0
    deadline: Optional[float] = None  # absolute clock time; None = no deadline

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32).reshape(-1)


class Scheduler:
    """FIFO queue with max-waiting-time admission and bounded depth."""

    def __init__(self, *, max_len: int, max_queue: int = 64,
                 max_wait: Optional[float] = None,
                 policy: str = "continuous"):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}: {policy!r}")
        self.max_len = max_len
        self.max_queue = max_queue
        self.max_wait = max_wait
        self.policy = policy
        self.queue: deque[Request] = deque()
        self._has_deadlines = False  # fast-path flag: expire() stays O(1)
        # when no max_wait is set and no queued request ever had a deadline

    def __len__(self) -> int:
        return len(self.queue)

    def submit(self, req: Request, now: float) -> tuple[bool, str]:
        """Try to enqueue. Returns (accepted, reason); reason is "queued" on
        success, else the backpressure cause ("queue_full" / "too_long" /
        "empty_prompt")."""
        n = int(req.tokens.shape[0])
        if n < 1:
            return False, "empty_prompt"
        if n + req.sampling.max_new_tokens - 1 > self.max_len:
            # the last generated token is sampled, never cached, so a request
            # needs prompt_len + max_new - 1 cache rows
            return False, "too_long"
        if len(self.queue) >= self.max_queue:
            return False, "queue_full"
        req.arrival = now
        if req.deadline is not None:
            self._has_deadlines = True
        self.queue.append(req)
        return True, "queued"

    def expire(self, now: float) -> list[tuple[Request, str]]:
        """Shed queued requests: ones that out-waited `max_wait` (reason
        "expired") and ones whose deadline already passed (reason
        "deadline" — admitting them would hand a slot to a request the
        caller has given up on). Returns (request, reason) pairs."""
        if self.max_wait is None and not self._has_deadlines:
            return []
        dropped: list[tuple[Request, str]] = []
        kept: deque[Request] = deque()
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                dropped.append((req, "deadline"))
            elif self.max_wait is not None and now - req.arrival > self.max_wait:
                dropped.append((req, "expired"))
            else:
                kept.append(req)
        self.queue = kept
        return dropped

    def cancel(self, rid: str) -> Optional[Request]:
        """Remove a queued request by id; returns it, or None if not queued
        (in-flight cancellation is the engine's job — it owns the slots)."""
        for req in self.queue:
            if req.rid == rid:
                self.queue.remove(req)
                return req
        return None

    def drain(self) -> list[Request]:
        """Pop the whole queue (graceful-drain path: admission has stopped,
        so queued requests can never run and must be shed, not dropped)."""
        out = list(self.queue)
        self.queue.clear()
        return out

    def admit(self, now: float, n_free: int, n_busy: int) -> list[Request]:
        """Pop up to n_free requests in FIFO order, per the policy."""
        if n_free <= 0 or not self.queue:
            return []
        if self.policy == "static" and n_busy > 0:
            return []
        out = []
        while self.queue and len(out) < n_free:
            out.append(self.queue.popleft())
        return out
