"""Fault tolerance: checkpoint manager, preemption handling, straggler watch.

PyTorch counterpart of `repro.train.fault_tolerance`:
  * CheckpointManager: restore-on-start (CRC-verified, falls back past
    corrupt checkpoints), periodic async saves with errors surfaced at the
    next save point, save-on-exit, and `rollback()` for sentinel recovery.
  * PreemptionGuard: SIGTERM/SIGINT flips a flag; the train loop
    checkpoints and exits at the next step boundary.
  * StragglerWatch: per-step wall-time EMA; a step slower than `ratio` x
    the EMA is flagged.
"""
from __future__ import annotations

import signal
import time
from typing import Any, Callable, Optional

from repro_torch.train import checkpoint as ckpt


class PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._orig = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore_handlers(self):
        for sig, h in self._orig.items():
            signal.signal(sig, h)


class StragglerWatch:
    def __init__(self, ratio: float = 2.0, momentum: float = 0.1,
                 clock: Optional[Callable[[], float]] = None):
        self.ratio = ratio
        self.momentum = momentum
        self.clock = clock  # injectable for deterministic tests
        self.ema: Optional[float] = None
        self.flags = 0
        self._last: Optional[float] = None

    def tick(self) -> bool:
        """Call once per step; True when the step was a straggler."""
        now = self.clock() if self.clock is not None else time.monotonic()
        if self._last is None:
            self._last = now
            return False
        dt = now - self._last
        self._last = now
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.ratio * self.ema
        self.ema = (1 - self.momentum) * self.ema + self.momentum * dt
        self.flags += int(slow)
        return slow


class CheckpointManager:
    def __init__(self, path_dir: str, save_every: int = 100, keep_last: int = 3,
                 async_io: bool = True, expect_fingerprint: Optional[str] = None):
        self.path_dir = path_dir
        self.save_every = save_every
        self.async_ = ckpt.AsyncCheckpointer(path_dir, keep_last) if async_io else None
        self.keep_last = keep_last
        self.expect_fingerprint = expect_fingerprint
        self.guard = PreemptionGuard()
        self.straggler = StragglerWatch()

    def _meta(self) -> Optional[dict]:
        if self.expect_fingerprint is None:
            return None
        return {"config_fingerprint": self.expect_fingerprint}

    def restore_or_init(self, init_fn: Callable[[], Any]):
        """(state, step): the newest checkpoint that passes CRC verification
        restored into the structure of a fresh `init_fn()` state, or that
        fresh state and step 0 when none survives."""
        state = init_fn()
        step = ckpt.latest_step(self.path_dir, verified=True)
        if step is None:
            return state, 0
        # latest_step(verified=True) has just checked every CRC
        return ckpt.restore(self.path_dir, state, step=step, verify_crc=False,
                            expect_fingerprint=self.expect_fingerprint), step

    def rollback(self, like: Any):
        """Sentinel recovery: (state, step) of the newest VERIFIED checkpoint,
        or None. Pending async saves land first."""
        if self.async_ is not None:
            self.async_.flush()
        step = ckpt.latest_step(self.path_dir, verified=True)
        if step is None:
            return None
        return ckpt.restore(self.path_dir, like, step=step, verify_crc=False,
                            expect_fingerprint=self.expect_fingerprint), step

    def maybe_save(self, state: Any, step: int, *, force: bool = False) -> bool:
        """Periodic / forced save. Raises CheckpointError here when an
        earlier async save failed terminally."""
        if self.async_ is not None:
            self.async_.raise_if_failed()
        due = force or self.guard.requested or (step > 0 and step % self.save_every == 0)
        if not due:
            return False
        if self.async_ is not None:
            self.async_.submit(state, step, meta=self._meta())
        else:
            ckpt.save(self.path_dir, state, step, meta=self._meta(),
                      keep_last=self.keep_last)
        return True

    def should_stop(self) -> bool:
        return self.guard.requested

    def finalize(self):
        if self.async_ is not None:
            self.async_.wait()
            self.async_.raise_if_failed()
