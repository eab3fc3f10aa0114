"""Fault tolerance: checkpoint manager, preemption handling, straggler watch.

PyTorch counterpart of `repro.train.fault_tolerance`:
  * CheckpointManager: restore-on-start (CRC-verified, falls back past
    corrupt checkpoints), periodic async saves with errors surfaced at the
    next save point, save-on-exit, and `rollback()` for sentinel recovery.
  * PreemptionGuard: SIGTERM/SIGINT flips a flag; the train loop
    checkpoints and exits at the next step boundary.
  * StragglerWatch: per-step wall-time EMA; a step slower than `ratio` x
    the EMA is flagged.

With a `layout` (a sharded state, `dist.sharding.Layout`), every rank
calls the manager in step: a save gathers the full arrays and rank 0
writes them, a restore keeps each rank's slice, a rollback waits at a
barrier for rank 0's pending saves, and a stop request on any rank stops
all of them.
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
                 async_io: bool = True, expect_fingerprint: Optional[str] = None,
                 layout: Any = None):
        self.path_dir = path_dir
        self.save_every = save_every
        self.layout = layout
        self.async_ = ckpt.AsyncCheckpointer(path_dir, keep_last) if async_io else None
        self.keep_last = keep_last
        self.expect_fingerprint = expect_fingerprint
        self.guard = PreemptionGuard()
        self.straggler = StragglerWatch()

    def _meta(self) -> Optional[dict]:
        if self.expect_fingerprint is None:
            return None
        return {"config_fingerprint": self.expect_fingerprint}

    def _sharded(self) -> bool:
        return self.layout is not None and self.layout.mesh.world > 1

    def _writer(self) -> bool:
        return self.layout is None or self.layout.mesh.rank == 0

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
                            shardings=self.layout,
                            expect_fingerprint=self.expect_fingerprint), step

    def rollback(self, like: Any):
        """Sentinel recovery: (state, step) of the newest VERIFIED checkpoint,
        or None. Pending async saves land first."""
        if self.async_ is not None and self._writer():
            self.async_.flush()
        if self._sharded():
            import torch.distributed as dist
            dist.barrier()
        step = ckpt.latest_step(self.path_dir, verified=True)
        if step is None:
            return None
        return ckpt.restore(self.path_dir, like, step=step, verify_crc=False,
                            shardings=self.layout,
                            expect_fingerprint=self.expect_fingerprint), step

    def maybe_save(self, state: Any, step: int, *, force: bool = False) -> bool:
        """Periodic / forced save. Raises CheckpointError here when an
        earlier async save failed terminally."""
        if self.async_ is not None:
            self.async_.raise_if_failed()
        due = force or self.should_stop() or (step > 0 and step % self.save_every == 0)
        if not due:
            return False
        if self._sharded():
            from repro_torch.dist.spmd import gather_tree
            state = gather_tree(state, self.layout.specs, self.layout.mesh)
            if not self._writer():
                return True
        if self.async_ is not None:
            self.async_.submit(state, step, meta=self._meta())
        else:
            ckpt.save(self.path_dir, state, step, meta=self._meta(),
                      keep_last=self.keep_last)
        return True

    def should_stop(self) -> bool:
        if self._sharded():  # one rank's signal stops every rank
            import torch
            from repro_torch.dist.spmd import all_reduce
            mesh = self.layout.mesh
            flag = torch.tensor(int(self.guard.requested), dtype=torch.int32)
            return bool(all_reduce(flag, mesh.group(mesh.axis_names), "max"))
        return self.guard.requested

    def finalize(self):
        if self.async_ is not None:
            self.async_.wait()
            self.async_.raise_if_failed()
