"""Continuous-batching serving engine over the chunked decode machinery.

One preallocated pool `KVCache` of `n_slots` batch rows serves every
request: a slot is claimed at admission, its prompt is prefilled chunk-by-
chunk in a batch-1 scratch cache (so long prompts never stall in-flight
decodes for more than one chunk), the scratch row is scattered into the pool
(`cache_slot_insert`), and decode steps run the WHOLE pool each iteration —
idle rows carry pos=-1, which `attend_chunk`/`cache_append_chunk` mask, so
near-full batches are free. On completion the slot's cache row is reset from
a pristine batch-1 template (`cache_slot_reset`: pos rows back to -1) and
immediately refillable mid-flight.

Determinism contract: per-batch-row independence of every decode op (learned
per-tensor activation scales, per-(row,token,head) KV quantization) plus
(seed, token_index)-keyed sampling means each request's output stream equals
its single-request run bit-for-bit, REGARDLESS of arrival interleaving —
pinned by tests/test_serve_engine.py.

Serving sentinel (ROADMAP.md "Serving contract", fault section): low-bit
inference is NaN-prone by construction (activation outliers, quantizer-scale
pathologies — paper Sec. 3), so the engine assumes any step can go wrong and
fences the blast radius to ONE request:

* **Health checks** — every logits row the engine is about to sample is
  checked for NaN/inf; a non-finite row fails only the offending request
  (finish_reason "fault"), never the pool. A slot whose decode rows go
  non-finite `quarantine_after` consecutive times is quarantined — fenced
  out of `_free` so capacity degrades by one slot instead of the engine
  dying (row independence means the other slots' streams are untouched).
* **Executor fault recovery** — transient executor exceptions are retried
  with backoff; persistent ones trigger a rebuild (`executor_factory`) and
  a deterministic REPLAY of every in-flight request (re-prefill prompt +
  emitted tokens: the bit-exact parity contract makes replay lossless, so
  post-recovery streams equal the unfaulted run token-for-token).
* **Deadlines + cancel** — `submit(..., deadline_s=)` bounds a request
  end-to-end: passed deadlines are shed at admission (scheduler) and cut
  in-flight (finish_reason "deadline", partial tokens kept); `cancel(rid)`
  does the same on demand ("cancelled").
* **Graceful drain + watchdog** — `drain()` (or a tripped PreemptionGuard
  inside `run_until_idle`) stops admission, sheds the queue, lets in-flight
  work finish inside `drain_timeout_s`, and cuts stragglers with partial
  results ("drained"). `run_until_idle` raises `EngineStuck` with per-slot
  diagnostics when `step()` stops making progress, instead of silently
  returning a partial summary.

The fault-free path is pure pass-through: the checks read values without
changing them, so streams, metrics timings, and BENCH_serving.json replay
bit-identically with the sentinel armed (the default).

The engine is executor-agnostic: `ModelExecutor` drives the PyTorch model
(any object with prefill_chunk / commit_prefill / decode / reset_slot /
scratch_reset and n_slots / chunk / max_len serves). This host loop is a
copy of the JAX package's `repro.serve.engine`; only `ModelExecutor` is new.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.dist.spmd import WHOLE
from repro_torch.serve.metrics import MetricsCollector
from repro_torch.serve.sampling import SamplingParams, is_finished, sample_token
from repro_torch.serve.scheduler import Request, Scheduler

PREFILLING = "prefilling"
GENERATING = "generating"

# _exec sentinel: the op did NOT run — the executor was rebuilt and every
# in-flight request replayed; the caller must abandon its step-local state
_REBUILT = object()


class EngineStuck(RuntimeError):
    """run_until_idle made no progress: work is pending but step() can't
    advance it (e.g. every slot quarantined while requests still queue).
    Carries a `diagnostics` dict (per-slot state, queue depth, quarantine
    map) so the operator sees WHY instead of a silent partial summary."""

    def __init__(self, msg: str, diagnostics: dict):
        super().__init__(f"{msg}: {diagnostics}")
        self.diagnostics = diagnostics


class EngineAbort(RuntimeError):
    """Executor recovery exhausted: retries failed and no rebuild budget
    (or no executor_factory) remains. Mirrors train.sentinel.SentinelAbort."""


@dataclasses.dataclass(frozen=True)
class FaultPolicy:
    """Serving-sentinel knobs (mirrors train.sentinel.SentinelConfig).

    The defaults arm every detector; `nonfinite_fault=False` drops the
    logits health check (sample_token still raises NonFiniteLogits as the
    backstop, so a non-finite row can never silently emit a token).
    """
    nonfinite_fault: bool = True
    quarantine_after: int = 2      # consecutive non-finite DECODE rows/slot
    executor_retries: int = 2      # transient-exception retries per op
    retry_backoff_s: float = 0.05  # linear backoff: attempt * backoff
    max_rebuilds: int = 2          # executor rebuilds per engine lifetime
    drain_timeout_s: float = 30.0  # graceful-drain budget
    stuck_after: int = 1000        # no-progress step()s before EngineStuck


@dataclasses.dataclass
class GenResult:
    rid: str
    prompt_len: int
    tokens: list
    finish_reason: str


@dataclasses.dataclass
class _SlotState:
    req: Request
    state: str = PREFILLING
    cursor: int = 0          # prompt tokens already prefilled
    out: list = dataclasses.field(default_factory=list)
    last_logits: Optional[np.ndarray] = None


class ModelExecutor:
    """PyTorch model driver: batch-1 scratch prefill + pooled decode.

    Only attention-only patterns are served: recurrent blocks (mlstm/slstm/
    rglru) consume every chunk token unconditionally, so pos=-1 padding rows
    would corrupt their state mid-flight (model.block_decode documents the
    contract). Cross-attention needs per-slot frontend embeds — also out.

    The cache ops update their tensors IN PLACE (model.prefill_step appends
    to the cache it is given), so the pristine `template` is never handed to
    a step: `scratch_reset` clones it into a fresh scratch cache, and slot
    resets copy it row-wise into the pool.
    """

    def __init__(self, params, cfg, qcfg, *, n_slots: int, max_len: int,
                 chunk: int = 16, spmd=WHOLE):
        from repro_torch.models import model as M
        bad = [bd.attn for bd in cfg.pattern
               if bd.attn not in ("global", "local")]
        if bad or any(bd.cross_attn for bd in cfg.pattern):
            raise ValueError(
                "ModelExecutor serves attention-only patterns (pos=-1 chunk "
                f"padding is undefined for recurrent/cross blocks): {cfg.name}")
        self._M = M
        self.params = params
        self.cfg = cfg
        self.qcfg = qcfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.chunk = chunk
        self.vocab = cfg.vocab_size
        self.eos_id = None
        self.device = M.params_device(params)
        # spmd: params are one rank's slices and every cache this rank's
        # part of a sequence-sharded one (launch.serve --model-parallel)
        self.spmd = spmd
        self.template = M.init_cache(cfg, qcfg, 1, max_len, self.device, spmd=spmd)
        self.scratch = M.cache_clone(self.template)
        self.pool = M.init_cache(cfg, qcfg, n_slots, max_len, self.device,
                                 spmd=spmd)

    def scratch_reset(self) -> None:
        self.scratch = self._M.cache_clone(self.template)

    def _tensor(self, a: np.ndarray):
        import torch
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def prefill_chunk(self, tokens: np.ndarray, start_pos: int) -> np.ndarray:
        """Run one prompt chunk (<= self.chunk tokens) through the scratch
        cache; returns the (V,) f32 logits of the chunk's LAST token. The
        chunk is padded to the fixed chunk width with pos=-1 rows, as the
        JAX executor does for its single jit specialization."""
        n = int(tokens.shape[0])
        assert 1 <= n <= self.chunk
        tk = np.zeros((1, self.chunk), np.int32)
        ps = np.full((1, self.chunk), -1, np.int32)
        tk[0, :n] = tokens
        ps[0, :n] = np.arange(start_pos, start_pos + n)
        logits, self.scratch = self._M.prefill_step(
            self.params, self.scratch,
            {"tokens": self._tensor(tk), "pos": self._tensor(ps)},
            self.cfg, self.qcfg, spmd=self.spmd)
        return logits[0, n - 1].float().cpu().numpy()

    def commit_prefill(self, slot: int) -> None:
        self.pool = self._M.cache_slot_insert(self.pool, self.scratch, slot)

    def decode(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One pooled decode step. tokens (n_slots,), pos (n_slots,) with -1
        marking idle rows; returns (n_slots, V) f32 logits (idle rows are
        garbage — the engine never reads them)."""
        logits, self.pool = self._M.decode_step(
            self.params, self.pool,
            {"tokens": self._tensor(tokens[:, None].astype(np.int32)),
             "pos": self._tensor(pos.astype(np.int32))},
            self.cfg, self.qcfg, spmd=self.spmd)
        return logits[:, 0].float().cpu().numpy()

    def reset_slot(self, slot: int) -> None:
        self.pool = self._M.cache_slot_reset(self.pool, self.template, slot)


class ServeEngine:
    """Slot-multiplexing request loop. One `step()` = (shed/expire, cut
    passed deadlines, admit, at most one prefill chunk, one pooled decode).
    `run_until_idle()` drains; `drain()` is the graceful-shutdown path."""

    def __init__(self, executor, scheduler: Optional[Scheduler] = None,
                 metrics: Optional[MetricsCollector] = None,
                 clock: Callable[[], float] = time.monotonic, *,
                 faults: Optional[FaultPolicy] = None,
                 executor_factory: Optional[Callable] = None,
                 guard=None, sleep: Callable[[float], None] = time.sleep):
        self.executor = executor
        self.n_slots = executor.n_slots
        self.chunk = executor.chunk
        # explicit None checks: Scheduler has __len__, so an EMPTY scheduler
        # is falsy and `scheduler or default` would silently replace it
        self.scheduler = (scheduler if scheduler is not None
                          else Scheduler(max_len=executor.max_len))
        self.metrics = metrics if metrics is not None else MetricsCollector()
        self.clock = clock
        self.faults = faults if faults is not None else FaultPolicy()
        # rebuilds a fresh executor from params after persistent failures;
        # None = no recovery, executor exceptions propagate after retries
        self.executor_factory = executor_factory
        # a train.fault_tolerance.PreemptionGuard (or anything with a
        # `requested` bool): run_until_idle turns SIGTERM into a drain
        self.guard = guard
        self.sleep = sleep  # injectable for deterministic backoff tests
        self.slots: dict[int, _SlotState] = {}
        # decode-step staging buffers, hoisted out of the hot loop: step()
        # refills them in place instead of reallocating (n_slots,) arrays
        # per decode step, so host-side overhead doesn't mask kernel gains
        self._dec_tokens = np.zeros((self.n_slots,), np.int32)
        self._dec_pos = np.full((self.n_slots,), -1, np.int32)
        self._free = set(range(self.n_slots))
        self._pending_prefill: deque[int] = deque()
        self._prefilling: Optional[int] = None
        self._generating: set[int] = set()
        self.results: dict[str, GenResult] = {}
        self.quarantined: dict[int, str] = {}   # slot -> reason
        self._strikes: dict[int, int] = {}      # slot -> consecutive bad rows
        self._rebuilds = 0
        self._draining = False
        self._auto_rid = 0

    # -- submission ----------------------------------------------------------
    def submit(self, tokens, sampling: Optional[SamplingParams] = None,
               rid: Optional[str] = None,
               deadline_s: Optional[float] = None) -> tuple[bool, str]:
        """Enqueue one request. Returns the scheduler's (accepted, reason).
        `deadline_s` bounds the request END-TO-END (queue wait + prefill +
        decode) relative to now: a passed deadline sheds it at admission or
        cuts it in-flight with finish_reason "deadline"."""
        if rid is None:
            rid = f"req-{self._auto_rid}"
            self._auto_rid += 1
        now = self.clock()
        if self._draining:
            self.metrics.on_reject(rid, "draining", now)
            return False, "draining"
        if deadline_s is not None and deadline_s <= 0:
            # already-dead deadline: shed at the door, don't even queue
            self.metrics.on_reject(rid, "deadline", now)
            return False, "deadline"
        req = Request(rid, np.asarray(tokens, np.int32),
                      sampling or SamplingParams())
        if deadline_s is not None:
            req.deadline = now + float(deadline_s)
        ok, reason = self.scheduler.submit(req, now)
        if ok:
            self.metrics.on_submit(rid, int(req.tokens.shape[0]), now)
        else:
            self.metrics.on_reject(rid, reason, now)
        return ok, reason

    def cancel(self, rid: str) -> bool:
        """Terminate one request wherever it is: queued (shed, no result) or
        in-flight (partial GenResult, finish_reason "cancelled"). Returns
        False when the rid is unknown or already finished."""
        now = self.clock()
        if self.scheduler.cancel(rid) is not None:
            self.metrics.on_shed(rid, "cancelled", now)
            return True
        for slot, st in list(self.slots.items()):
            if st.req.rid == rid:
                self._finish(slot, "cancelled", now)
                return True
        return False

    def quarantine(self, slot: int, reason: str = "manual") -> None:
        """Fence a slot out of the free pool: the engine degrades to
        n_slots - len(quarantined) capacity instead of dying. Idempotent;
        an occupying request is cut with finish_reason "fault" first."""
        if slot in self.quarantined:
            return
        now = self.clock()
        if slot in self.slots:
            self._finish(slot, "fault", now)
        self.quarantined[slot] = reason
        self._free.discard(slot)
        self.metrics.on_quarantine(slot, now)

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.queue or self.slots)

    @property
    def healthy_slots(self) -> int:
        return self.n_slots - len(self.quarantined)

    def diagnostics(self) -> dict:
        """Operator-facing snapshot (EngineStuck payload)."""
        return {
            "queue_depth": len(self.scheduler),
            "free_slots": sorted(self._free),
            "quarantined": dict(self.quarantined),
            "prefilling": self._prefilling,
            "pending_prefill": list(self._pending_prefill),
            "slots": {s: {"rid": st.req.rid, "state": st.state,
                          "cursor": st.cursor, "generated": len(st.out)}
                      for s, st in sorted(self.slots.items())},
            "rebuilds": self._rebuilds,
            "draining": self._draining,
        }

    # -- executor fault recovery ---------------------------------------------
    def _exec(self, op: str, *args):
        """Run one executor op with bounded retry; on persistent failure
        rebuild the executor and replay every in-flight request, returning
        the `_REBUILT` sentinel (the op did NOT run — callers abandon their
        step-local state; the next step() re-derives it from the slots,
        which replay left semantically identical).

        Retry safety: every executor op writes its cache on SUCCESS only
        (the model step commits its KV appends after every layer ran), so a
        failed call left no partial state and the identical retry is sound.
        """
        attempts = 0
        while True:
            try:
                return getattr(self.executor, op)(*args)
            except Exception as err:  # noqa: BLE001 — sentinel boundary
                attempts += 1
                if attempts <= self.faults.executor_retries:
                    self.metrics.on_executor_retry(op)
                    self.sleep(self.faults.retry_backoff_s * attempts)
                    continue
                self._rebuild_and_replay(op, err)
                return _REBUILT

    def _rebuild_and_replay(self, op: str, cause: Exception) -> None:
        while True:
            if self.executor_factory is None:
                raise EngineAbort(
                    f"executor.{op} failed after "
                    f"{self.faults.executor_retries} retries and no "
                    "executor_factory is set") from cause
            if self._rebuilds >= self.faults.max_rebuilds:
                raise EngineAbort(
                    f"executor rebuild budget exhausted "
                    f"({self.faults.max_rebuilds}) recovering from "
                    f"executor.{op}") from cause
            self._rebuilds += 1
            self.metrics.on_executor_rebuild()
            self.executor = self.executor_factory()
            try:
                self._replay_inflight()
                return
            except Exception as err:  # noqa: BLE001 — replay may hit the
                cause = err           # same fault; loop consumes the budget

    def _replay_inflight(self) -> None:
        """Rebuild every in-flight request's pool row on a fresh executor.

        A generating request's cache holds positions 0..prompt+len(out)-2
        (the newest emitted token hasn't been fed yet), which is exactly a
        chunked prefill of prompt + out[:-1] — and chunk boundaries never
        change KV contents (per-token quantization; pinned by
        test_chunked_prefill_equals_single_chunk), so the replayed stream
        continues bit-identically. Prefilling requests lose their scratch
        progress and restart from token 0 (same determinism argument).
        """
        ex = self.executor
        if self._prefilling is not None:
            st = self.slots[self._prefilling]
            st.cursor = 0
            st.last_logits = None
            self._pending_prefill.appendleft(self._prefilling)
            self._prefilling = None
        for slot in sorted(self._generating):
            st = self.slots[slot]
            toks = np.concatenate([st.req.tokens,
                                   np.asarray(st.out[:-1], np.int32)])
            ex.scratch_reset()
            for c0 in range(0, int(toks.shape[0]), self.chunk):
                ex.prefill_chunk(toks[c0:c0 + self.chunk], c0)
            ex.commit_prefill(slot)
            self.metrics.on_replay(st.req.rid)

    # -- one engine iteration ------------------------------------------------
    def step(self) -> bool:
        now = self.clock()
        for req, reason in self.scheduler.expire(now):
            if reason == "expired":
                self.metrics.on_expire(req.rid, now)
            else:  # deadline passed while queued: admission-side shedding
                self.metrics.on_shed(req.rid, reason, now)
        did = False

        # in-flight deadlines: cut the request, keep its partial tokens
        for slot in sorted(self.slots):
            dl = self.slots[slot].req.deadline
            if dl is not None and now > dl:
                self._finish(slot, "deadline", now)
                did = True

        # admission: fill free slots per the scheduler policy (suspended
        # while draining — drain() already shed the queue, and submit()
        # rejects new work)
        if not self._draining:
            free = sorted(self._free)
            admits = self.scheduler.admit(now, len(free), len(self.slots))
            for req in admits:
                slot = free.pop(0)
                self._free.discard(slot)
                self.slots[slot] = _SlotState(req=req)
                self._pending_prefill.append(slot)
                self.metrics.on_admit(req.rid, now)
                did = True

        # chunked prefill: one chunk of the oldest admitted prompt (batch-1
        # scratch — one request prefills at a time, others wait their turn)
        if self._prefilling is None and self._pending_prefill:
            self._prefilling = self._pending_prefill.popleft()
            if self._exec("scratch_reset") is _REBUILT:
                return True
        if self._prefilling is not None:
            slot = self._prefilling
            st = self.slots[slot]
            prompt = st.req.tokens
            n = min(self.chunk, prompt.shape[0] - st.cursor)
            t0 = self.clock()
            out = self._exec("prefill_chunk",
                             prompt[st.cursor:st.cursor + n], st.cursor)
            if out is _REBUILT:
                return True  # replay re-queued the slot at cursor 0
            st.last_logits = out
            self.metrics.on_prefill_chunk(n, self.clock() - t0)
            st.cursor += n
            did = True
            if st.cursor >= prompt.shape[0]:
                if self._exec("commit_prefill", slot) is _REBUILT:
                    return True
                self._prefilling = None
                tnow = self.clock()
                row = st.last_logits
                if (self.faults.nonfinite_fault
                        and not np.all(np.isfinite(row))):
                    # prefill rows come from the scratch cache, not the pool
                    # slot, so they fault the request without striking the
                    # slot (quarantine is for pool-row pathologies)
                    self.metrics.on_nonfinite(st.req.rid, None, tnow)
                    self._finish(slot, "fault", tnow)
                else:
                    tok = sample_token(row, st.req.sampling, 0)
                    st.out.append(tok)
                    self.metrics.on_token(st.req.rid, tnow)
                    reason = is_finished(st.out, st.req.sampling)
                    if reason:
                        self._finish(slot, reason, tnow)
                    else:
                        st.state = GENERATING
                        self._generating.add(slot)

        # pooled decode over every generating slot
        gen = sorted(self._generating)
        if gen:
            tokens, pos = self._dec_tokens, self._dec_pos
            pos[:] = -1  # idle rows must stay masked after slot recycling
            for s in gen:
                st = self.slots[s]
                tokens[s] = st.out[-1]
                # the token being fed sits at prompt_len + generated - 1
                pos[s] = st.req.tokens.shape[0] + len(st.out) - 1
            t0 = self.clock()
            logits = self._exec("decode", tokens, pos)
            if logits is _REBUILT:
                return True  # next step re-issues the identical decode
            self.metrics.on_decode_step(len(gen), self.n_slots,
                                        self.clock() - t0)
            tnow = self.clock()
            for s in gen:
                st = self.slots[s]
                row = logits[s]
                if (self.faults.nonfinite_fault
                        and not np.all(np.isfinite(row))):
                    # fail ONLY this request; strike the slot — repeated
                    # non-finite rows mean the pool row itself is sick
                    self.metrics.on_nonfinite(st.req.rid, s, tnow)
                    self._strikes[s] = self._strikes.get(s, 0) + 1
                    self._finish(s, "fault", tnow)
                    if self._strikes[s] >= self.faults.quarantine_after:
                        self.quarantine(s, reason="nonfinite_rows")
                    continue
                self._strikes[s] = 0
                tok = sample_token(row, st.req.sampling, len(st.out))
                st.out.append(tok)
                self.metrics.on_token(st.req.rid, tnow)
                reason = is_finished(st.out, st.req.sampling)
                if reason:
                    self._finish(s, reason, tnow)
            did = True
        return did

    def _finish(self, slot: int, reason: str, now: float) -> None:
        st = self.slots.pop(slot)
        # membership cleanup BEFORE the reset call: a rebuild inside
        # reset_slot replays from these sets, which must not name a slot
        # that no longer has state
        self._generating.discard(slot)
        if self._prefilling == slot:
            self._prefilling = None
        try:
            self._pending_prefill.remove(slot)
        except ValueError:
            pass
        self.metrics.on_finish(st.req.rid, reason, now)
        self.results[st.req.rid] = GenResult(
            st.req.rid, int(st.req.tokens.shape[0]), list(st.out), reason)
        # _REBUILT is fine here: the rebuilt pool's row is already pristine
        self._exec("reset_slot", slot)
        if slot not in self.quarantined:
            self._free.add(slot)

    # -- drain / run loops ---------------------------------------------------
    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful shutdown: stop admission, shed the queue, give in-flight
        requests `timeout_s` (default FaultPolicy.drain_timeout_s) to finish
        naturally, then cut stragglers with partial results (finish_reason
        "drained"). No request is ever silently lost: every admitted rid
        lands in `results`, every queued rid in the metrics. Returns the
        metrics summary."""
        now = self.clock()
        self._draining = True
        for req in self.scheduler.drain():
            self.metrics.on_shed(req.rid, "drained", now)
        budget = (self.faults.drain_timeout_s if timeout_s is None
                  else float(timeout_s))
        deadline = now + budget
        stalled = 0
        while self.slots and self.clock() < deadline:
            if self.step():
                stalled = 0
            else:
                stalled += 1
                if stalled >= self.faults.stuck_after:
                    break  # livelocked mid-drain: cut, don't hang shutdown
        tnow = self.clock()
        for slot in sorted(self.slots):
            self._finish(slot, "drained", tnow)
        return self.metrics.summary()

    def run_until_idle(self, max_steps: int = 1_000_000) -> dict:
        """Drain queue + slots; returns the metrics summary. A tripped
        preemption guard (SIGTERM) hands off to `drain()`; a livelock —
        pending work that `stuck_after` consecutive step()s cannot advance,
        or `max_steps` exhausted with work remaining — raises `EngineStuck`
        with per-slot diagnostics instead of silently returning a partial
        summary."""
        stalled = 0
        for _ in range(max_steps):
            if self.guard is not None and self.guard.requested:
                return self.drain()
            if self.step():
                stalled = 0
            else:
                if not self.has_work:
                    return self.metrics.summary()
                stalled += 1
                if stalled >= self.faults.stuck_after:
                    raise EngineStuck(
                        f"no progress in {stalled} consecutive steps",
                        self.diagnostics())
        if self.has_work:
            raise EngineStuck(f"work remaining after max_steps={max_steps}",
                              self.diagnostics())
        return self.metrics.summary()
