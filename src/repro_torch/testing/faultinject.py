"""Deterministic fault injectors for the serving sentinel: the serving half
of the JAX package's `repro.testing.faultinject`, over the port's engine.

Executor proxies poison chosen (decode_call, slot) logits rows with NaN,
raise transiently (`flaky_executor`) or persistently (`crashing_executor`),
deliver SIGTERM on a chosen executor call, corrupt a pool slot's KV cache
in place (`corrupt_slot`: the detection then runs on GENUINE cache garbage,
not synthetic logits), and jump the engine clock (`ClockJumper`). All are
keyed by deterministic call counters: no wall-clock, no randomness. They
drive the detect -> fault -> quarantine / retry -> rebuild -> replay loop
of `repro_torch.serve.ServeEngine` from tests
(tests/test_torch_serve_faults.py). The training half (NaN losses and
gradients inside the step, state poisoners, checkpoint corrupters) is not
ported yet.
"""
from __future__ import annotations

import os
import signal
from typing import Callable, Sequence

import numpy as np


def flaky(fn: Callable, fail_times: int, exc: type = OSError) -> Callable:
    """Wrap a callable to raise `exc` on its first `fail_times` invocations
    then pass through (`flaky_executor` wraps one executor op with it)."""
    count = {"n": 0}

    def wrapped(*a, **kw):
        if count["n"] < fail_times:
            count["n"] += 1
            raise exc(f"injected failure {count['n']}/{fail_times}")
        return fn(*a, **kw)

    return wrapped


# ------------------------------------------------- serving chaos harness


class ExecutorProxy:
    """Transparent ServeEngine-executor wrapper: forwards attributes
    (n_slots/max_len/chunk/pool/...) and the five engine-called ops to
    `inner`. Chaos wrappers subclass or shadow individual ops; the engine
    never knows the difference. Note a rebuild (`executor_factory`)
    replaces the WHOLE proxy — the factory decides whether the replacement
    is wrapped again (still-faulty hardware) or clean (recovered)."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def scratch_reset(self):
        return self.inner.scratch_reset()

    def prefill_chunk(self, tokens, start_pos):
        return self.inner.prefill_chunk(tokens, start_pos)

    def commit_prefill(self, slot):
        return self.inner.commit_prefill(slot)

    def decode(self, tokens, pos):
        return self.inner.decode(tokens, pos)

    def reset_slot(self, slot):
        return self.inner.reset_slot(slot)


class NaNLogitsInjector(ExecutorProxy):
    """Poison logits rows with a non-finite value at exact deterministic
    coordinates: `rows` is a set of (decode_call_index, slot) pairs (fire
    once each), `persist_slots` poisons those slots' rows on EVERY decode
    while active (the permanently-sick-pool-row scenario that must end in
    quarantine), `prefill_calls` poisons the returned row of the i-th
    prefill_chunk call (scratch-side fault: the request dies, no slot
    strike). The underlying executor runs normally — only the returned
    logits are doctored, so non-poisoned rows stay bit-identical."""

    def __init__(self, inner, rows: Sequence = (), persist_slots: Sequence = (),
                 prefill_calls: Sequence = (), value: float = float("nan")):
        super().__init__(inner)
        self.rows = {(int(c), int(s)) for c, s in rows}
        self.persist_slots = {int(s) for s in persist_slots}
        self.prefill_calls = {int(c) for c in prefill_calls}
        self.value = value
        self.decode_calls = 0
        self.prefill_count = 0

    def prefill_chunk(self, tokens, start_pos):
        out = self.inner.prefill_chunk(tokens, start_pos)
        i = self.prefill_count
        self.prefill_count += 1
        if i in self.prefill_calls:
            out = np.array(out, np.float32, copy=True)
            out[0] = self.value
        return out

    def decode(self, tokens, pos):
        out = self.inner.decode(tokens, pos)
        i = self.decode_calls
        self.decode_calls += 1
        hit = {s for (c, s) in self.rows if c == i}
        hit |= {s for s in self.persist_slots if pos[s] >= 0}
        if hit:
            out = np.array(out, copy=True)
            for s in hit:
                out[s, 0] = self.value
        return out


def flaky_executor(inner, op: str = "decode", fail_times: int = 2,
                   exc: type = RuntimeError):
    """Proxy whose `op` raises on its first `fail_times` calls then passes
    (the TRANSIENT executor fault: the engine's bounded retry must absorb
    it without a rebuild, and streams must stay bit-identical)."""
    proxy = ExecutorProxy(inner)
    setattr(proxy, op, flaky(getattr(inner, op), fail_times, exc))
    return proxy


def crashing_executor(inner, op: str = "decode", at_call: int = 0,
                      exc: type = RuntimeError):
    """Proxy whose `op` PERSISTENTLY raises from its `at_call`-th invocation
    on (the crashed-executor scenario: retries exhaust, the engine rebuilds
    from `executor_factory` and deterministically replays in-flight work)."""
    proxy = ExecutorProxy(inner)
    orig = getattr(inner, op)
    count = {"n": 0}

    def wrapped(*a, **kw):
        i = count["n"]
        count["n"] += 1
        if i >= at_call:
            raise exc(f"injected persistent {op} crash (call {i})")
        return orig(*a, **kw)

    setattr(proxy, op, wrapped)
    return proxy


def sigterm_executor(inner, op: str = "decode", at_call: int = 0):
    """Proxy delivering SIGTERM to this process on the `at_call`-th `op`
    call (mid-serve preemption: PreemptionGuard flips `requested` and
    run_until_idle hands off to the graceful drain)."""
    proxy = ExecutorProxy(inner)
    orig = getattr(inner, op)
    count = {"n": 0}

    def wrapped(*a, **kw):
        i = count["n"]
        count["n"] += 1
        if i == at_call:
            os.kill(os.getpid(), signal.SIGTERM)
        return orig(*a, **kw)

    setattr(proxy, op, wrapped)
    return proxy


def corrupt_slot(executor, slot: int, value: float = float("nan")) -> None:
    """Poison every FLOAT tensor of one pool slot's cache rows in place:
    fp K/V, or the per-(row, token, head) scales of a quantized cache (int
    codes can't hold NaN; a NaN scale makes every dequant NaN). Unlike
    NaNLogitsInjector this corrupts the REAL cache, so the next decode's
    logits row for that slot goes non-finite through the actual attention
    path and the engine's detection must fire on genuine garbage. Row
    independence keeps every other slot bit-identical (an MoE layer routes
    the NaN token too, and at a capacity without drops it takes no other
    token's place), and the slot-reset template re-insert heals the row
    after the faulted request finishes. The port's pool is a per-layer list
    updated in place (`pool["layers"][i]["kv"]`, no stacked group axis).
    Requires an executor with a `.pool` cache (ModelExecutor)."""
    for layer in executor.pool["layers"]:
        for t in layer["kv"]:
            if t is not None and t.is_floating_point():
                t[slot] = value


class ClockJumper:
    """Clock wrapper that jumps forward by `jump_s` once the wrapped clock
    reaches `at_time` (NTP step / VM migration / suspend-resume chaos:
    deadline and max_wait logic must shed, not wedge). Callable — pass
    `ClockJumper(clk.now, at_time=1.0, jump_s=60.0)` as the engine clock."""

    def __init__(self, clock: Callable[[], float], at_time: float,
                 jump_s: float):
        self.clock = clock
        self.at_time = float(at_time)
        self.jump_s = float(jump_s)

    def __call__(self) -> float:
        t = self.clock()
        return t + self.jump_s if t >= self.at_time else t
