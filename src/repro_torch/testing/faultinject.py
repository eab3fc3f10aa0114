"""Deterministic fault injectors for the run sentinel and the serving
sentinel: the port's `repro.testing.faultinject`, both halves.

Every injector is reproducible (seeded byte corruption, fixed step
triggers, one-shot host hooks, call-index-keyed executor wrappers), so the
detect -> skip -> rollback -> resume loop of `launch/train.run_training`
and the detect -> fault -> quarantine / retry -> rebuild -> replay loop of
`serve.ServeEngine` can be exercised end to end from tests
(tests/test_torch_faultinject_train.py, tests/test_torch_serve_faults.py)
and from `chip_smoke.py` on the card.

Training-side injection planes:

* **in the step** (`nan_loss_at`, `nan_grads_at`): `extra_loss(params,
  step)` terms added to the loss, which fire at chosen steps inside the
  forward and backward, where a real overflow would appear. The step
  counter is a CPU tensor, so the trigger costs no device sync; the term
  lives on the params' device.
* **between steps** (`OneShot` + poisoners, checkpoint corrupters,
  SIGTERM): `on_step(i, state)` hooks that change the state or the
  checkpoint directory. A poisoner returns a new state whose poisoned leaf
  is a new tensor (the old one is untouched); the poison PERSISTS until a
  rollback restores a clean state: the sentinel skips every poisoned
  update, so only recovery (not luck) brings the run back. Checkpoints are
  copied to the host when they are submitted, so a poison never reaches a
  checkpoint taken before it.

Serving-side chaos (the "serving chaos harness" section below): executor
proxies that poison chosen (decode_call, slot) logits rows with NaN, raise
transiently (`flaky_executor`) or persistently (`crashing_executor`),
deliver SIGTERM on a chosen executor call, corrupt a pool slot's KV cache in
place (`corrupt_slot`: the detection then runs on GENUINE cache garbage,
not synthetic logits), and jump the engine clock (`ClockJumper`). All are
keyed by deterministic call counters: no wall-clock, no randomness.
"""
from __future__ import annotations

import os
import signal
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.train import checkpoint as ckpt

# ------------------------------------------------------------- in the step


def _steps(steps: Sequence[int]) -> frozenset:
    return frozenset(int(s) for s in steps)


def _device(params) -> torch.device:
    return T.leaves(params)[0].device


def nan_loss_at(steps: Sequence[int]) -> Callable:
    """extra_loss(params, step): NaN LOSS at the given steps; the term does
    not depend on the params, so the gradients stay finite (isolates the
    NONFINITE_LOSS detector from NONFINITE_GRAD)."""
    trigger = _steps(steps)

    def extra(params, step):
        hit = int(step) in trigger
        return torch.full((), float("nan") if hit else 0.0,
                          dtype=torch.float32, device=_device(params))

    return extra


def nan_grads_at(steps: Sequence[int]) -> Callable:
    """extra_loss(params, step): NaN loss AND NaN gradients on every leaf at
    the given steps (the term touches every floating parameter, so
    d(nan * x)/dx = nan everywhere: the shape of a genuine fp overflow in
    the backward). On other steps the term is the constant 0, as the
    reference's 0 * sum is in value and in its gradient."""
    trigger = _steps(steps)

    def extra(params, step):
        if int(step) not in trigger:
            return torch.zeros((), dtype=torch.float32, device=_device(params))
        touch = sum(torch.sum(p).to(torch.float32) for p in T.leaves(params)
                    if torch.is_floating_point(p))
        return torch.full((), float("nan"), dtype=torch.float32,
                          device=_device(params)) * touch

    return extra


# ------------------------------------------------------------ between steps


class OneShot:
    """on_step hook firing `times` times at loop index `at_step`, then never
    again, so a rollback's deterministic replay of the same step passes
    clean and the run can actually recover."""

    def __init__(self, at_step: int, fn: Callable, times: int = 1):
        self.at_step = at_step
        self.fn = fn
        self.times = times
        self.fired = 0

    def __call__(self, i: int, state):
        if i == self.at_step and self.fired < self.times:
            self.fired += 1
            return self.fn(state)
        return None


def chain(*hooks: Callable) -> Callable:
    """Compose on_step hooks (later hooks see earlier hooks' state)."""

    def run(i, state):
        for h in hooks:
            out = h(i, state)
            if out is not None:
                state = out
        return state

    return run


def _first_scale_path(params, prefix=()):
    """Depth-first (sorted keys, then list order) path to the first
    quantizer `w_scale` leaf: ("embed", "w_scale") on the models whose
    token embedding is quantized, as in the reference's tree."""
    if isinstance(params, dict):
        for k in sorted(params.keys()):
            if k == "w_scale":
                return prefix + (k,)
            found = _first_scale_path(params[k], prefix + (k,))
            if found is not None:
                return found
    elif isinstance(params, (tuple, list)):
        for idx, child in enumerate(params):
            found = _first_scale_path(child, prefix + (idx,))
            if found is not None:
                return found
    return None


def _set_path(tree, path, fn):
    """A copy of tree (new dicts and lists along path, every other node
    shared) whose leaf at path is fn(leaf)."""
    if not path:
        return fn(tree)
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        out = dict(tree)
        out[head] = _set_path(tree[head], rest, fn)
        return out
    seq = list(tree)
    seq[head] = _set_path(seq[head], rest, fn)
    return type(tree)(seq) if isinstance(tree, tuple) else seq


def _scale_path(state: dict) -> tuple:
    path = _first_scale_path(state["params"])
    if path is None:
        raise ValueError("no w_scale leaf found (fp config?)")
    return path


def collapse_scale(state: dict, value: float = 0.0) -> dict:
    """Zero (or set) the first quantizer weight scale: the LSQ collapse
    pathology, where the quantizer output and its STE gradient both die."""
    out = dict(state)
    out["params"] = _set_path(state["params"], _scale_path(state),
                              lambda s: torch.full_like(s, value))
    return out


def poison_params_nan(state: dict) -> dict:
    """NaN an entire weight tensor (the `w` beside the first `w_scale`): the
    forward, the loss and every gradient go non-finite on the NEXT step and
    STAY so until a rollback restores clean params (a skipped update keeps
    the poison: recovery, not luck, ends the outage)."""
    w_path = _scale_path(state)[:-1] + ("w",)
    out = dict(state)
    out["params"] = _set_path(state["params"], w_path,
                              lambda w: torch.full_like(w, float("nan")))
    return out


def sigterm_at(at_step: int) -> OneShot:
    """Deliver SIGTERM to this process at the given step (the preemption
    path: PreemptionGuard flips its flag; the loop force-checkpoints and
    exits)."""

    def fire(state):
        os.kill(os.getpid(), signal.SIGTERM)
        return None

    return OneShot(at_step, fire)


# ----------------------------------------------------- checkpoint corruption


def _target_npz(path_dir: str, step: Optional[int]) -> str:
    if step is None:
        step = ckpt.latest_step(path_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint to corrupt in {path_dir}")
    return os.path.join(path_dir, ckpt._ckpt_name(step))


def corrupt_checkpoint(path_dir: str, step: Optional[int] = None, *,
                       nbytes: int = 64, seed: int = 0) -> str:
    """Flip `nbytes` bytes of a checkpoint payload at deterministic,
    seed-derived offsets (the reference's LCG, so the same offsets for the
    same file size and seed; the manifest is left intact: the scenario
    `latest_step` / `restore` must survive by falling back on the CRC)."""
    path = _target_npz(path_dir, step)
    size = os.path.getsize(path)
    # deterministic LCG over the file body, skipping the zip local header
    offsets, x = [], (seed * 2654435761 + 12345) & 0x7FFFFFFF
    lo = min(128, size - 1)
    for _ in range(nbytes):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        offsets.append(lo + x % max(size - lo, 1))
    with open(path, "r+b") as f:
        for off in offsets:
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))
    return path


def truncate_checkpoint(path_dir: str, step: Optional[int] = None, *,
                        keep_frac: float = 0.5) -> str:
    """Truncate a checkpoint payload (the crashed-writer / partial-flush
    scenario; the atomic-rename protocol means this can only come from
    outside interference, which is what it simulates)."""
    path = _target_npz(path_dir, step)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(int(size * keep_frac), 1))
    return path


def delete_checkpoint_payload(path_dir: str, step: Optional[int] = None) -> str:
    """Remove the .npz but leave its manifest: the orphaned-manifest
    scenario `latest_step` must skip."""
    path = _target_npz(path_dir, step)
    os.remove(path)
    return path


def flaky(fn: Callable, fail_times: int, exc: type = OSError) -> Callable:
    """Wrap a callable to raise `exc` on its first `fail_times` invocations
    then pass through (async-writer crash + retry tests: monkeypatch
    `checkpoint.save` with `flaky(checkpoint.save, 2)`; `flaky_executor`
    wraps one executor op with it)."""
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
