"""Run sentinel: in-step health checks and rollback recovery.

PyTorch counterpart of `repro.train.sentinel`. Low-bit QAT is unstable by
construction; its pathologies show at run time as a non-finite loss or
gradient, a loss spike, or a collapsed / exploded LSQ scale. Two layers:

1. `health_check` (inside `train_step`) computes a health bitmask on the
   device. The port then syncs that one value to the host (the loop logs
   the loss every step anyway) and, on a fatal verdict, skips the
   optimizer: params, moments and the error-feedback tree are left as
   they were. The JAX package computes the update and discards it with a
   device-side select (`select_update`, kept here for trees).
2. `SentinelRunner` (driven by `launch/train.py`): after `k_consecutive`
   fatal steps it rolls back to the newest CRC-verified checkpoint with an
   LR backoff (`lr_scale` in `SentinelState`), with bounded retries before
   `SentinelAbort`.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as T

# ---------------------------------------------------------------- health bits
OK = 0
NONFINITE_LOSS = 1 << 0   # loss is NaN/inf
NONFINITE_GRAD = 1 << 1   # any gradient leaf contains NaN/inf
LOSS_SPIKE = 1 << 2       # z-score of loss vs its EMA exceeds z_max
SCALE_COLLAPSE = 1 << 3   # some quantizer scale |s| < scale_min (or non-finite)
SCALE_EXPLODE = 1 << 4    # some quantizer scale |s| > scale_max
OSC_SPIKE = 1 << 5        # oscillation fraction (Eq. 12) above osc_frac_max

#: bits that skip the update by default (OSC_SPIKE is advisory)
DEFAULT_FATAL = (NONFINITE_LOSS | NONFINITE_GRAD | LOSS_SPIKE
                 | SCALE_COLLAPSE | SCALE_EXPLODE)

BIT_NAMES = {NONFINITE_LOSS: "nonfinite_loss", NONFINITE_GRAD: "nonfinite_grad",
             LOSS_SPIKE: "loss_spike", SCALE_COLLAPSE: "scale_collapse",
             SCALE_EXPLODE: "scale_explode", OSC_SPIKE: "osc_spike"}


def describe(bits: int) -> str:
    """Human-readable rendering of a health bitmask ('ok' when clean)."""
    names = [n for b, n in sorted(BIT_NAMES.items()) if bits & b]
    return "+".join(names) if names else "ok"


@dataclasses.dataclass(frozen=True)
class SentinelConfig:
    """Static sentinel policy."""

    # --- in-step detection thresholds ---
    loss_momentum: float = 0.02   # EMA momentum for loss mean/second-moment
    z_max: float = 6.0            # loss z-score above which a step is a spike
    spike_warmup: int = 20        # healthy steps before the spike guard arms
    scale_min: float = 1e-7       # |scale| below this = collapsed quantizer
    scale_max: float = 1e4        # |scale| above this = exploded quantizer
    osc_frac_max: float = 0.5     # Eq. 12 oscillation fraction alarm level
    fatal_bits: int = DEFAULT_FATAL
    # --- host-side recovery policy (SentinelRunner) ---
    k_consecutive: int = 3        # fatal streak length that triggers rollback
    max_retries: int = 3          # rollbacks before SentinelAbort
    lr_backoff: float = 0.5       # lr_scale multiplier applied per rollback


class SentinelState(NamedTuple):
    """Per-run sentinel telemetry (0-d tensors), carried in the train state
    and checkpointed with it."""

    loss_ema: torch.Tensor   # f32: EMA of healthy losses
    loss_sq: torch.Tensor    # f32: EMA of healthy squared losses
    obs: torch.Tensor        # i32: healthy observations folded into the EMA
    lr_scale: torch.Tensor   # f32: multiplicative LR backoff (host-set)
    skipped: torch.Tensor    # i32: total updates skipped as fatal


def init_sentinel_state(device=None) -> SentinelState:
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return SentinelState(loss_ema=torch.zeros((), **f32),
                         loss_sq=torch.zeros((), **f32),
                         obs=torch.zeros((), **i32),
                         lr_scale=torch.ones((), **f32),
                         skipped=torch.zeros((), **i32))


def _tree_all_finite(tree) -> torch.Tensor:
    flags = [torch.isfinite(leaf).all() for leaf in T.leaves(tree)
             if torch.is_floating_point(leaf)]
    if not flags:
        return torch.tensor(True)
    return torch.stack(flags).all()


def _flag(cond: torch.Tensor, bit: int) -> torch.Tensor:
    return cond.to(torch.int32) * bit


def health_check(loss, grads, leaves, osc_frac: Optional[torch.Tensor],
                 st: SentinelState, scfg: SentinelConfig):
    """Returns ``(bits, fatal, new_state)``: bits an int32 0-d tensor, fatal
    a bool 0-d tensor, on loss's device.

    loss: this step's train loss (pre-update); grads: the gradient tree;
    leaves: `quant_leaves(params, qcfg)` triples (their scales are checked);
    osc_frac: the previous step's mean oscillation fraction, or None.
    Only healthy, finite losses are folded into the EMA statistics.
    """
    loss = torch.as_tensor(loss, dtype=torch.float32)
    dev = loss.device
    loss_ok = torch.isfinite(loss)
    bits = _flag(~loss_ok, NONFINITE_LOSS)
    bits = bits | _flag(~_tree_all_finite(grads).to(dev), NONFINITE_GRAD)

    # loss-spike guard: z-score against the EMA of healthy losses, armed
    # after `spike_warmup` healthy observations
    var = torch.clamp(st.loss_sq - st.loss_ema ** 2, min=0.0)
    z = (loss - st.loss_ema) * torch.rsqrt(var + 1e-12)
    armed = st.obs >= scfg.spike_warmup
    bits = bits | _flag(armed & loss_ok & (z > scfg.z_max), LOSS_SPIKE)

    if leaves:
        flat = torch.cat([torch.abs(s.to(torch.float32).reshape(-1).to(dev))
                          for _, s, _ in leaves])
        finite = torch.isfinite(flat)
        collapsed = torch.any(~finite | (flat < scfg.scale_min))
        exploded = torch.any(finite & (flat > scfg.scale_max))
        bits = bits | _flag(collapsed, SCALE_COLLAPSE)
        bits = bits | _flag(exploded, SCALE_EXPLODE)

    if osc_frac is not None:
        bits = bits | _flag(torch.as_tensor(osc_frac) > scfg.osc_frac_max,
                            OSC_SPIKE)

    fatal = (bits & scfg.fatal_bits) != 0
    upd = (~fatal) & loss_ok
    m = scfg.loss_momentum
    first = st.obs == 0
    ema = torch.where(first, loss, (1.0 - m) * st.loss_ema + m * loss)
    sq = torch.where(first, loss ** 2, (1.0 - m) * st.loss_sq + m * loss ** 2)
    new = SentinelState(
        loss_ema=torch.where(upd, ema, st.loss_ema),
        loss_sq=torch.where(upd, sq, st.loss_sq),
        obs=st.obs + upd.to(torch.int32),
        lr_scale=st.lr_scale,
        skipped=st.skipped + fatal.to(torch.int32))
    return bits, fatal, new


def select_update(fatal: torch.Tensor, old_tree, new_tree):
    """The old tree where ``fatal`` (0-d bool), else the new one, leaf by
    leaf on the device."""
    return T.map_tree(lambda o, n: torch.where(fatal, o, n), old_tree, new_tree)


def apply_lr_backoff(state: dict, factor: float) -> dict:
    """Host-side: multiply the sentinel lr_scale (used after a rollback).
    Returns a shallow-copied state dict."""
    sent = state["sent"]
    out = dict(state)
    out["sent"] = sent._replace(lr_scale=sent.lr_scale.to(torch.float32) * factor)
    return out


class SentinelAbort(RuntimeError):
    """Raised when recovery retries are exhausted (hard failure)."""


class SentinelRunner:
    """Host-side recovery driver around a CheckpointManager: `observe` each
    step's health bits; True means roll back now (`rollback`)."""

    def __init__(self, scfg: SentinelConfig, mgr, like):
        self.scfg = scfg
        self.mgr = mgr
        self.like = like
        self.fatal_streak = 0
        self.retries = 0
        self.rollbacks = 0

    def observe(self, bits: int) -> bool:
        """Feed one step's health bitmask; True => roll back now."""
        if bits & self.scfg.fatal_bits:
            self.fatal_streak += 1
        else:
            self.fatal_streak = 0
        return self.fatal_streak >= self.scfg.k_consecutive

    def rollback(self, state: dict):
        """Restore the newest verified checkpoint and apply the LR backoff.
        Returns ``(state, resume_step)`` (checkpoint label + 1); raises
        SentinelAbort when retries are spent or no checkpoint verifies."""
        if self.retries >= self.scfg.max_retries:
            raise SentinelAbort(
                f"{self.retries} rollbacks exhausted; last streak of "
                f"{self.fatal_streak} fatal steps did not recover")
        restored = self.mgr.rollback(self.like)
        if restored is None:
            raise SentinelAbort("no verified checkpoint available to roll "
                                "back to (all corrupt or none saved yet)")
        new_state, step = restored
        if "sent" in state and "sent" in new_state:
            # keep the current backoff history, not the checkpointed one
            new_state["sent"] = new_state["sent"]._replace(
                lr_scale=state["sent"].lr_scale.clone())
        new_state = apply_lr_backoff(new_state, self.scfg.lr_backoff)
        self.retries += 1
        self.rollbacks += 1
        self.fatal_streak = 0
        return new_state, step + 1
