"""The training step: KD + OBR + load-balance loss, gradient
accumulation, AdamW, oscillation telemetry, run sentinel.

PyTorch counterpart of `repro.train.train_step`:

  loss = L_KD (Eq. 8/9, or hard CE when kd="none")
       + lambda(t) * L_OBR (Eq. 10, cosine-ramped)
       + lb_coef * L_lb (MoE)

Gradient accumulation is a Python loop over microbatches whose f32
gradients are summed from zeros and divided by the count. The forward
checkpoints every block (remat), as the JAX step does. OBR is batch-
independent and taken once a step, outside the microbatch loop, leaf by
leaf: each quantized weight's Eq. 10 value and gradient come from their own
small autograd graph (the sum over leaves is separable), and its gradient
is added as g + lambda * g_obr, as the reference does. With
`qcfg.track_oscillation`, the Eq. 12 update runs on the post-update
weights. Gradient compression is not ported yet and raises
NotImplementedError when the step is built (`state.check_supported`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.kd import hard_ce, kd_from_teacher_logits, sparse_soft_ce
from repro_torch.core.obr import obr_lambda_schedule, obr_loss
from repro_torch.core.oscillation import oscillation_fraction, update_osc_state
from repro_torch.core.policy import QuantConfig
from repro_torch.models.model import (forward, jax_leaf_groups,
                                     quant_leaf_paths, quant_leaves)
from repro_torch.optim import adamw, schedule
from repro_torch.train import sentinel as sent
from repro_torch.train.state import TrainConfig, check_supported

METRIC_KEYS = ("loss_main", "lb_loss", "drop_frac", "act_sdam")


def make_loss_fn(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig, *,
                 teacher_forward: Optional[Callable] = None,
                 extra_loss: Optional[Callable] = None):
    """loss_fn(params, batch, step) -> (loss, metrics)."""
    def loss_fn(params, batch, step):
        logits, aux = forward(params, batch, cfg, qcfg, remat=True)
        if tcfg.kd == "mckd":
            main = sparse_soft_ce(logits, batch["kd_idx"], batch["kd_p"])
        elif tcfg.kd == "teacher":
            main = kd_from_teacher_logits(logits, teacher_forward(batch),
                                          temperature=tcfg.kd_temperature)
        else:
            main = hard_ce(logits, batch["labels"])
        loss = main + tcfg.lb_coef * aux["lb_loss"]
        if extra_loss is not None:
            loss = loss + extra_loss(params, step)
        metrics = {"loss_main": main, "lb_loss": aux["lb_loss"],
                   "drop_frac": aux["drop_frac"], "act_sdam": aux["act_sdam"]}
        return loss, metrics
    return loss_fn


def make_grad_fn(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig, *,
                 teacher_forward: Optional[Callable] = None,
                 extra_loss: Optional[Callable] = None):
    """grad_fn(params, batch, step) -> (loss, metrics, grads): f32 grads
    shaped like params, averaged over `tcfg.grad_accum` microbatches."""
    loss_fn = make_loss_fn(cfg, qcfg, tcfg, teacher_forward=teacher_forward,
                           extra_loss=extra_loss)

    def one(params, batch, step):
        flat = T.leaves(params)
        live = [p.detach().requires_grad_(True) for p in flat]
        loss, metrics = loss_fn(T.unflatten(params, live), batch, step)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return (loss.detach(), {k: metrics[k].detach() for k in METRIC_KEYS},
                T.unflatten(params, grads))

    def grad_fn(params, batch, step):
        n = tcfg.grad_accum
        if n <= 1:
            return one(params, batch, step)
        size = next(iter(batch.values())).shape[0] // n
        g_acc = T.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
        dev = T.leaves(params)[0].device
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
                 for k in METRIC_KEYS}
        for i in range(n):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            l, m, g = one(params, mb, step)
            g_acc = T.map_tree(torch.add, g_acc, g)
            loss = loss + l
            m_acc = {k: m_acc[k] + m[k] for k in METRIC_KEYS}
        inv = 1.0 / n
        return (loss * inv, {k: v * inv for k, v in m_acc.items()},
                T.map_tree(lambda g: g * inv, g_acc))

    return grad_fn


def _lr(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    sched = (schedule.linear_warmup_decay if tcfg.lr_schedule == "linear"
             else schedule.warmup_cosine)
    return sched(step, peak=tcfg.adamw.lr_peak, warmup_steps=tcfg.warmup_steps,
                 total_steps=tcfg.total_steps)


def _sub(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def obr_(params: dict, grads: dict, qcfg: QuantConfig, lam: torch.Tensor
         ) -> torch.Tensor:
    """Eq. 10 summed over every quantized weight (the reference's
    total_obr_loss at lambda 1), returned as a 0-d f32; each weight's
    gradient in `grads` becomes g + lam * dL_OBR/dw, IN PLACE of its leaf.
    One leaf at a time, so only one leaf's graph is alive."""
    total = None
    for path, w, s, spec in quant_leaf_paths(params, qcfg):
        wl = w.detach().requires_grad_(True)
        with torch.enable_grad():
            v = obr_loss(wl, s, spec)
            (og,) = torch.autograd.grad(v, wl)
        v = v.detach()
        total = v if total is None else total + v
        sub = _sub(grads, path)
        sub["w"] = sub["w"] + lam.to(og.device) * og
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return total


def osc_fraction_mean(osc: tuple, groups: list, threshold: float) -> torch.Tensor:
    """The reference's osc_frac: the mean over its quant leaves
    (`jax_leaf_groups`) of each leaf's oscillating fraction, a stacked
    leaf's fraction being the mean over its layers (all of one size)."""
    fr = [oscillation_fraction(st, threshold) for st in osc]
    return torch.mean(torch.stack([torch.mean(torch.stack([fr[i] for i in g]))
                                   for _, g in groups]))


def make_train_step(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig, *,
                    teacher_forward: Optional[Callable] = None,
                    extra_loss: Optional[Callable] = None):
    """train_step(state, batch) -> (state, metrics).

    The params and moments are updated IN PLACE (the returned state holds
    the same tensors); the oscillation state is replaced leaf by leaf. With
    the sentinel on, the health verdict is read on the host before the
    optimizer runs; a fatal step skips the update, so params, moments,
    `osc` and `err` stay as they were.
    """
    check_supported(tcfg)
    grad_fn = make_grad_fn(cfg, qcfg, tcfg, teacher_forward=teacher_forward,
                           extra_loss=extra_loss)
    osc_groups = None

    def train_step(state: dict, batch: dict):
        nonlocal osc_groups
        params, step = state["params"], state["step"]
        loss, metrics, grads = grad_fn(params, batch, step)
        if qcfg.obr_lambda > 0.0:
            lam = obr_lambda_schedule(step, tcfg.total_steps,
                                      qcfg.obr_lambda).to(loss.device)
            obr_val = obr_(params, grads, qcfg, lam).to(loss.device)
            loss = loss + lam * obr_val
            metrics["loss_obr"] = obr_val
            metrics["obr_lambda"] = lam
        else:
            metrics["loss_obr"] = torch.zeros_like(loss)
            metrics["obr_lambda"] = torch.zeros_like(loss)
        if qcfg.track_oscillation and osc_groups is None:
            osc_groups = jax_leaf_groups(
                [p for p, _, _, _ in quant_leaf_paths(params, qcfg)], cfg)
        lr = _lr(tcfg, step)
        fatal = False
        new_sent = state["sent"]
        if tcfg.sentinel is not None:
            osc_prev = None
            if qcfg.track_oscillation and state["osc"]:
                osc_prev = osc_fraction_mean(state["osc"], osc_groups,
                                             qcfg.osc_threshold)
            health, fatal_t, new_sent = sent.health_check(
                loss, grads, quant_leaves(params, qcfg), osc_prev,
                state["sent"], tcfg.sentinel)
            lr = lr.to(loss.device) * state["sent"].lr_scale
            fatal = bool(fatal_t)  # the one host sync of the step
            metrics["health"] = health
            metrics["lr_scale"] = state["sent"].lr_scale
            metrics["sentinel_skipped"] = new_sent.skipped
        opt = adamw.AdamWState(state["mu"], state["nu"])
        if fatal:
            opt_metrics = {"grad_norm": adamw.global_norm(grads)}
        else:
            opt_metrics = adamw.update_(grads, opt, params, step, lr, tcfg.adamw)
        new_osc = state["osc"]
        if qcfg.track_oscillation:
            if not fatal:  # Eq. 12 on the post-update weights
                new_osc = tuple(
                    update_osc_state(st, w, s, spec, momentum=qcfg.osc_momentum)
                    for st, (w, s, spec) in zip(state["osc"],
                                                quant_leaves(params, qcfg)))
            metrics["osc_frac"] = osc_fraction_mean(new_osc, osc_groups,
                                                    qcfg.osc_threshold)
        metrics.update({"loss": loss, "lr": lr, **opt_metrics})
        new_state = dict(state, step=step + 1, sent=new_sent, osc=new_osc)
        return new_state, metrics

    return train_step
