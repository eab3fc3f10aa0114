"""The training step: KD loss, gradient accumulation, AdamW, run sentinel.

PyTorch counterpart of `repro.train.train_step`:

  loss = L_KD (Eq. 8/9, or hard CE when kd="none") + lb_coef * L_lb

Gradient accumulation is a Python loop over microbatches whose f32
gradients are summed from zeros and divided by the count. The forward
checkpoints every block (remat), as the JAX step does. OBR, oscillation
tracking and gradient compression are not ported yet and raise
NotImplementedError when the step is built (`state.check_supported`).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.kd import hard_ce, kd_from_teacher_logits, sparse_soft_ce
from repro_torch.core.policy import QuantConfig
from repro_torch.models.model import forward, quant_leaves
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


def make_train_step(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig, *,
                    teacher_forward: Optional[Callable] = None,
                    extra_loss: Optional[Callable] = None):
    """train_step(state, batch) -> (state, metrics).

    The params and moments are updated IN PLACE (the returned state holds
    the same tensors). With the sentinel on, the health verdict is read on
    the host before the optimizer runs; a fatal step skips the update, so
    params, moments and `err` stay as they were.
    """
    check_supported(qcfg, tcfg)
    grad_fn = make_grad_fn(cfg, qcfg, tcfg, teacher_forward=teacher_forward,
                           extra_loss=extra_loss)

    def train_step(state: dict, batch: dict):
        params, step = state["params"], state["step"]
        loss, metrics, grads = grad_fn(params, batch, step)
        metrics["loss_obr"] = torch.zeros_like(loss)
        metrics["obr_lambda"] = torch.zeros_like(loss)
        lr = _lr(tcfg, step)
        fatal = False
        new_sent = state["sent"]
        if tcfg.sentinel is not None:
            health, fatal_t, new_sent = sent.health_check(
                loss, grads, quant_leaves(params, qcfg), None, state["sent"],
                tcfg.sentinel)
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
        metrics.update({"loss": loss, "lr": lr, **opt_metrics})
        new_state = dict(state, step=step + 1, sent=new_sent)
        return new_state, metrics

    return train_step
