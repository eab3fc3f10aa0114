"""The training step: KD + OBR + load-balance loss, gradient
accumulation, optional gradient compression, AdamW, oscillation telemetry,
run sentinel.

PyTorch counterpart of `repro.train.train_step`:

  loss = L_KD (Eq. 8/9, or hard CE when kd="none")
       + lambda(t) * L_OBR (Eq. 10, cosine-ramped)
       + lb_coef * L_lb (MoE)

Gradient accumulation is a Python loop over microbatches whose f32
gradients are summed from zeros and divided by the count. The forward
checkpoints every block (remat), as the JAX step does. OBR is batch-
independent and taken once a step, outside the microbatch loop: each
quantized weight's Eq. 10 value and gradient come from its sums (the sum
over leaves is separable; on a mesh each rank sums its slices and the
ranks add the sums up), and its gradient is added as g + lambda * g_obr,
as the reference does. With
`qcfg.track_oscillation`, the Eq. 12 update runs on the post-update
weights. With `tcfg.compress_grads`, the gradients (OBR's included) go
through int8 compression with error feedback (`optim.grad_compress`)
before the sentinel reads them. `make_eval_step` gives the hard-label
cross-entropy and accuracy of a forward (the paper-table twins' metric).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.core.kd import hard_ce, kd_from_teacher_logits, sparse_soft_ce
from repro_torch.core.obr import ObrStats, obr_grad, obr_lambda_schedule, obr_stats
from repro_torch.core.oscillation import (count_fraction, oscillation_count,
                                          update_osc_state)
from repro_torch.core.policy import QuantConfig
from repro_torch.dist.spmd import WHOLE, Spmd, counted_as, spec_at
from repro_torch.models.model import (forward, jax_leaf_groups,
                                     quant_leaf_paths, quant_leaves, vocab_tp)
from repro_torch.optim import adamw, schedule
from repro_torch.optim.grad_compress import compress_tree
from repro_torch.train import sentinel as sent
from repro_torch.train.state import TrainConfig

METRIC_KEYS = ("loss_main", "lb_loss", "drop_frac", "act_sdam")


def make_loss_fn(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig, *,
                 teacher_forward: Optional[Callable] = None,
                 extra_loss: Optional[Callable] = None, spmd: Spmd = WHOLE):
    """loss_fn(params, batch, step) -> (loss, metrics); `spmd` as in
    `models.model.forward`. Where the head is vocab-parallel, the loss
    reads this rank's logit columns (`core.kd` with the head's split): no
    rank holds the whole logits; `loss_main` is the whole loss on every
    rank."""
    head = vocab_tp(spmd, cfg)[1]

    def loss_fn(params, batch, step):
        logits, aux = forward(params, batch, cfg, qcfg, remat=True, spmd=spmd,
                              whole_logits=False)
        if tcfg.kd == "mckd":
            main = sparse_soft_ce(logits, batch["kd_idx"], batch["kd_p"], tp=head)
        elif tcfg.kd == "teacher":
            main = kd_from_teacher_logits(logits, teacher_forward(batch),
                                          temperature=tcfg.kd_temperature, tp=head)
        else:
            main = hard_ce(logits, batch["labels"], tp=head)
        loss = main + tcfg.lb_coef * aux["lb_loss"]
        if extra_loss is not None:
            loss = loss + extra_loss(params, step)
        metrics = {"loss_main": main, "lb_loss": aux["lb_loss"],
                   "drop_frac": aux["drop_frac"], "act_sdam": aux["act_sdam"]}
        return loss, metrics
    return loss_fn


def make_grad_fn(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig, *,
                 teacher_forward: Optional[Callable] = None,
                 extra_loss: Optional[Callable] = None, spmd: Spmd = WHOLE):
    """grad_fn(params, batch, step) -> (loss, metrics, grads): f32 grads
    shaped like params, averaged over `tcfg.grad_accum` microbatches."""
    loss_fn = make_loss_fn(cfg, qcfg, tcfg, teacher_forward=teacher_forward,
                           extra_loss=extra_loss, spmd=spmd)

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


def obr_(params: dict, grads: dict, qcfg: QuantConfig, lam: torch.Tensor,
         spmd: Spmd = WHOLE) -> torch.Tensor:
    """Eq. 10 summed over every quantized weight (the reference's
    total_obr_loss at lambda 1, one l2 norm a layer's leaf), returned as a
    0-d f32; each weight's gradient in `grads` becomes g + lam * dL_OBR/dw,
    IN PLACE of its leaf. Two passes over this rank's slices: every leaf's
    sums (`obr_stats`, no graph), summed over the ranks that split the leaf
    (`spmd.leaf_sums`, one all-reduce per axis set), then leaf by leaf its
    value and its slice's gradient from them (`obr_grad`)."""
    leaves = quant_leaf_paths(params, qcfg)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    places = [spmd.obr_place(path, w, s) for path, w, s, _ in leaves]
    items = []
    with torch.no_grad():
        for (path, w, s, spec), place in zip(leaves, places):
            wspec = None if spmd.whole else spec_at(spmd.pspecs, path)["w"]
            items += [(t, wspec) for t in obr_stats(w, s, spec, place)]
    with counted_as("obr"):
        sums = spmd.leaf_sums(items)
    total = None
    for j, ((path, w, s, spec), place) in enumerate(zip(leaves, places)):
        v, og = obr_grad(w.detach(), s, spec, ObrStats(*sums[4 * j:4 * j + 4]), place)
        total = v if total is None else total + v
        sub = _sub(grads, path)
        sub["w"] = sub["w"] + lam.to(og.device) * og
    return total


def osc_fraction_mean(osc: tuple, groups: list, threshold: float,
                      spmd: Spmd = WHOLE) -> torch.Tensor:
    """The reference's osc_frac: the mean over its quant leaves
    (`jax_leaf_groups`) of each leaf's oscillating fraction, a stacked
    leaf's fraction being the mean over its layers (all of one size)."""
    fr = osc_fractions(osc, threshold, spmd)
    return torch.mean(torch.stack([torch.mean(torch.stack([fr[i] for i in g]))
                                   for _, g in groups]))


def osc_fractions(osc: tuple, threshold: float, spmd: Spmd = WHOLE) -> list:
    """Each oscillation state's fraction of weights with f > threshold:
    this rank's counts summed over the ranks that split the state
    (`spmd.leaf_sums`, one all-reduce per axis set), divided by the whole
    leaf's size."""
    counts = [oscillation_count(st, threshold) for st in osc]
    specs = [None] * len(osc) if spmd.whole else [sp.freq for sp in spmd.osc_specs]
    with counted_as("oscillation"):
        counts = spmd.leaf_sums(list(zip(counts, specs)))
    return [count_fraction(c, spmd.numel(st.freq, sp))
            for c, st, sp in zip(counts, osc, specs)]


def make_train_step(cfg: ArchConfig, qcfg: QuantConfig, tcfg: TrainConfig, *,
                    teacher_forward: Optional[Callable] = None,
                    extra_loss: Optional[Callable] = None,
                    spmd: Spmd = WHOLE):
    """train_step(state, batch) -> (state, metrics).

    The params and moments are updated IN PLACE (the returned state holds
    the same tensors); the oscillation state is replaced leaf by leaf. With
    the sentinel on, the health verdict is read on the host before the
    optimizer runs; a fatal step skips the update, so params, moments,
    `osc` and `err` stay as they were.

    spmd: the mesh's runtime (`dist.spmd`); where the state holds this
    rank's slices and the batch its rows, the loss, metrics, gradient norm,
    OBR, the oscillation fraction, compression's amax and the sentinel's
    flags come out of all-reduces, so every rank takes the same decisions.
    With tensor-parallel compute the gradients still come back as this
    rank's slices by the state's specs (a model-split leaf's gradient is
    its own slice's, a replicated one's is summed over the model ranks),
    so each of these reads them as on the gathered runtime.
    """
    grad_fn = make_grad_fn(cfg, qcfg, tcfg, teacher_forward=teacher_forward,
                           extra_loss=extra_loss, spmd=spmd)
    osc_groups = None

    def train_step(state: dict, batch: dict):
        nonlocal osc_groups
        params, step = state["params"], state["step"]
        loss, metrics, grads = grad_fn(params, batch, step)
        loss = spmd.mean(loss)
        metrics = {k: spmd.mean(v) for k, v in metrics.items()}
        if qcfg.obr_lambda > 0.0:
            lam = obr_lambda_schedule(step, tcfg.total_steps,
                                      qcfg.obr_lambda).to(loss.device)
            obr_val = obr_(params, grads, qcfg, lam, spmd).to(loss.device)
            loss = loss + lam * obr_val
            metrics["loss_obr"] = obr_val
            metrics["obr_lambda"] = lam
        else:
            metrics["loss_obr"] = torch.zeros_like(loss)
            metrics["obr_lambda"] = torch.zeros_like(loss)
        new_err = state["err"]
        if tcfg.compress_grads:
            grads, new_err = compress_tree(grads, state["err"], amax=spmd.amax)
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
                                             qcfg.osc_threshold, spmd)
            health, fatal_t, new_sent = sent.health_check(
                loss, grads, quant_leaves(params, qcfg), osc_prev,
                state["sent"], tcfg.sentinel, reduce_any=spmd.any)
            lr = lr.to(loss.device) * state["sent"].lr_scale
            fatal = bool(fatal_t)  # the one host sync of the step
            metrics["health"] = health
            metrics["lr_scale"] = state["sent"].lr_scale
            metrics["sentinel_skipped"] = new_sent.skipped
        opt = adamw.AdamWState(state["mu"], state["nu"])
        if fatal:
            opt_metrics = {"grad_norm": spmd.norm(grads)}
            new_err = state["err"]
        else:
            opt_metrics = adamw.update_(grads, opt, params, step, lr, tcfg.adamw,
                                        spmd.norm(grads))
        new_osc = state["osc"]
        if qcfg.track_oscillation:
            if not fatal:  # Eq. 12 on the post-update weights
                new_osc = tuple(
                    update_osc_state(st, *spmd.osc_view(j, path, w, s), spec,
                                     momentum=qcfg.osc_momentum)
                    for j, (st, (path, w, s, spec)) in enumerate(
                        zip(state["osc"], quant_leaf_paths(params, qcfg))))
            metrics["osc_frac"] = osc_fraction_mean(new_osc, osc_groups,
                                                    qcfg.osc_threshold, spmd)
        metrics.update({"loss": loss, "lr": lr, **opt_metrics})
        new_state = dict(state, step=step + 1, sent=new_sent, osc=new_osc,
                         err=new_err)
        return new_state, metrics

    return train_step


def make_eval_step(cfg: ArchConfig, qcfg: QuantConfig):
    """eval_step(params, batch) -> {"ce", "acc"}: the hard-label
    cross-entropy and the argmax accuracy of one forward, no gradients."""
    @torch.no_grad()
    def eval_step(params, batch):
        logits, _ = forward(params, batch, cfg, qcfg)
        ce = hard_ce(logits, batch["labels"])
        pred = torch.argmax(logits, dim=-1)
        acc = torch.mean((pred == batch["labels"].to(pred.dtype))
                         .to(torch.float32))
        return {"ce": ce, "acc": acc}
    return eval_step
