"""Knowledge distillation losses (Eq. 8-9).

PyTorch counterpart of `repro.core.kd`. Vanilla KD (Eq. 8) is the soft
cross-entropy between the teacher's distribution and the quantized
student's; multi-crop KD (Eq. 9) streams pre-computed sparse top-K teacher
labels (probs renormalized over the K support), so no teacher runs during
training (`mckd_loss` averages over the stored views). Every loss is
computed in f32 and averaged over tokens (or over
the tokens a mask keeps).

Vocab-parallel form. `hard_ce`, `sparse_soft_ce`, `soft_ce`,
`kd_from_teacher_logits` and `mckd_loss` take an optional `tp` (the head's
`dist.spmd.TPSplit`). With it, the logits (and `soft_ce`'s teacher
probabilities) are this rank's columns [index n, (index + 1) n) of the
padded vocab, and the loss is the whole logits' on every model rank:
each row's max m comes from an all-reduce over the model ranks (no
gradient), then one all-reduce sums the row's sum of exp(x - m) and its
target term, sum_k w_k (x_k - m) over the targets this rank's columns
hold (a label, top-K ids, or the teacher's probabilities), so the
per-token value is sum_k w_k log(sum exp) - that term. The gradient of
this rank's columns is softmax_local * sum_k w_k - w at the owned
targets, times the upstream gradient (`_VocabParallelCE`, which keeps
the local softmax, one (rows, n) f32 buffer). Its collectives count
under the use "loss" (`dist.spmd.moved_bytes_by_use`): rows x 4 B x
(1 + 2) for `hard_ce` and `sparse_soft_ce` a call, (1 + 3) for
`soft_ce`, (2 + 4) for `kd_from_teacher_logits` (the teacher's own
vocab-parallel softmax first). No gradient reaches the teacher's
probabilities there. With `tp=None` each function is the whole-logits
code above it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.spmd import counted_as


def _reduce(per_tok: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(per_tok)
    mask = mask.to(per_tok.dtype)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token sum_k w_k (lse - x_k) of the whole logits from this rank's
    columns x (..., n) (see the module docstring): sparse, w (..., K) are
    replicated weights of the global class ids (..., K); dense (ids None),
    w (..., n) are the weights of this rank's columns. No gradient to w."""

    @staticmethod
    def forward(ctx, tp, x, ids, w):
        n = x.shape[-1]
        e = x - tp.max_model(torch.amax(x, -1))[..., None]
        if ids is None:
            own = loc = None
            parts = [torch.sum(w * e, -1), torch.sum(w, -1)]
        else:
            loc = ids.to(torch.int64) - tp.index * n
            own = (loc >= 0) & (loc < n)
            loc = torch.clamp(loc, 0, n - 1)
            parts = [torch.sum(torch.where(own, w * torch.gather(e, -1, loc), 0.0), -1)]
        e.exp_()
        sums = tp.from_model(torch.stack([torch.sum(e, -1)] + parts, -1))
        sw = sums[..., 2] if ids is None else torch.sum(w, -1)
        sm = e.div_(sums[..., :1])  # this rank's columns of the softmax
        ctx.save_for_backward(sm, w, sw, loc, own)
        return sw * torch.log(sums[..., 0]) - sums[..., 1]

    @staticmethod
    def backward(ctx, g):
        sm, w, sw, loc, own = ctx.saved_tensors
        gx = sm * (g * sw)[..., None]
        if loc is None:
            gx.addcmul_(w, g[..., None], value=-1.0)
        else:
            gx.scatter_add_(-1, loc, torch.where(own, -(w * g[..., None]), 0.0))
        return None, gx, None, None


def _vocab_parallel(logits: torch.Tensor, tp, ids: Optional[torch.Tensor],
                    w: torch.Tensor) -> torch.Tensor:
    with counted_as("loss"):
        return _VocabParallelCE.apply(tp, logits.to(torch.float32), ids,
                                      w.detach().to(torch.float32))


def _softmax_columns(logits: torch.Tensor, tp) -> torch.Tensor:
    """The softmax of the whole rows from this rank's columns (no
    gradient): a max and a sum over the model ranks."""
    with torch.no_grad(), counted_as("loss"):
        e = torch.exp(logits - tp.max_model(torch.amax(logits, -1))[..., None])
        return e / tp.from_model(torch.sum(e, -1, keepdim=True))


def soft_ce(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
            mask: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """Eq. 8: -(1/N) sum_c p_c^T log p_c^S. Logits (..., C), probs (..., C)
    (with `tp`, both this rank's columns)."""
    if tp is not None:
        return _reduce(_vocab_parallel(student_logits, tp, None, teacher_probs), mask)
    logp = torch.log_softmax(student_logits.to(torch.float32), dim=-1)
    per_tok = -torch.sum(teacher_probs.to(torch.float32) * logp, dim=-1)
    return _reduce(per_tok, mask)


def kd_from_teacher_logits(student_logits: torch.Tensor,
                           teacher_logits: torch.Tensor,
                           temperature: float = 1.0,
                           mask: Optional[torch.Tensor] = None,
                           tp=None) -> torch.Tensor:
    """Vanilla KD with an on-the-fly teacher forward (no teacher gradient).
    With `tp` the student logits are this rank's columns and the teacher's
    are whole (padded vocab): their softmax is taken on the same columns."""
    t = temperature
    if tp is not None:
        n = student_logits.shape[-1]
        if teacher_logits.shape[-1] != n * tp.parts:
            raise ValueError(f"teacher logits of {teacher_logits.shape[-1]} columns "
                             f"for {tp.parts} ranks of {n}")
        probs = _softmax_columns(
            tp.local(teacher_logits.detach().to(torch.float32) / t, -1), tp)
        return soft_ce(student_logits / t, probs, mask, tp) * (t * t)
    probs = torch.softmax(teacher_logits.detach().to(torch.float32) / t, dim=-1)
    return soft_ce(student_logits / t, probs, mask) * (t * t)


def sparse_soft_ce(student_logits: torch.Tensor, topk_idx: torch.Tensor,
                   topk_probs: torch.Tensor,
                   mask: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """MCKD with sparse top-K stored labels: logits (..., C), topk_idx
    (..., K) class indices, topk_probs (..., K) teacher probabilities
    (with `tp`, the logits are this rank's columns; the ids stay global)."""
    if tp is not None:
        return _reduce(_vocab_parallel(student_logits, tp, topk_idx, topk_probs), mask)
    logp = torch.log_softmax(student_logits.to(torch.float32), dim=-1)
    gathered = torch.gather(logp, -1, topk_idx.to(torch.int64))
    per_tok = -torch.sum(topk_probs.to(torch.float32) * gathered, dim=-1)
    return _reduce(per_tok, mask)


def hard_ce(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """Plain next-token cross-entropy (with `tp`, the logits are this rank's
    columns; the labels stay global)."""
    if tp is not None:
        ones = torch.ones(labels.shape + (1,), dtype=torch.float32, device=logits.device)
        return _reduce(_vocab_parallel(logits, tp, labels[..., None], ones), mask)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    return -_reduce(ll, mask)


def mckd_loss(student_logits_crops: torch.Tensor, topk_idx: torch.Tensor,
              topk_probs: torch.Tensor, tp=None) -> torch.Tensor:
    """Eq. 9: the sparse soft-CE averaged over the M stored views.
    student_logits_crops (M, ..., C); topk_idx / topk_probs (M, ..., K)."""
    losses = [sparse_soft_ce(s, i, p, tp=tp)
              for s, i, p in zip(student_logits_crops, topk_idx, topk_probs)]
    return torch.mean(torch.stack(losses))


def make_topk_labels(teacher_logits: torch.Tensor, k: int):
    """Offline step of MCKD: teacher logits -> (top-K int32 indices, probs
    renormalized over the K). Equal probabilities keep the lower index
    first, as `lax.top_k` does (`torch.topk` promises no order among
    ties): `torch.topk` gives the K-th value; every entry above it and,
    where ties cross it, the lowest-index entries equal to it are kept,
    then stably sorted by value."""
    probs = torch.softmax(teacher_logits.to(torch.float32), dim=-1)
    kth = torch.topk(probs, k, dim=-1).values[..., -1:]
    keep = probs >= kth
    flat, kth_flat = keep.view(-1, keep.shape[-1]), kth.reshape(-1, 1)
    extra = flat.sum(-1) - k
    rows = torch.nonzero(extra).squeeze(-1)
    if rows.numel():  # ties across the K-th value: drop the highest indices
        p_rows = probs.reshape(flat.shape)[rows]
        tied = p_rows == kth_flat[rows]
        rank = torch.cumsum(tied, -1, dtype=torch.int32)
        limit = tied.sum(-1, keepdim=True) - extra[rows, None]
        flat[rows] = (p_rows > kth_flat[rows]) | (tied & (rank <= limit))
    topk_idx = torch.nonzero(flat)[:, 1].reshape(kth.shape[:-1] + (k,))
    topk_probs, order = torch.sort(torch.gather(probs, -1, topk_idx), dim=-1,
                                   descending=True, stable=True)
    topk_idx = torch.gather(topk_idx, -1, order)
    topk_probs = topk_probs / torch.clamp(
        torch.sum(topk_probs, -1, keepdim=True), min=1e-9)
    return topk_idx.to(torch.int32), topk_probs
