"""Knowledge distillation losses (Eq. 8-9).

PyTorch counterpart of `repro.core.kd`. Vanilla KD (Eq. 8) is the soft
cross-entropy between the teacher's distribution and the quantized
student's; multi-crop KD (Eq. 9) streams pre-computed sparse top-K teacher
labels (probs renormalized over the K support), so no teacher runs during
training (`mckd_loss` averages over the stored views). Every loss is
computed in f32 and averaged over tokens (or over
the tokens a mask keeps).
"""
from __future__ import annotations

from typing import Optional

import torch


def _reduce(per_tok: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return torch.mean(per_tok)
    mask = mask.to(per_tok.dtype)
    return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)


def soft_ce(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 8: -(1/N) sum_c p_c^T log p_c^S. Logits (..., C), probs (..., C)."""
    logp = torch.log_softmax(student_logits.to(torch.float32), dim=-1)
    per_tok = -torch.sum(teacher_probs.to(torch.float32) * logp, dim=-1)
    return _reduce(per_tok, mask)


def kd_from_teacher_logits(student_logits: torch.Tensor,
                           teacher_logits: torch.Tensor,
                           temperature: float = 1.0,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Vanilla KD with an on-the-fly teacher forward (no teacher gradient)."""
    t = temperature
    probs = torch.softmax(teacher_logits.detach().to(torch.float32) / t, dim=-1)
    return soft_ce(student_logits / t, probs, mask) * (t * t)


def sparse_soft_ce(student_logits: torch.Tensor, topk_idx: torch.Tensor,
                   topk_probs: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MCKD with sparse top-K stored labels: logits (..., C), topk_idx
    (..., K) class indices, topk_probs (..., K) teacher probabilities."""
    logp = torch.log_softmax(student_logits.to(torch.float32), dim=-1)
    gathered = torch.gather(logp, -1, topk_idx.to(torch.int64))
    per_tok = -torch.sum(topk_probs.to(torch.float32) * gathered, dim=-1)
    return _reduce(per_tok, mask)


def hard_ce(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain next-token cross-entropy."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    return -_reduce(ll, mask)


def mckd_loss(student_logits_crops: torch.Tensor, topk_idx: torch.Tensor,
              topk_probs: torch.Tensor) -> torch.Tensor:
    """Eq. 9: the sparse soft-CE averaged over the M stored views.
    student_logits_crops (M, ..., C); topk_idx / topk_probs (M, ..., K)."""
    losses = [sparse_soft_ce(s, i, p)
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
