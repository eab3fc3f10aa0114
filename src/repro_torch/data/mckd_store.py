"""Multi-crop KD soft-label store (Eq. 9, Sec. 4.4.2).

PyTorch-port counterpart of `repro.data.mckd_store`. Offline, the
full-precision teacher runs over M views of each sample, and the store keeps
its sparse top-K labels (indices and renormalized probabilities) beside
each view. Training then streams (view, kd_idx, kd_p) with no teacher in
the loop, which is where the paper's training-time saving comes from
(Tab. 5). For language models a "crop" is a window into a longer token
stream (`window_crop`), and K sparse labels replace dense vocabulary rows.

Shards are `.npz` files of numpy arrays, the reference's layout (item i's
arrays under "i/<key>", with "i/kd_idx" and "i/kd_p"), beside a
`manifest.json`; `iter_shard` yields numpy dicts, like `sample_batch`, for
the caller to move to its device.

`synthetic_kd_labels` fabricates top-K labels around the true next token
for dry runs and the smoke run. The JAX package draws the K-1 alternative
classes with `jax.random`; this one draws them from
`numpy.random.default_rng(seed)`, so the values differ while the
distribution is the same.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.core.kd import make_topk_labels


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MCKDStore:
    def __init__(self, root: str, k: int = 16, n_crops: int = 4):
        self.root = root
        self.k = k
        self.n_crops = n_crops
        os.makedirs(root, exist_ok=True)

    def _path(self, shard: int) -> str:
        return os.path.join(self.root, f"mckd_{shard:05d}.npz")

    def build_shard(self, shard: int, teacher_apply, batches: list,
                    crop_fn) -> None:
        """Offline label extraction for one shard: for each batch and each
        m < n_crops, view = crop_fn(batch, m), logits = teacher_apply(view)
        (B, S, V), and the view stored with make_topk_labels(logits, k).
        The shard is written to a temporary name and renamed into place."""
        arrays = {}
        n = 0
        for batch in batches:
            for m in range(self.n_crops):
                view = crop_fn(batch, m)
                with torch.no_grad():
                    ki, kp = make_topk_labels(teacher_apply(view), self.k)
                for key, val in view.items():
                    arrays[f"{n}/{key}"] = _numpy(val)
                arrays[f"{n}/kd_idx"] = _numpy(ki)
                arrays[f"{n}/kd_p"] = _numpy(kp)
                n += 1
        tmp = os.path.join(self.root, f".mckd_{shard:05d}.tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path(shard))
        with open(os.path.join(self.root, "manifest.json"), "w") as f:
            json.dump({"k": self.k, "n_crops": self.n_crops,
                       "shards": shard + 1, "n": n}, f)

    def iter_shard(self, shard: int):
        """The shard's items in the order they were built, each a dict of
        numpy arrays (the view's keys, "kd_idx", "kd_p")."""
        with np.load(self._path(shard)) as data:
            files = list(data.files)
            n = max(int(key.split("/")[0]) for key in files) + 1
            items = [{k.split("/", 1)[1]: data[k] for k in files
                      if k.startswith(f"{i}/")} for i in range(n)]
        yield from items


def window_crop(batch: dict, m: int, crop_len: int) -> dict:
    """The language-model multi-crop: the m-th window into the token
    stream (tokens, labels, and audio frames that run along it; other
    frontend embeddings are kept whole)."""
    s = batch["tokens"].shape[1]
    start = (m * max(1, (s - crop_len))) // 4
    start = min(start, s - crop_len)
    out = {"tokens": batch["tokens"][:, start:start + crop_len],
           "labels": batch["labels"][:, start:start + crop_len]}
    for k in ("frontend_embeds",):
        if k in batch and batch[k].shape[1] == s:
            out[k] = batch[k][:, start:start + crop_len]
        elif k in batch:
            out[k] = batch[k]
    return out


def synthetic_kd_labels(labels: np.ndarray, vocab: int, k: int,
                        smooth: float = 0.1, seed: int = 0):
    """(idx (..., k) int32, p (..., k) f32): the true label with probability
    1 - smooth, then k - 1 uniform classes sharing `smooth`."""
    labels = np.asarray(labels)
    rng = np.random.default_rng(seed)
    alt = rng.integers(0, vocab, size=(*labels.shape, k - 1))
    idx = np.concatenate([labels[..., None], alt], axis=-1).astype(np.int32)
    p = np.concatenate([np.full((*labels.shape, 1), 1.0 - smooth),
                        np.full((*labels.shape, k - 1), smooth / (k - 1))],
                       axis=-1)
    return idx, p.astype(np.float32)
