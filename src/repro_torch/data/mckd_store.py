"""Multi-crop KD soft labels (Eq. 9), synthetic side only.

PyTorch-port counterpart of `repro.data.mckd_store.synthetic_kd_labels`:
fabricated top-K teacher labels around the true next token, for dry runs
and the smoke run. The JAX package draws the K-1 alternative classes with
`jax.random`; this one draws them from `numpy.random.default_rng(seed)`,
so the values differ while the distribution is the same.
"""
from __future__ import annotations

import numpy as np


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
