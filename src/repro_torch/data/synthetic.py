"""Deterministic synthetic LM data pipeline (numpy outputs).

Copy of `repro.data.synthetic.sample_batch`: sequences follow a learnable
affine-successor process with noise,
  t_{i+1} = (a * t_i + c) mod V     with prob 1-p_noise
          = uniform(V)              with prob p_noise,
keyed on (seed, step, host_index). The numpy generator is the same, so the
batches equal the JAX package's bit for bit; they stay numpy here (the JAX
version wraps them in jnp arrays).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    mult: int = 31
    add: int = 17
    p_noise: float = 0.1


def sample_batch(cfg: ArchConfig, dcfg: DataConfig, step: int, batch: int,
                 seq: int, host_index: int = 0) -> dict:
    """Host-side numpy generation (cheap, deterministic)."""
    v = cfg.vocab_size
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed, step, host_index]))
    toks = np.empty((batch, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, v, size=batch)
    noise = rng.random((batch, seq)) < dcfg.p_noise
    rand = rng.integers(0, v, size=(batch, seq))
    for i in range(seq):
        nxt = (dcfg.mult * toks[:, i] + dcfg.add) % v
        toks[:, i + 1] = np.where(noise[:, i], rand[:, i], nxt)
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if cfg.frontend == "vision_patches":
        fe = rng.standard_normal((batch, cfg.n_frontend_tokens, cfg.d_model)) * 0.02
        out["frontend_embeds"] = fe.astype(np.float32)
    elif cfg.frontend == "audio_frames":
        fe = rng.standard_normal((batch, seq, cfg.d_model)) * 0.02
        out["frontend_embeds"] = fe.astype(np.float32)
    return out
