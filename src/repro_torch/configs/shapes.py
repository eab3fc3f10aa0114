"""Assigned input shapes and their meta-tensor input specs.

PyTorch counterpart of `repro.configs.shapes`. Shapes (LM family,
seq_len x global_batch):
  train_4k     4,096 x 256    training            -> train_step
  prefill_32k  32,768 x 32    inference prefill   -> prefill_step
  decode_32k   32,768 x 128   inference decode    -> decode_step (1 new token,
                                                     KV/state cache of seq_len)
  long_500k    524,288 x 1    long-context decode -> decode_step; only for
                              sub-quadratic archs

`token_specs` / `decode_token_specs` return tensors on the meta device with
the reference's shapes and dtypes (int32 tokens, bf16 frontend embeddings):
shapes only, no memory, as `jax.ShapeDtypeStruct`s are for `jit(...).lower()`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Smoke-scale variants of the same four shapes (used by tests).
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 32, 4, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 4, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}


def get_shape(name: str, smoke: bool = False) -> ShapeSpec:
    table = SMOKE_SHAPES if smoke else SHAPES
    if name not in table:
        raise KeyError(f"unknown shape {name!r}; have {sorted(table)}")
    return table[name]


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: every layer would hold an "
                       "unbounded 512k KV cache; skipped per DESIGN.md Sec. 5")
    return True, ""


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_specs(cfg: ArchConfig, shape: ShapeSpec, kd_topk: int = 0) -> dict:
    """Training/prefill token + label specs (+ MCKD sparse soft labels)."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    if kd_topk > 0:
        specs["kd_idx"] = _meta((b, s, kd_topk), torch.int32)
        specs["kd_p"] = _meta((b, s, kd_topk), torch.float32)
    if cfg.frontend == "vision_patches":
        specs["frontend_embeds"] = _meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                         torch.bfloat16)
    elif cfg.frontend == "audio_frames":
        specs["frontend_embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
    return specs


def decode_token_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """decode_step inputs: one new token against a cache of shape.seq_len."""
    b = shape.global_batch
    specs = {"tokens": _meta((b, 1), torch.int32),
             "pos": _meta((b,), torch.int32)}
    if cfg.frontend == "vision_patches":
        # Cross-attn KV come precomputed with the request (stub frontend).
        specs["frontend_embeds"] = _meta((b, cfg.n_frontend_tokens, cfg.d_model),
                                         torch.bfloat16)
    elif cfg.frontend == "audio_frames":
        specs["frontend_embeds"] = _meta((b, 1, cfg.d_model), torch.bfloat16)
    return specs
