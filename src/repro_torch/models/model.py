"""Decoder assembly, serving side: params, the cache pool, chunk steps.

PyTorch counterpart of the decode half of `repro.models.model`. The JAX
package stacks the layers of each pattern position along a leading axis for
`lax.scan` ("groups") plus an unrolled "tail"; this port keeps a plain
per-layer list (`params["layers"][i]`, `cache["layers"][i]`), and
`bridge.params_from_jax` unstacks the JAX tree into it.

Entry points:
  init_serving_params(cfg, qcfg, generator, device) -> int-coded params
  init_cache(cfg, qcfg, batch, cache_len, device)   -> decode cache
  prefill_step(params, cache, batch, cfg, qcfg)      -> (logits, cache)  [C>=1]
  decode_step(params, cache, batch, cfg, qcfg)       -> (logits, cache)
  cache_slot_insert / cache_slot_reset / cache_clone -> slot pool ops

The caches are updated IN PLACE. A step runs every layer against the
cache as it was (each layer attends to its cache before its own append, as
in the JAX package) and commits the layers' appends only after all layers
and the lm head have run, so a step that raises leaves its cache unchanged.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig, BlockDef
from repro_torch.core.policy import QuantConfig, act_spec, weight_spec
from repro_torch.core.quantizer import init_scale
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (NAME2KIND, _convert_linear,
                                       activation, apply_norm, embed_lookup,
                                       lm_head_apply, qlinear)


def _cdtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_served(cfg: ArchConfig) -> None:
    for bd in cfg.pattern:
        if bd.attn not in ("global", "local") or bd.ffn != "dense" or bd.cross_attn:
            raise NotImplementedError(
                f"{cfg.name}: the port serves dense attention-only blocks "
                f"(got attn={bd.attn!r}, ffn={bd.ffn!r}, cross={bd.cross_attn})")
    if cfg.frontend != "none" or cfg.pos not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.name}: frontend/learned positions "
                                  "are not in the serving slice")


def params_device(params: dict) -> torch.device:
    emb = params["embed"]
    return next(iter(emb.values())).device


# ===========================================================================
# Serving params, built layer by layer on the device
# ===========================================================================

def _serving_linear_init(gen, name: str, qcfg: QuantConfig, shape, *, std: float,
                         group_axes=(), device) -> dict:
    """One linear as the JAX package's convert_to_serving(linear_init(...))
    would store it: the latent f32 weight lives only inside this call."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device) * std
    wspec = weight_spec(qcfg, NAME2KIND[name])
    if wspec is None:
        return {"w": w.to(torch.bfloat16)}
    ga = group_axes if wspec.granularity != "per_tensor" else ()
    p = {"w": w, "w_scale": init_scale(w, wspec, ga)}
    return _convert_linear(name, p, qcfg)


def _norm_init(d: int, kind: str, device) -> dict:
    p = {"g": torch.ones((d,), dtype=torch.bfloat16, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros((d,), dtype=torch.bfloat16, device=device)
    return p


def _layer_init(gen, cfg: ArchConfig, qcfg: QuantConfig, device) -> dict:
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim_, cfg.d_ff)
    lin = lambda name, shape, std, ga=(): _serving_linear_init(
        gen, name, qcfg, shape, std=std, group_axes=ga, device=device)
    p = {"ln1": _norm_init(d, cfg.norm, device),
         "wq": lin("wq", (d, h, hd), d ** -0.5, (1,)),
         "wk": lin("wk", (d, hkv, hd), d ** -0.5, (1,)),
         "wv": lin("wv", (d, hkv, hd), d ** -0.5, (1,)),
         "wo": lin("wo", (h, hd, d), (h * hd) ** -0.5, (0,))}
    if cfg.qkv_bias:
        for name, heads in (("wq", h), ("wk", hkv), ("wv", hkv)):
            p[name]["b"] = torch.zeros((heads, hd), dtype=torch.bfloat16,
                                       device=device)
    if cfg.sandwich_norm:
        p["ln1_post"] = _norm_init(d, cfg.norm, device)
    p["ln2"] = _norm_init(d, cfg.norm, device)
    p["w_in"] = lin("w_in", (d, f), d ** -0.5)
    p["w_out"] = lin("w_out", (f, d), f ** -0.5)
    if cfg.ffn_gated:
        p["w_gate"] = lin("w_gate", (d, f), d ** -0.5)
    if cfg.sandwich_norm:
        p["ln2_post"] = _norm_init(d, cfg.norm, device)
    return p


def init_serving_params(cfg: ArchConfig, qcfg: QuantConfig,
                        generator: torch.Generator, device=None) -> dict:
    """Random serving params, built directly in int-coded form.

    Same distributions as `convert_to_serving(init_params(key, cfg, qcfg),
    qcfg)` in the JAX package (normal weights with the same stds, LSQ scale
    init, the same code layout), different values: the generator is
    torch's. Each layer's latent f32 weights exist only while that layer is
    converted, so a full-width model never holds all of them at once.
    `generator` must live on `device`.
    """
    cfg.validate()
    _check_served(cfg)
    device = resolve_device(device)
    v, d = cfg.padded_vocab, cfg.d_model
    params = {"embed": _serving_linear_init(generator, "embed", qcfg, (v, d),
                                            std=0.02, device=device),
              "final_norm": _norm_init(d, cfg.norm, device)}
    if cfg.tie_embeddings:
        params["lm_head"] = _tied_head_act_init(qcfg, device)
    else:
        params["lm_head"] = _serving_linear_init(generator, "lm_head", qcfg,
                                                 (d, v), std=d ** -0.5,
                                                 device=device)
    params["layers"] = [_layer_init(generator, cfg, qcfg, device)
                        for _ in range(cfg.n_layers)]
    return params


def _tied_head_act_init(qcfg: QuantConfig, device) -> dict:
    """Activation quantizer params of a tied lm_head, as the JAX package's
    conversion leaves them (bf16; the tied head applies them)."""
    p = {}
    aspec = act_spec(qcfg, "lm_head")
    if aspec is not None:
        p["a_scale"] = torch.ones((), dtype=torch.bfloat16, device=device)
        if aspec.offset:
            p["a_offset"] = torch.zeros((), dtype=torch.bfloat16, device=device)
    return p


# ===========================================================================
# Cache pool
# ===========================================================================

def init_cache(cfg: ArchConfig, qcfg: QuantConfig, batch: int, cache_len: int,
               device=None) -> dict:
    """Fresh decode cache (pre-prefill): one KV cache per layer; local
    (ring) layers hold min(window, cache_len) rows."""
    _check_served(cfg)
    device = resolve_device(device)
    cdtype = _cdtype(cfg)
    layers = []
    for i in range(cfg.n_layers):
        bd = cfg.block_at(i)
        eff = min(cfg.window, cache_len) if bd.attn == "local" else cache_len
        layers.append({"kv": attn.init_kv_cache(qcfg, batch, eff, cfg.n_kv_heads,
                                                cfg.head_dim_, cdtype, device)})
    return {"layers": layers}


def _map_cache(fn, *caches) -> dict:
    """Apply fn to matching tensors of caches with one layout (None stays)."""
    out = []
    for layers in zip(*(c["layers"] for c in caches)):
        kvs = [lay["kv"] for lay in layers]
        out.append({"kv": attn.KVCache(*(
            None if parts[0] is None else fn(*parts) for parts in zip(*kvs)))})
    return {"layers": out}


def cache_clone(cache: dict) -> dict:
    return _map_cache(torch.clone, cache)


def cache_slot_insert(pool: dict, row: dict, slot: int) -> dict:
    """Copy batch row 0 of `row` (a batch-1 cache) into batch row `slot` of
    `pool`, in place; returns `pool`."""
    def ins(p, s):
        p[slot].copy_(s[0])
        return p
    _map_cache(ins, pool, row)
    return pool


def cache_slot_reset(pool: dict, template: dict, slot: int) -> dict:
    """Recycle one slot: restore its rows from a pristine batch-1 cache
    (pos back to -1 — attention masks them; stale codes stay, masked)."""
    return cache_slot_insert(pool, template, slot)


# ===========================================================================
# Decode
# ===========================================================================

def _ffn_sublayer(p, x, cfg: ArchConfig, qcfg: QuantConfig, cdtype):
    xn = apply_norm(p["ln2"], x, cfg.norm)
    if cfg.ffn_gated:
        g = qlinear(p["w_gate"], xn, "w_gate", qcfg, "bsd,df->bsf", cdtype)
        u = qlinear(p["w_in"], xn, "w_in", qcfg, "bsd,df->bsf", cdtype)
        h = activation(g, cfg.act) * u
    else:
        u = qlinear(p["w_in"], xn, "w_in", qcfg, "bsd,df->bsf", cdtype)
        h = activation(u, cfg.act)
    out = qlinear(p["w_out"], h, "w_out", qcfg, "bsf,fd->bsd", cdtype)
    if cfg.sandwich_norm:
        out = apply_norm(p["ln2_post"], out, cfg.norm)
    return x + out


def block_decode(p: dict, x: torch.Tensor, bd: BlockDef, cfg: ArchConfig,
                 qcfg: QuantConfig, cache: dict, pos: torch.Tensor, cdtype):
    """Chunk step against one layer's cache. x: (B,C,d); pos: (B,C).

    Returns (x, (k, v)): the chunk's roped K/V, for the caller to append
    once the whole step has run. pos entries of -1 mark padding (partial
    prefill chunks / idle serving slots): their K/V never reach the cache
    and they attend to nothing.
    """
    xn = apply_norm(p["ln1"], x, cfg.norm)
    q = qlinear(p["wq"], xn, "wq", qcfg, "bsd,dhk->bshk", cdtype)
    k = qlinear(p["wk"], xn, "wk", qcfg, "bsd,dhk->bshk", cdtype)
    v = qlinear(p["wv"], xn, "wv", qcfg, "bsd,dhk->bshk", cdtype)
    if cfg.pos == "rope":
        q = attn.rope_apply(q, pos, cfg.rope_theta)
        k = attn.rope_apply(k, pos, cfg.rope_theta)
    o = attn.attend_chunk(q, k, v, cache["kv"], qcfg, q_per_kv=cfg.q_per_kv,
                          pos=pos, window=cfg.window if bd.attn == "local" else 0,
                          softcap=cfg.attn_softcap)
    out = qlinear(p["wo"], o, "wo", qcfg, "bshk,hkd->bsd", cdtype)
    if cfg.sandwich_norm:
        out = apply_norm(p["ln1_post"], out, cfg.norm)
    x = x + out
    x = _ffn_sublayer(p, x, cfg, qcfg, cdtype)
    return x, (k, v)


@torch.no_grad()
def prefill_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                 qcfg: QuantConfig):
    """Multi-token step against the cache (chunked prefill / decode).

    batch: tokens (B,C) int, pos (B,C) int (-1 = padding). Returns
    (logits (B,C,V) f32, cache) with the chunk appended to `cache` in place.
    C=1 is the classic decode step; C=prompt_len against a fresh cache is a
    full prefill whose [:, -1] logits seed generation.
    """
    cdtype = _cdtype(cfg)
    tokens, pos = batch["tokens"], batch["pos"]
    x = embed_lookup(params["embed"], tokens, qcfg, cdtype)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdtype, device=x.device)
    appends = []
    for i, p in enumerate(params["layers"]):
        x, kv = block_decode(p, x, cfg.block_at(i), cfg, qcfg,
                             cache["layers"][i], pos, cdtype)
        appends.append(kv)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_head_apply(
        params["lm_head"], x, qcfg, cfg.vocab_size, cfg.padded_vocab,
        final_softcap=cfg.final_softcap,
        tied_embed=params["embed"] if cfg.tie_embeddings else None)
    rows = {}  # one index computation per cache shape, not per layer
    for i, (k, v) in enumerate(appends):
        kv = cache["layers"][i]["kv"]
        key = (kv.k.shape[1], cfg.block_at(i).attn == "local")
        if key not in rows:
            rows[key] = attn.append_rows(pos, *key)
        attn.cache_write_rows(kv, k, v, pos, rows[key], qcfg)
    return logits, cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                qcfg: QuantConfig):
    """One new token per sequence: tokens (B,1), pos (B,) or (B,1).
    Returns (logits (B,1,V), cache). Thin C=1 wrapper of prefill_step."""
    b2 = dict(batch)
    if b2["pos"].dim() == 1:
        b2["pos"] = b2["pos"][:, None]
    return prefill_step(params, cache, b2, cfg, qcfg)
