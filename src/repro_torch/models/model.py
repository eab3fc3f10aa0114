"""Decoder assembly: latent QAT params and the training forward, serving
params, the cache pool, chunk steps.

PyTorch counterpart of `repro.models.model` for attention blocks with a
dense or an MoE FFN, for training and serving. The JAX
package stacks the layers of each pattern position along a
leading axis for `lax.scan` ("groups") plus an unrolled "tail"; this port
keeps a plain per-layer list (`params["layers"][i]`, `cache["layers"][i]`),
and `bridge.params_from_jax` unstacks the JAX tree into it.

Entry points:
  init_params(cfg, qcfg, generator, device)         -> latent f32 QAT params
  forward(params, batch, cfg, qcfg, remat=...)      -> (logits, aux)
  quant_leaf_paths / quant_leaves(params, qcfg)     -> quantized weights
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
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, BlockDef
from repro_torch.core.policy import QuantConfig, weight_spec
from repro_torch.core.sdam import sdam as sdam_metric
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (NAME2KIND, activation, apply_norm,
                                       convert_to_serving, embed_init,
                                       embed_lookup, linear_init, lm_head_apply,
                                       lm_head_init, norm_init, qlinear,
                                       tied_head_act_init)


def _cdtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_ported(cfg: ArchConfig) -> None:
    """The families the port trains and serves: attention blocks with a
    dense or an MoE FFN (recurrent, cross and frontend patterns are
    refused)."""
    for bd in cfg.pattern:
        if (bd.attn not in ("global", "local") or bd.ffn not in ("dense", "moe")
                or bd.cross_attn):
            raise NotImplementedError(
                f"{cfg.name}: the port runs attention blocks with a dense or "
                f"MoE FFN (got attn={bd.attn!r}, ffn={bd.ffn!r}, "
                f"cross={bd.cross_attn})")
    if cfg.frontend != "none" or cfg.pos not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.name}: frontend/learned positions "
                                  "are not ported yet")


def params_device(params: dict) -> torch.device:
    emb = params["embed"]
    return next(iter(emb.values())).device


# ===========================================================================
# Latent QAT params, built on the device
# ===========================================================================

def _layer_train_init(gen, cfg: ArchConfig, qcfg: QuantConfig, device,
                      bd: BlockDef) -> dict:
    """One global/local attention block with a dense or MoE FFN, with the
    JAX package's shapes, groups and standard deviations
    (model.py:48-105)."""
    d, h, hkv, hd, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim_, cfg.d_ff)
    lin = lambda name, shape, std, ga=(), bias=None: linear_init(
        gen, name, qcfg, shape, std=std, group_axes=ga, bias_shape=bias,
        device=device)
    bias = cfg.qkv_bias
    p = {"ln1": norm_init(d, cfg.norm, device),
         "wq": lin("wq", (d, h, hd), d ** -0.5, (1,), (h, hd) if bias else None),
         "wk": lin("wk", (d, hkv, hd), d ** -0.5, (1,), (hkv, hd) if bias else None),
         "wv": lin("wv", (d, hkv, hd), d ** -0.5, (1,), (hkv, hd) if bias else None),
         "wo": lin("wo", (h, hd, d), (h * hd) ** -0.5, (0,))}
    if cfg.sandwich_norm:
        p["ln1_post"] = norm_init(d, cfg.norm, device)
    p["ln2"] = norm_init(d, cfg.norm, device)
    if bd.ffn == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg, qcfg, device)
        return p
    p["w_in"] = lin("w_in", (d, f), d ** -0.5)
    p["w_out"] = lin("w_out", (f, d), f ** -0.5)
    if cfg.ffn_gated:
        p["w_gate"] = lin("w_gate", (d, f), d ** -0.5)
    if cfg.sandwich_norm:
        p["ln2_post"] = norm_init(d, cfg.norm, device)
    return p


def init_params(cfg: ArchConfig, qcfg: QuantConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random latent QAT params (f32 weights, LSQ scale inits, activation
    scales 1 and offsets 0, norms 1) on `device`, drawn from `generator`
    (which must live on `device`). Same distributions as the JAX package's
    `init_params`, different values; layer i is params["layers"][i]."""
    cfg.validate()
    _check_ported(cfg)
    device = resolve_device(device)
    v, d = cfg.padded_vocab, cfg.d_model
    params = {"embed": embed_init(generator, qcfg, v, d, device),
              "final_norm": norm_init(d, cfg.norm, device)}
    if cfg.tie_embeddings:
        params["lm_head"] = tied_head_act_init(qcfg, device)
    else:
        params["lm_head"] = lm_head_init(generator, qcfg, d, v, device)
    params["layers"] = [_layer_train_init(generator, cfg, qcfg, device,
                                          cfg.block_at(i))
                        for i in range(cfg.n_layers)]
    return params


# ===========================================================================
# Training forward
# ===========================================================================

def _attn_sublayer(p, x, cfg: ArchConfig, qcfg: QuantConfig, bd: BlockDef,
                   positions, cdtype):
    xn = apply_norm(p["ln1"], x, cfg.norm)
    q = qlinear(p["wq"], xn, "wq", qcfg, "bsd,dhk->bshk", cdtype)
    k = qlinear(p["wk"], xn, "wk", qcfg, "bsd,dhk->bshk", cdtype)
    v = qlinear(p["wv"], xn, "wv", qcfg, "bsd,dhk->bshk", cdtype)
    if cfg.pos == "rope":
        q = attn.rope_apply(q, positions, cfg.rope_theta)
        k = attn.rope_apply(k, positions, cfg.rope_theta)
    window = cfg.window if bd.attn == "local" else 0
    if window and cfg.causal and x.shape[1] > window:
        o = attn.attend_local_chunked(q, k, v, window=window,
                                      softcap=cfg.attn_softcap,
                                      q_per_kv=cfg.q_per_kv)
    else:
        o = attn.attend_full(q, k, v, causal=cfg.causal, window=window,
                             softcap=cfg.attn_softcap, q_positions=positions,
                             k_positions=positions, q_per_kv=cfg.q_per_kv)
    out = qlinear(p["wo"], o, "wo", qcfg, "bshk,hkd->bsd", cdtype)
    if cfg.sandwich_norm:
        out = apply_norm(p["ln1_post"], out, cfg.norm)
    return x + out


def block_apply(p: dict, x: torch.Tensor, bd: BlockDef, cfg: ArchConfig,
                qcfg: QuantConfig, positions: torch.Tensor, cdtype):
    """One training block: (x, sdam, lb_loss, drop_frac) with sdam the
    block output's SDAM (a metric: no gradient flows through it) and the
    MoE FFN's load-balance loss and drop fraction (zeros for a dense FFN)."""
    x = _attn_sublayer(p, x, cfg, qcfg, bd, positions, cdtype)
    if bd.ffn == "moe":
        xn = apply_norm(p["ln2"], x, cfg.norm)
        y, maux = moe_mod.moe_ffn(p["moe"], xn, cfg, qcfg, cdtype)
        x = x + y
        lb, drop = maux["lb_loss"], maux["drop_frac"]
    else:
        x = _ffn_sublayer(p, x, cfg, qcfg, cdtype)
        lb = drop = torch.zeros((), dtype=torch.float32, device=x.device)
    with torch.no_grad():
        sdam = sdam_metric(x)
    return x, sdam, lb, drop


def forward(params: dict, batch: dict, cfg: ArchConfig, qcfg: QuantConfig, *,
            remat: bool = False):
    """Full-sequence forward. batch: tokens (B, S). Returns (logits (B, S,
    padded_vocab) f32, aux) with aux {"lb_loss", "drop_frac"} summed over
    the layers and "act_sdam" their mean, as the reference sums them.

    remat=True recomputes each block in the backward pass
    (torch.utils.checkpoint, non-reentrant), as the JAX package's
    jax.checkpoint does: the block's kernels then run twice.
    """
    _check_ported(cfg)
    cdtype = _cdtype(cfg)
    tokens = batch["tokens"]
    x = embed_lookup(params["embed"], tokens, qcfg, cdtype)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdtype, device=x.device)
    positions = torch.arange(x.shape[1], device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    sdam_sum = lb_sum = drop_sum = zero
    for i, p in enumerate(params["layers"]):
        bd = cfg.block_at(i)
        if remat:
            x, sdam, lb, drop = torch.utils.checkpoint.checkpoint(
                block_apply, p, x, bd, cfg, qcfg, positions, cdtype,
                use_reentrant=False)
        else:
            x, sdam, lb, drop = block_apply(p, x, bd, cfg, qcfg, positions,
                                            cdtype)
        sdam_sum = sdam_sum + sdam
        lb_sum = lb_sum + lb
        drop_sum = drop_sum + drop
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_head_apply(
        params["lm_head"], x, qcfg, cfg.vocab_size, cfg.padded_vocab,
        final_softcap=cfg.final_softcap,
        tied_embed=params["embed"] if cfg.tie_embeddings else None)
    aux = {"lb_loss": lb_sum, "drop_frac": drop_sum,
           "act_sdam": sdam_sum / max(cfg.n_layers, 1)}
    return logits, aux


def quant_leaf_paths(params: dict, qcfg: QuantConfig) -> list:
    """(path, w, w_scale, spec) for every quantized latent weight, with
    path the keys and indices of its sub-dict (("layers", 3, "moe",
    "moe_in"), ("embed",)), walking dict keys in sorted order (the JAX
    pytree order) and layers in order: the order the oscillation state
    zips against."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for name in sorted(node):
                child = node[name]
                if (isinstance(child, dict) and "w" in child
                        and "w_scale" in child and name in NAME2KIND):
                    spec = weight_spec(qcfg, NAME2KIND[name])
                    if spec is not None:
                        out.append((path + (name,), child["w"],
                                    child["w_scale"], spec))
                else:
                    walk(child, path + (name,))
        elif isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, path + (i,))

    walk(params, ())
    return out


def jax_leaf_groups(paths: list, cfg: ArchConfig) -> list:
    """The port's quant leaves (their `quant_leaf_paths` paths) grouped as
    the reference's: it stacks layer i of pattern position p along a
    leading axis under ("groups", p) for the n_groups full pattern periods
    and keeps the rest under ("tail", j), so one of its leaves covers
    n_groups of the port's. Returns [(key, [port leaf index, ...])] in the
    reference's walk order (sorted keys); a "groups" key's members are in
    stack order."""
    n_scan = cfg.n_groups * cfg.period
    groups: dict = {}
    for idx, path in enumerate(paths):
        if path[0] == "layers":
            i = path[1]
            head = (("groups", i % cfg.period) if i < n_scan
                    else ("tail", i - n_scan))
            key = head + tuple(path[2:])
        else:
            key = (path[0], -1) + tuple(path[1:])
        groups.setdefault(key, []).append(idx)
    return [(k, groups[k]) for k in sorted(groups)]


def quant_leaves(params: dict, qcfg: QuantConfig) -> list:
    """(w, w_scale, spec) triples; see quant_leaf_paths."""
    return [(w, s, spec) for _, w, s, spec in quant_leaf_paths(params, qcfg)]


# ===========================================================================
# Serving params, built layer by layer on the device
# ===========================================================================

def init_serving_params(cfg: ArchConfig, qcfg: QuantConfig,
                        generator: torch.Generator, device=None) -> dict:
    """Random serving params: `init_params`' latent tree converted to int
    codes part by part (`convert_to_serving`), the same draws in the same
    order. Same distributions as the JAX package's
    `convert_to_serving(init_params(key, cfg, qcfg), qcfg)`, different
    values (torch's generator). Each layer's latent f32 weights exist only
    while that layer is converted, so a full-width model never holds all of
    them at once. `generator` must live on `device`.
    """
    cfg.validate()
    _check_ported(cfg)
    device = resolve_device(device)
    v, d = cfg.padded_vocab, cfg.d_model
    top = {"embed": embed_init(generator, qcfg, v, d, device),
           "final_norm": norm_init(d, cfg.norm, device),
           "lm_head": (tied_head_act_init(qcfg, device) if cfg.tie_embeddings
                       else lm_head_init(generator, qcfg, d, v, device))}
    params = convert_to_serving(top, qcfg)
    params["layers"] = [
        convert_to_serving(_layer_train_init(generator, cfg, qcfg, device,
                                             cfg.block_at(i)), qcfg)
        for i in range(cfg.n_layers)]
    return params


# ===========================================================================
# Cache pool
# ===========================================================================

def init_cache(cfg: ArchConfig, qcfg: QuantConfig, batch: int, cache_len: int,
               device=None) -> dict:
    """Fresh decode cache (pre-prefill): one KV cache per layer; local
    (ring) layers hold min(window, cache_len) rows."""
    _check_ported(cfg)
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
    if bd.ffn == "moe":  # the aux losses are training metrics: dropped
        y, _ = moe_mod.moe_ffn(p["moe"], apply_norm(p["ln2"], x, cfg.norm),
                               cfg, qcfg, cdtype)
        return x + y, (k, v)
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
