"""Decoder assembly: latent QAT params and the training forward, serving
params, the cache pool, chunk steps.

PyTorch counterpart of `repro.models.model` for every block of the
registry: attention (global / local) with a dense or an MoE FFN, the
recurrent mLSTM, sLSTM and RG-LRU blocks (`models.recurrent`), and the
cross-attention sublayer over vision-patch embeddings; rope or learned
positions and the audio / vision-patch frontends, for training and
serving. The JAX
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
in the JAX package) and commits the layers' appends and their new
recurrent states only after all layers and the lm head have run, so a step
that raises leaves its cache unchanged. A layer's cache is a dict: "kv"
(a KVCache) for attention, "mlstm" (C, n, m, conv), "slstm" (c, n, h, m)
or "rglru" (h, conv) for a recurrent block, plus "xkv" (the cross
attention's K, V) for a cross layer. As in the reference, no step writes
"xkv": served cross layers attend to the zero K/V `init_cache` made.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig, BlockDef
from repro_torch.core.policy import QuantConfig, weight_spec
from repro_torch.core.sdam import sdam as sdam_metric
from repro_torch.dist.spmd import WHOLE, Spmd, TPSplit, counted_as
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import recurrent as rec
from repro_torch.models.common import (NAME2KIND, activation, apply_norm,
                                       convert_to_serving, embed_init,
                                       embed_lookup, linear_init, lm_head_apply,
                                       lm_head_init, norm_init, qlinear,
                                       tied_head_act_init)


def _cdtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def params_device(params: dict) -> torch.device:
    emb = params["embed"]
    return next(iter(emb.values())).device


# ===========================================================================
# Latent QAT params, built on the device
# ===========================================================================

def _attn_init(gen, cfg: ArchConfig, qcfg: QuantConfig, device,
               cross: bool) -> dict:
    """Self-attention's wq / wk / wv / wo, or cross-attention's xq / xk /
    xv / xo (no bias) with its f32 gate xgate (0: tanh(0) shuts the
    sublayer at init) and norm ln_x (model.py:48-67)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    pre = "x" if cross else "w"
    bias = cfg.qkv_bias and not cross
    lin = lambda name, shape, std, ga, b=None: linear_init(
        gen, pre + name, qcfg, shape, std=std, group_axes=ga, bias_shape=b,
        device=device)
    p = {pre + "q": lin("q", (d, h, hd), d ** -0.5, (1,), (h, hd) if bias else None),
         pre + "k": lin("k", (d, hkv, hd), d ** -0.5, (1,), (hkv, hd) if bias else None),
         pre + "v": lin("v", (d, hkv, hd), d ** -0.5, (1,), (hkv, hd) if bias else None),
         pre + "o": lin("o", (h, hd, d), (h * hd) ** -0.5, (0,))}
    if cross:
        p["xgate"] = torch.zeros((), dtype=torch.float32, device=device)
        p["ln_x"] = norm_init(d, cfg.norm, device)
    return p


def _layer_train_init(gen, cfg: ArchConfig, qcfg: QuantConfig, device,
                      bd: BlockDef) -> dict:
    """One block with the JAX package's layout, shapes, groups and
    standard deviations (`block_init`, model.py:79-102): an mLSTM or sLSTM
    block is its flat dict (its own FFN, if any, inside); an RG-LRU block
    is {"rg": ..., "ln1": ...} (ln1 is read by nothing, as in the
    reference) plus its FFN; an attention block ln1 + wq / wk / wv / wo;
    then the cross-attention leaves and the dense or MoE FFN."""
    d, f = cfg.d_model, cfg.d_ff
    lin = lambda name, shape, std: linear_init(gen, name, qcfg, shape, std=std,
                                               device=device)
    if bd.attn == "mlstm":
        p = rec.mlstm_init(gen, cfg, qcfg, device)
    elif bd.attn == "slstm":
        p = rec.slstm_init(gen, cfg, qcfg, device)
    elif bd.attn == "rglru":
        p = {"rg": rec.rglru_init(gen, cfg, qcfg, device),
             "ln1": norm_init(d, cfg.norm, device)}
    else:
        p = {"ln1": norm_init(d, cfg.norm, device)}
        p.update(_attn_init(gen, cfg, qcfg, device, cross=False))
        if cfg.sandwich_norm:
            p["ln1_post"] = norm_init(d, cfg.norm, device)
    if bd.cross_attn:
        p.update(_attn_init(gen, cfg, qcfg, device, cross=True))
    if bd.ffn == "moe":
        p["ln2"] = norm_init(d, cfg.norm, device)
        p["moe"] = moe_mod.moe_init(gen, cfg, qcfg, device)
    elif bd.ffn == "dense":
        p["ln2"] = norm_init(d, cfg.norm, device)
        p["w_in"] = lin("w_in", (d, f), d ** -0.5)
        p["w_out"] = lin("w_out", (f, d), f ** -0.5)
        if cfg.ffn_gated:
            p["w_gate"] = lin("w_gate", (d, f), d ** -0.5)
        if cfg.sandwich_norm:
            p["ln2_post"] = norm_init(d, cfg.norm, device)
    return p


def pos_embed_init(gen: torch.Generator, cfg: ArchConfig, device=None
                   ) -> torch.Tensor:
    """The learned position table: f32 (max_seq, d_model), 0.02 N(0, 1)."""
    return torch.randn((cfg.max_seq, cfg.d_model), generator=gen,
                       dtype=torch.float32, device=device) * 0.02


def init_params(cfg: ArchConfig, qcfg: QuantConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random latent QAT params (f32 weights, LSQ scale inits, activation
    scales 1 and offsets 0, norms 1) on `device`, drawn from `generator`
    (which must live on `device`). Same distributions as the JAX package's
    `init_params`, different values; layer i is params["layers"][i]."""
    cfg.validate()
    device = resolve_device(device)
    v, d = cfg.padded_vocab, cfg.d_model
    params = {"embed": embed_init(generator, qcfg, v, d, device),
              "final_norm": norm_init(d, cfg.norm, device)}
    if cfg.pos == "learned":
        params["pos_embed"] = pos_embed_init(generator, cfg, device)
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
                   positions, cdtype, tp=None):
    """x + wo(attend(q, k, v)). tp: tensor-parallel on heads, each rank
    attending over its own contiguous q heads and the kv heads they read
    (both counts divide the model ranks), its wo row-parallel."""
    xn = apply_norm(p["ln1"], x, cfg.norm)
    q = qlinear(p["wq"], xn, "wq", qcfg, "bsd,dhk->bshk", cdtype, tp)
    k = qlinear(p["wk"], xn, "wk", qcfg, "bsd,dhk->bshk", cdtype, tp)
    v = qlinear(p["wv"], xn, "wv", qcfg, "bsd,dhk->bshk", cdtype, tp)
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
    out = qlinear(p["wo"], o, "wo", qcfg, "bshk,hkd->bsd", cdtype, tp)
    if cfg.sandwich_norm:
        out = apply_norm(p["ln1_post"], out, cfg.norm)
    return x + out


def _cross_sublayer(p, x, kv, cfg: ArchConfig, qcfg: QuantConfig, cdtype,
                    tp=None):
    """x + tanh(xgate) * xo(attend(xq(ln_x(x)), K, V)), non-causal over the
    frontend's K / V (model.py:169-178). tp: tensor-parallel on heads (K /
    V `cross_kv` of the same split), xo row-parallel; the replicated xgate
    and ln_x act on whole tensors."""
    xn = apply_norm(p["ln_x"], x, cfg.norm)
    q = qlinear(p["xq"], xn, "xq", qcfg, "bsd,dhk->bshk", cdtype, tp)
    k, v = kv
    o = attn.attend_full(q, k, v, causal=False, window=0, softcap=0.0,
                         q_positions=torch.arange(x.shape[1], device=x.device),
                         k_positions=torch.arange(k.shape[1], device=x.device),
                         q_per_kv=cfg.q_per_kv)
    out = qlinear(p["xo"], o, "xo", qcfg, "bshk,hkd->bsd", cdtype, tp)
    return x + torch.tanh(p["xgate"]).to(cdtype) * out


def cross_kv(p, embeds, cfg: ArchConfig, qcfg: QuantConfig, cdtype, tp=None):
    """The cross-attention K / V of the frontend embeddings (B, P, d); tp:
    this rank's kv heads."""
    k = qlinear(p["xk"], embeds, "xk", qcfg, "bsd,dhk->bshk", cdtype, tp)
    v = qlinear(p["xv"], embeds, "xv", qcfg, "bsd,dhk->bshk", cdtype, tp)
    return k, v


def block_apply(p: dict, x: torch.Tensor, bd: BlockDef, cfg: ArchConfig,
                qcfg: QuantConfig, positions: torch.Tensor, cross_embeds,
                cdtype, tp_attn=None, tp_ffn=None, tp_cross=None, dp=None):
    """One training block: (x, sdam, lb_loss, drop_frac) with sdam the
    block output's SDAM (a metric: no gradient flows through it) and the
    MoE FFN's load-balance loss and drop fraction (zeros otherwise).
    cross_embeds: the vision patches (B, P, d) a cross layer attends to.
    tp_attn / tp_ffn / tp_cross: the block's mixer (attention, mLSTM or
    RG-LRU) / its FFN (dense, MoE or the sLSTM's) / its cross-attention run
    tensor-parallel on this rank's slices (`layer_tp`); the collectives a
    recurrent block or a cross sublayer launches are counted under the use
    "recurrent" / "cross" (`dist.spmd.moved_bytes_by_use`). dp: the
    batch's rows split over data ranks (`dist.spmd.Spmd.dp`): the MoE FFN
    routes the global batch."""
    if bd.attn in RECURRENT:
        block = {"mlstm": rec.mlstm_block, "slstm": rec.slstm_block,
                 "rglru": rec.rglru_block}[bd.attn]
        with counted_as("recurrent"):
            x, _ = block(p["rg"] if bd.attn == "rglru" else p, x, cfg, qcfg, cdtype,
                         tp=tp_ffn if bd.attn == "slstm" else tp_attn)
    else:
        x = _attn_sublayer(p, x, cfg, qcfg, bd, positions, cdtype, tp_attn)
    if bd.cross_attn:
        with counted_as("cross"):
            kv = cross_kv(p, cross_embeds, cfg, qcfg, cdtype, tp_cross)
            x = _cross_sublayer(p, x, kv, cfg, qcfg, cdtype, tp_cross)
    lb = drop = torch.zeros((), dtype=torch.float32, device=x.device)
    if bd.ffn == "moe":
        xn = apply_norm(p["ln2"], x, cfg.norm)
        y, maux = moe_mod.moe_ffn(p["moe"], xn, cfg, qcfg, cdtype, tp_ffn, dp)
        x = x + y
        lb, drop = maux["lb_loss"], maux["drop_frac"]
    elif bd.ffn == "dense":
        x = _ffn_sublayer(p, x, cfg, qcfg, cdtype, tp_ffn)
    with torch.no_grad():
        sdam = sdam_metric(x)
    return x, sdam, lb, drop


def _token_inputs(params, tokens, fe, cfg: ArchConfig, qcfg: QuantConfig,
                  cdtype, tp=None) -> torch.Tensor:
    """The sqrt(d)-scaled token embeddings (tp: vocab-parallel), plus the
    audio frames (B, S, d) where the config has that frontend and the
    batch carries them."""
    x = embed_lookup(params["embed"], tokens, qcfg, cdtype, tp)
    x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdtype, device=x.device)
    if cfg.frontend == "audio_frames" and fe is not None:
        x = x + fe.to(cdtype)
    return x


ATTN_LINEARS = ("wq", "wk", "wv", "wo")
MLSTM_LINEARS = ("m_up_gate", "m_up", "mq", "mk", "mv", "m_i", "m_f", "m_down")
RGLRU_LINEARS = ("g_gate", "g_in", "g_a", "g_x", "g_out")
# the sLSTM's own FFN is always gated (`recurrent.slstm_init`)
SLSTM_FFN = ("w_gate", "w_in", "w_out")
CROSS_LINEARS = ("xq", "xk", "xv", "xo")


class LayerTP(NamedTuple):
    """A layer's tensor-parallel sublayers (`layer_tp`): this rank's
    `dist.spmd.TPSplit` for its mixer (attention, mLSTM or RG-LRU), its FFN
    (dense, MoE or the sLSTM's) and its cross-attention, each None where it
    runs whole, and the linears that keep their model slices
    (`Spmd.gather`'s split)."""
    attn: Optional[TPSplit]
    ffn: Optional[TPSplit]
    cross: Optional[TPSplit]
    split: tuple


def layer_tp(spmd: Spmd, cfg: ArchConfig, i: int, training: bool = True
             ) -> LayerTP:
    """Layer i's sublayers that run tensor-parallel: those the block has
    and whose linears the rules all split over the model axis. A block's
    attention (on heads), its dense FFN (on d_ff) and its MoE FFN's experts
    (on their expert axis where it divides, `TPSplit.experts`, else on
    d_ff; the router stays whole); in training (`training`) also the mLSTM
    (on heads), the RG-LRU (on channels; its linears under "rg"), the
    sLSTM's FFN (on d_ff: its cell runs whole) and cross-attention (on
    heads). Serving (`prefill_step`) runs those four whole: its recurrent
    states and cross K / V are held whole on every model rank."""
    bd = cfg.block_at(i)
    here = ("layers", i)
    ta, mixer = None, ()
    if bd.attn in ("global", "local"):
        ta, mixer = spmd.tp(here, ATTN_LINEARS), ATTN_LINEARS
    elif training and bd.attn == "mlstm":
        ta, mixer = spmd.tp(here, MLSTM_LINEARS), MLSTM_LINEARS
    elif training and bd.attn == "rglru":
        ta = spmd.tp(here + ("rg",), RGLRU_LINEARS)
        mixer = tuple(("rg", n) for n in RGLRU_LINEARS)
    tf, ffn = None, ()
    if bd.ffn == "dense":
        ffn = ("w_in", "w_gate", "w_out") if cfg.ffn_gated else ("w_in", "w_out")
        tf = spmd.tp(here, ffn)
    elif bd.ffn == "moe":
        names = (("moe_in", "moe_gate", "moe_out") if cfg.ffn_gated
                 else ("moe_in", "moe_out"))
        tf = spmd.tp(here + ("moe",), names)
        if tf is not None:
            tf = tf._replace(experts=spmd.experts(here + ("moe", "moe_in")))
        ffn = tuple(("moe", n) for n in names)
    elif training and bd.attn == "slstm":
        ffn = SLSTM_FFN
        tf = spmd.tp(here, ffn)
    tx = spmd.tp(here, CROSS_LINEARS) if training and bd.cross_attn else None
    return LayerTP(ta, tf, tx, (mixer if ta else ()) + (ffn if tf else ())
                   + (CROSS_LINEARS if tx else ()))


def vocab_tp(spmd: Spmd, cfg: ArchConfig) -> tuple:
    """(embedding, head): their vocab-parallel splits, or None; a tied
    head is the embedding's."""
    embed = spmd.tp(("embed",))
    return embed, embed if cfg.tie_embeddings else spmd.tp(("lm_head",))


def _gather_top(params: dict, spmd: Spmd, vocab: tuple) -> dict:
    """The leaves outside the layers, gathered; a vocab-parallel
    embedding or head keeps its model slices."""
    keep = {"embed": vocab[0], "lm_head": vocab[1]}
    return {k: v if k == "layers" else spmd.gather(
                (k,), v, tuple(v) if keep.get(k) is not None else ())
            for k, v in params.items()}


def _gathered_block(spmd: Spmd, i: int, p: dict, x, bd: BlockDef,
                    cfg: ArchConfig, *args):
    """block_apply on layer i's leaves (`spmd.gather`: whole, or over the
    data axes only for its tensor-parallel sublayers), inside the block's
    checkpoint, so a remat backward gathers again."""
    lt = layer_tp(spmd, cfg, i)
    return block_apply(spmd.gather(("layers", i), p, lt.split), x, bd, cfg, *args,
                       tp_attn=lt.attn, tp_ffn=lt.ffn, tp_cross=lt.cross, dp=spmd.dp)


def forward(params: dict, batch: dict, cfg: ArchConfig, qcfg: QuantConfig, *,
            remat: bool = False, spmd: Spmd = WHOLE, whole_logits: bool = True):
    """Full-sequence forward. batch: tokens (B, S) [+ frontend_embeds]:
    audio frames (B, S, d) are added to the scaled token embeddings;
    vision patches (B, P, d) replace them where no block has cross
    attention (an encoder over the patches, whose logits are per patch),
    and are the cross layers' K / V source otherwise (the token
    embeddings stay the input). Learned positions add rows 0..S-1 of
    `pos_embed`. Returns (logits (B, S, padded_vocab) f32, aux) with aux
    {"lb_loss", "drop_frac"} summed over the layers and "act_sdam" their
    mean, as the reference sums them.

    remat=True recomputes each block in the backward pass
    (torch.utils.checkpoint, non-reentrant), as the JAX package's
    jax.checkpoint does: the block's kernels then run twice.

    spmd: the mesh's runtime (`dist.spmd`); where params are one rank's
    slices, the top-level leaves are gathered once and each layer's just
    before it runs; the sublayers that `layer_tp` and `vocab_tp` name run
    tensor-parallel. The logits come out whole on every rank, unless
    `whole_logits` is False and the head is vocab-parallel (`vocab_tp(spmd,
    cfg)[1]`): then they are this rank's columns of the padded vocab, for
    `core.kd`'s losses with that split (the training step).
    """
    cdtype = _cdtype(cfg)
    vocab = vocab_tp(spmd, cfg)
    params = _gather_top(params, spmd, vocab)
    fe = batch.get("frontend_embeds")
    cross_embeds = None
    if (cfg.frontend == "vision_patches"
            and not any(b.cross_attn for b in cfg.pattern)):
        x = fe.to(cdtype)  # an encoder over the patches: no token embedding
    else:
        x = _token_inputs(params, batch["tokens"], fe, cfg, qcfg, cdtype,
                          vocab[0])
        if cfg.frontend == "vision_patches":
            cross_embeds = fe
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    if cfg.pos == "learned":
        x = x + params["pos_embed"][:s].to(cdtype)[None]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    sdam_sum = lb_sum = drop_sum = zero
    for i, p in enumerate(params["layers"]):
        args = (spmd, i, p, x, cfg.block_at(i), cfg, qcfg, positions,
                cross_embeds, cdtype)
        if remat:
            x, sdam, lb, drop = torch.utils.checkpoint.checkpoint(
                _gathered_block, *args, use_reentrant=False)
        else:
            x, sdam, lb, drop = _gathered_block(*args)
        sdam_sum = sdam_sum + sdam
        lb_sum = lb_sum + lb
        drop_sum = drop_sum + drop
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_head_apply(
        params["lm_head"], x, qcfg, cfg.vocab_size, cfg.padded_vocab,
        final_softcap=cfg.final_softcap,
        tied_embed=params["embed"] if cfg.tie_embeddings else None,
        tp=vocab[1], gather=whole_logits)
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
    device = resolve_device(device)
    v, d = cfg.padded_vocab, cfg.d_model
    top = {"embed": embed_init(generator, qcfg, v, d, device),
           "final_norm": norm_init(d, cfg.norm, device)}
    if cfg.pos == "learned":  # drawn where init_params draws it
        top["pos_embed"] = pos_embed_init(generator, cfg, device)
    top["lm_head"] = (tied_head_act_init(qcfg, device) if cfg.tie_embeddings
                      else lm_head_init(generator, qcfg, d, v, device))
    params = convert_to_serving(top, qcfg)
    params["layers"] = [
        convert_to_serving(_layer_train_init(generator, cfg, qcfg, device,
                                             cfg.block_at(i)), qcfg)
        for i in range(cfg.n_layers)]
    return params


# ===========================================================================
# Cache pool
# ===========================================================================

RECURRENT = ("mlstm", "slstm", "rglru")


def _layer_cache_init(cfg: ArchConfig, qcfg: QuantConfig, bd: BlockDef,
                      batch: int, cache_len: int, cdtype, device) -> dict:
    """One layer's fresh cache (model.py:337-359): a KV cache (local ring
    layers hold min(window, cache_len) rows) or a recurrent block's initial
    state, plus zero cross K / V (B, n_frontend_tokens, Hkv, hd) for a
    cross layer."""
    c: dict = {}
    if bd.attn in ("global", "local"):
        eff = min(cfg.window, cache_len) if bd.attn == "local" else cache_len
        c["kv"] = attn.init_kv_cache(qcfg, batch, eff, cfg.n_kv_heads,
                                     cfg.head_dim_, cdtype, device)
    elif bd.attn == "mlstm":
        c["mlstm"] = rec.mlstm_fresh_state(cfg, batch, device)
    elif bd.attn == "slstm":
        c["slstm"] = rec.slstm_state_init(batch, cfg.n_heads,
                                          cfg.d_model // cfg.n_heads, device)
    elif bd.attn == "rglru":
        c["rglru"] = rec.rglru_state_init(batch, cfg.lru_width or cfg.d_model,
                                          cfg.conv_kernel, device)
    if bd.cross_attn:
        shape = (batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.head_dim_)
        c["xkv"] = tuple(torch.zeros(shape, dtype=cdtype, device=device)
                         for _ in range(2))
    return c


def init_cache(cfg: ArchConfig, qcfg: QuantConfig, batch: int, cache_len: int,
               device=None, *, spmd: Spmd = WHOLE, shard_batch: bool = False
               ) -> dict:
    """Fresh decode cache (pre-prefill), one dict per layer
    (`_layer_cache_init`): this rank's slice of it on spmd's mesh, by
    `dist.sharding.cache_pspecs(shard_batch=...)` (the KV sequence axis
    over the model ranks; `Spmd.local_cache`)."""
    device = resolve_device(device)
    cdtype = _cdtype(cfg)
    cache = {"layers": [_layer_cache_init(cfg, qcfg, cfg.block_at(i), batch,
                                          cache_len, cdtype, device)
                        for i in range(cfg.n_layers)]}
    return spmd.local_cache(cache, shard_batch=shard_batch)


def _map_node(fn, nodes):
    first = nodes[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _map_node(fn, [n[k] for n in nodes]) for k in first}
    if isinstance(first, tuple):  # KVCache, or xkv's (k, v)
        parts = [_map_node(fn, list(p)) for p in zip(*nodes)]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return fn(*nodes)


def _map_cache(fn, *caches) -> dict:
    """Apply fn to matching tensors of caches with one layout (None stays)."""
    return {"layers": [_map_node(fn, list(layers))
                       for layers in zip(*(c["layers"] for c in caches))]}


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
    (pos back to -1 — attention masks them; stale codes stay, masked;
    recurrent states back to their initial values, which are not all zero:
    the m stabilizers start at -1e9)."""
    return cache_slot_insert(pool, template, slot)


# ===========================================================================
# Decode
# ===========================================================================

def _ffn_sublayer(p, x, cfg: ArchConfig, qcfg: QuantConfig, cdtype, tp=None):
    """x + w_out(act(w_gate(xn)) * w_in(xn)); tp: tensor-parallel on d_ff
    (w_in / w_gate column-parallel, w_out row-parallel)."""
    xn = apply_norm(p["ln2"], x, cfg.norm)
    if cfg.ffn_gated:
        g = qlinear(p["w_gate"], xn, "w_gate", qcfg, "bsd,df->bsf", cdtype, tp)
        u = qlinear(p["w_in"], xn, "w_in", qcfg, "bsd,df->bsf", cdtype, tp)
        h = activation(g, cfg.act) * u
    else:
        u = qlinear(p["w_in"], xn, "w_in", qcfg, "bsd,df->bsf", cdtype, tp)
        h = activation(u, cfg.act)
    out = qlinear(p["w_out"], h, "w_out", qcfg, "bsf,fd->bsd", cdtype, tp)
    if cfg.sandwich_norm:
        out = apply_norm(p["ln2_post"], out, cfg.norm)
    return x + out


def block_decode(p: dict, x: torch.Tensor, bd: BlockDef, cfg: ArchConfig,
                 qcfg: QuantConfig, cache: dict, pos: torch.Tensor, cdtype,
                 seq=None, tp_attn=None, tp_ffn=None):
    """Chunk step against one layer's cache. x: (B,C,d); pos: (B,C).

    Returns (x, pending): {"kv": (k, v)}, the chunk's roped K/V, or
    {name: new state} for a recurrent block, for the caller to commit once
    the whole step has run. pos entries of -1 mark padding (partial
    prefill chunks / idle serving slots): their K/V never reach the cache
    and they attend to nothing. Recurrent blocks consume every chunk token
    unconditionally, so padded chunks are only valid for attention blocks
    (the serving engine refuses recurrent and cross patterns). seq: the KV
    cache's sequence split (`attention.attend_chunk`). tp_attn / tp_ffn:
    tensor-parallel sublayers (`dist.spmd.Spmd.tp`); the cache holds every
    head of its rows, so q, k and v are gathered over heads for the
    attention and each rank's own heads of its output enter wo.
    """
    if bd.attn in RECURRENT:
        block = {"mlstm": rec.mlstm_block, "slstm": rec.slstm_block,
                 "rglru": rec.rglru_block}[bd.attn]
        x, st = block(p["rg"] if bd.attn == "rglru" else p, x, cfg, qcfg,
                      cdtype, state=cache[bd.attn])
        pending = {bd.attn: st}
    else:
        tp = tp_attn
        xn = apply_norm(p["ln1"], x, cfg.norm)
        q = qlinear(p["wq"], xn, "wq", qcfg, "bsd,dhk->bshk", cdtype, tp)
        k = qlinear(p["wk"], xn, "wk", qcfg, "bsd,dhk->bshk", cdtype, tp)
        v = qlinear(p["wv"], xn, "wv", qcfg, "bsd,dhk->bshk", cdtype, tp)
        if cfg.pos == "rope":
            q = attn.rope_apply(q, pos, cfg.rope_theta)
            k = attn.rope_apply(k, pos, cfg.rope_theta)
        if tp is not None:
            q, k, v = (tp.gather_model(t, 2) for t in (q, k, v))
        o = attn.attend_chunk(q, k, v, cache["kv"], qcfg, q_per_kv=cfg.q_per_kv,
                              pos=pos,
                              window=cfg.window if bd.attn == "local" else 0,
                              softcap=cfg.attn_softcap, seq=seq)
        if tp is not None:
            o = tp.local(o, 2)
        out = qlinear(p["wo"], o, "wo", qcfg, "bshk,hkd->bsd", cdtype, tp)
        if cfg.sandwich_norm:
            out = apply_norm(p["ln1_post"], out, cfg.norm)
        x = x + out
        pending = {"kv": (k, v)}
    if bd.cross_attn:
        x = _cross_sublayer(p, x, cache["xkv"], cfg, qcfg, cdtype)
    if bd.ffn == "moe":  # the aux losses are training metrics: dropped
        y, _ = moe_mod.moe_ffn(p["moe"], apply_norm(p["ln2"], x, cfg.norm),
                               cfg, qcfg, cdtype, tp_ffn)
        x = x + y
    elif bd.ffn == "dense":
        x = _ffn_sublayer(p, x, cfg, qcfg, cdtype, tp_ffn)
    return x, pending


@torch.no_grad()
def prefill_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                 qcfg: QuantConfig, spmd: Spmd = WHOLE):
    """Multi-token step against the cache (chunked prefill / decode).

    batch: tokens (B,C) int, pos (B,C) int (-1 = padding) [+ audio
    frontend_embeds (B,C,d)]. Returns (logits (B,C,V) f32, cache) with the
    chunk appended to `cache` in place and the recurrent states advanced.
    C=1 is the classic decode step; C=prompt_len against a fresh cache is a
    full prefill whose [:, -1] logits seed generation.

    spmd: the mesh's runtime (`dist.spmd`), where params hold this rank's
    slices (gathered layer by layer) and the cache is this rank's slice
    (`init_cache(spmd=...)`): a sequence-sharded KV cache attends over
    every rank's rows and takes the rows it holds; the sublayers that
    `layer_tp` and `vocab_tp` name run tensor-parallel; the logits come out
    whole on every rank.
    """
    cdtype = _cdtype(cfg)
    vocab = vocab_tp(spmd, cfg)
    params = _gather_top(params, spmd, vocab)
    tokens, pos = batch["tokens"], batch["pos"]
    x = _token_inputs(params, tokens, batch.get("frontend_embeds"), cfg, qcfg,
                      cdtype, vocab[0])
    if cfg.pos == "learned":  # padding rows (pos -1) read row 0
        x = x + params["pos_embed"][pos.clamp(min=0).long()].to(cdtype)
    pending = []
    seqs = [spmd.seq(i) for i in range(cfg.n_layers)]
    for i, p in enumerate(params["layers"]):
        lt = layer_tp(spmd, cfg, i, training=False)
        x, pend = block_decode(spmd.gather(("layers", i), p, lt.split), x,
                               cfg.block_at(i), cfg, qcfg, cache["layers"][i],
                               pos, cdtype, seq=seqs[i], tp_attn=lt.attn,
                               tp_ffn=lt.ffn)
        pending.append(pend)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = lm_head_apply(
        params["lm_head"], x, qcfg, cfg.vocab_size, cfg.padded_vocab,
        final_softcap=cfg.final_softcap,
        tied_embed=params["embed"] if cfg.tie_embeddings else None,
        tp=vocab[1])
    rows = {}  # one index computation per cache shape, not per layer
    for i, pend in enumerate(pending):
        lay = cache["layers"][i]
        if "kv" in pend:
            kv, seq = lay["kv"], seqs[i]
            t = kv.k.shape[1]
            key = (t, cfg.block_at(i).attn == "local", seq)
            if key not in rows:
                if seq is None:
                    rows[key] = attn.append_rows(pos, t, key[1])
                else:  # the rows of a cache of parts x t, kept where held
                    rows[key] = attn.local_rows(
                        attn.append_rows(pos, t * seq.parts, key[1]),
                        seq.index * t, t)
            attn.cache_write_rows(kv, *pend["kv"], pos, rows[key], qcfg)
        for name in RECURRENT:
            if name in pend:
                for key, t in pend[name].items():
                    lay[name][key].copy_(t)
    return logits, cache


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig,
                qcfg: QuantConfig, spmd: Spmd = WHOLE):
    """One new token per sequence: tokens (B,1), pos (B,) or (B,1).
    Returns (logits (B,1,V), cache). Thin C=1 wrapper of prefill_step."""
    b2 = dict(batch)
    if b2["pos"].dim() == 1:
        b2["pos"] = b2["pos"][:, None]
    return prefill_step(params, cache, b2, cfg, qcfg, spmd=spmd)
