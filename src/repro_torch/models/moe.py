"""Mixture-of-Experts FFN with capacity-factor routing (GShard-style).

PyTorch counterpart of `repro.models.moe`, with the same arithmetic: the
router is an f32 einsum (never the kernels), softmax over experts, top-k
renormalized; tokens are scattered into (E, C, d) capacity buffers in
token-major, then slot, order (a running count per expert), over-capacity
slots go to a dump row and are dropped; the three expert linears run
through the batched QAT kernels (`qlinear` on "gecd,edf->gecf" /
"gecf,efd->gecd"); outputs are gathered back, weighted by gate * keep in
the compute dtype and summed over the k slots.

The router's f32 sums are taken in another order than XLA's, so where the
reference's logits tie exactly (at init the router's 8-bit activation
quantizer, scale 1, turns its input into small integers) the port's may
differ by an ulp and select the other expert; tests/test_torch_moe.py
bounds where that happens. Rounding elsewhere follows the reference's
compiled code: the dispatch adds each
token into zeros (exact), and the combine's k-slot sum of bf16 rows is one
f32 sum rounded once to bf16, which is what XLA does for a bf16 reduction.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantConfig
from repro_torch.models.common import activation, linear_init, qlinear


def moe_init(gen: torch.Generator, cfg: ArchConfig, qcfg: QuantConfig,
             device=None) -> dict:
    """Router (d, E) and expert weights (E, d, f) / (E, f, d) with
    per-expert scale groups; the reference's shapes and deviations."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    lin = lambda name, shape, std, ga=(): linear_init(
        gen, name, qcfg, shape, std=std, group_axes=ga, device=device)
    p = {"router": lin("router", (d, e), d ** -0.5),
         "moe_in": lin("moe_in", (e, d, f), d ** -0.5, (0,)),
         "moe_out": lin("moe_out", (e, f, d), f ** -0.5, (0,))}
    if cfg.ffn_gated:
        p["moe_gate"] = lin("moe_gate", (e, d, f), d ** -0.5, (0,))
    return p


def capacity(n_tokens: int, cfg: ArchConfig) -> int:
    """Slots an expert holds for n_tokens routed tokens: top_k / E of them
    times the capacity factor, rounded up to a multiple of 8 (at least 8)."""
    c = int(n_tokens * cfg.moe_top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, (c + 7) // 8 * 8)


def _route_group(xt: torch.Tensor, exp_idx: torch.Tensor, c: int, e: int,
                 k: int, cdtype):
    """Capacity-pack one group's tokens. xt (t, d), exp_idx (t, k) ->
    (buffer (e, c, d), slot (t*k,), keep (t*k,)): slot j of token i goes to
    row exp * c + (number of earlier (token, slot) pairs routed to exp), or
    to the dump row e * c when that count reaches c."""
    t, d = xt.shape
    flat_e = exp_idx.reshape(-1)
    # one-hot (e, t*k): the running count runs along the inner axis (a
    # scan along an outer axis is ~50x slower on the GPU); integer, exact
    onehot = (flat_e[None, :] == torch.arange(e, device=xt.device)[:, None]
              ).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1) - onehot            # slots before me
    my_pos = torch.sum(pos * onehot, dim=0)
    keep = my_pos < c
    slot = torch.where(keep, flat_e * c + my_pos, e * c)  # overflow -> dump row
    src = xt.to(cdtype)[:, None, :].expand(t, k, d).reshape(t * k, d)
    disp = torch.zeros((e * c + 1, d), dtype=cdtype, device=xt.device)
    disp = disp.index_add(0, slot, src)  # kept slots unique: adds into zeros
    return disp[:e * c].reshape(e, c, d), slot, keep


def _combine_group(out_buf: torch.Tensor, slot, keep, gate_vals, e: int,
                   c: int, k: int, cdtype) -> torch.Tensor:
    """Gather each (token, slot)'s expert output (the dump row reads zeros),
    weight it by bf16(gate * keep) and sum the k slots: f32 sum, rounded
    once to the compute dtype."""
    d = out_buf.shape[-1]
    flat_out = torch.cat([out_buf.reshape(e * c, d),
                          out_buf.new_zeros((1, d))], dim=0)
    w = (gate_vals.reshape(-1, 1) * keep[:, None]).to(cdtype)
    per_slot = torch.index_select(flat_out, 0, slot) * w
    t = gate_vals.shape[0]
    return per_slot.reshape(t, k, d).to(torch.float32).sum(dim=1).to(cdtype)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantConfig,
            cdtype=torch.bfloat16):
    """x (B, S, d) -> ((B, S, d), aux) with aux {"lb_loss": the
    Switch-style load-balance loss, "drop_frac": the share of (token, slot)
    pairs over capacity}. Routing and capacity apply within
    cfg.moe_dispatch_groups equal groups of tokens (1 unless it divides
    the token count)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    grp = cfg.moe_dispatch_groups
    if grp <= 1 or t % grp:
        grp = 1
    xt = x.reshape(t, d)

    logits = qlinear(p["router"], xt, "router", qcfg, "td,de->te",
                     cdtype=torch.float32)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    # lax.top_k's order: descending, the lower expert index first on a tie
    # (a stable sort; torch.topk leaves the order of equal values open)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, exp_idx = top.values[:, :k], top.indices[:, :k]
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    tl = t // grp
    c = capacity(tl, cfg)
    xg = xt.reshape(grp, tl, d)
    gv = gate_vals.reshape(grp, tl, k)
    ei = exp_idx.reshape(grp, tl, k)
    routed = [_route_group(xg[i], ei[i], c, e, k, cdtype) for i in range(grp)]
    buf = torch.stack([r[0] for r in routed])             # (g, e, c, d)

    # expert compute: the batched QAT kernels, per-expert scales
    if cfg.ffn_gated:
        gt = qlinear(p["moe_gate"], buf, "moe_gate", qcfg, "gecd,edf->gecf",
                     cdtype)
        u = qlinear(p["moe_in"], buf, "moe_in", qcfg, "gecd,edf->gecf", cdtype)
        h = activation(gt, cfg.act) * u
    else:
        u = qlinear(p["moe_in"], buf, "moe_in", qcfg, "gecd,edf->gecf", cdtype)
        h = activation(u, cfg.act)
    out_buf = qlinear(p["moe_out"], h, "moe_out", qcfg, "gecf,efd->gecd",
                      cdtype)

    y = torch.stack([_combine_group(out_buf[i], routed[i][1], routed[i][2],
                                    gv[i], e, c, k, cdtype)
                     for i in range(grp)])                  # (g, tl, d)

    me = torch.mean(probs, dim=0)
    onehot_all = torch.nn.functional.one_hot(exp_idx.reshape(-1), e).to(
        torch.float32)
    ce_frac = torch.mean(onehot_all, dim=0) * k
    keep = torch.cat([r[2] for r in routed])
    aux = {"lb_loss": e * torch.sum(me * ce_frac) / k,
           "drop_frac": 1.0 - torch.mean(keep.to(torch.float32))}
    return y.reshape(b, s, d), aux
