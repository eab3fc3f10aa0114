"""Mixture-of-Experts FFN with capacity-factor routing (GShard-style).

PyTorch counterpart of `repro.models.moe`, with the same arithmetic: the
router is an f32 einsum (never the kernels), softmax over experts, top-k
renormalized; tokens are scattered into (E, C, d) capacity buffers in
token-major, then slot, order (a running count per expert), over-capacity
slots go to a dump row and are dropped; the three expert linears run
through the batched QAT kernels (`qlinear` on "gecd,edf->gecf" /
"gecf,efd->gecd"), or in serving form (int codes) through the
dequantize-and-einsum fallback, as in the reference, as bmm over blocks of
8 capacity rows (`common._expert_matmul`); outputs are gathered back,
weighted by gate * keep in the compute dtype and summed over the k slots.
Serving routes padding and idle rows (pos = -1) too, and they take
capacity, as in the reference: a step's drops depend on its other rows,
so streams are bit-exact across pools only at a capacity without drops.

On a model axis (`tp`, a `dist.spmd.TPSplit`) the model ranks of a data
group hold the same rows, so the router, run whole, gives each the same
capacity buffer. Expert parallelism (`tp.experts`) cuts the buffer to the
rank's experts, runs them, and all-gathers the output buffer along the
experts before the combine: each expert's rows meet the same arithmetic
as in one process. Tensor parallelism within the experts feeds the whole
buffer to the column-parallel moe_in / moe_gate slices and sums
moe_out's row-parallel partials over the ranks (`qlinear`).

On data ranks (`dp`, a `dist.spmd.DPSplit`: each rank holds its share of
the batch's rows, in global row order) the FFN routes the global batch, as
the reference's jitted step does: cfg.moe_dispatch_groups groups of the
global tokens, each with the capacity of its global token count, slots
filled in global token-major order. A rank routes the parts of the groups
its rows hold. Its per-expert counts of (token, slot) pairs in each group
are all-gathered over the data ranks (one small integer collective a
forward, counted under "experts"); a pair's global position is the earlier
ranks' count in its group plus its local one, and it is kept where that is
under the capacity: the reference's keep mask, bit for bit, given the same
top-k. The rank's kept pairs at expert e of a group sit in global slots
[off, min(off + n, c)); its buffer holds them from row 0, at a local
capacity of the most it keeps at any expert, rounded up to 8 (one host
read a layer; c itself where its rows hold whole groups, and on the meta
device, which has no counts, c over the group's ranks, rounded up to 8:
the balanced load). The model ranks of a data group hold the same rows,
so they share that capacity. lb_loss is each rank's mean router
probabilities against the whole batch's per-expert choice counts (the
same gathered counts), so the data ranks' mean of it is the reference's
Switch loss of the whole batch, and its gradient is the reference's;
drop_frac is the rank's share of dropped pairs, whose mean over the data
ranks is the global share.

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

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantConfig
from repro_torch.dist.spmd import all_gather, counted_as
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


def _dispatch_groups(n_tokens: int, cfg: ArchConfig) -> int:
    """The groups n_tokens (the global batch's) are routed in:
    cfg.moe_dispatch_groups where it divides them, else 1."""
    grp = cfg.moe_dispatch_groups
    return 1 if grp <= 1 or n_tokens % grp else grp


# the capacity buffers' rows (groups x capacity) of the MoE FFN calls since
# the last reset, {rows: calls}, and the bytes of their count gathers
_ROWS: dict = {}
_COUNT_BYTES = [0]


def buffer_rows() -> dict:
    """{a call's capacity-buffer rows (its groups x its capacity, local on
    data ranks): the calls that ran it} since the last reset."""
    return dict(_ROWS)


def count_gather_bytes() -> int:
    """The bytes the count all-gathers of data-split calls delivered to
    this rank since the last reset (all of them also in
    `dist.spmd.moved_bytes_by_use()["experts"]`)."""
    return _COUNT_BYTES[0]


def reset_buffer_rows() -> None:
    _ROWS.clear()
    _COUNT_BYTES[0] = 0


def _route_group(xt: torch.Tensor, exp_idx: torch.Tensor, c: int, e: int,
                 k: int, cdtype, off: Optional[torch.Tensor] = None,
                 cl: Optional[int] = None):
    """Capacity-pack one group's tokens. xt (t, d), exp_idx (t, k) ->
    (buffer (e, c, d), slot (t*k,), keep (t*k,)): slot j of token i goes to
    row exp * c + (number of earlier (token, slot) pairs routed to exp), or
    to the dump row e * c when that count reaches c. off (e,): the pairs
    earlier ranks routed to each expert in this group, so a pair is kept
    where off + its count is under c; the buffer then holds the kept pairs
    from row 0 at `cl` rows an expert."""
    t, d = xt.shape
    flat_e = exp_idx.reshape(-1)
    # one-hot (e, t*k): the running count runs along the inner axis (a
    # scan along an outer axis is ~50x slower on the GPU); integer, exact
    onehot = (flat_e[None, :] == torch.arange(e, device=xt.device)[:, None]
              ).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1) - onehot            # slots before me
    my_pos = torch.sum(pos * onehot, dim=0)
    if off is None:
        keep = my_pos < c
    else:
        keep = my_pos < c - off[flat_e]
        c = cl
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


class _Plan(NamedTuple):
    """How a rank routes its rows of the global batch (`_data_plan`):
    its segments (start, length) of local tokens, one a group its rows
    touch, in order; each segment's earlier ranks' counts per expert (None
    where every segment is a whole group); the local capacity; and the
    whole batch's count of top-k choices per expert."""
    segments: list
    offsets: Optional[torch.Tensor]
    cl: int
    choices: torch.Tensor


def _data_plan(exp_idx: torch.Tensor, dp, grp: int, tl: int, c: int,
               e: int) -> _Plan:
    """The rank's segments of the global groups, from the data ranks'
    all-gathered (group, expert) counts of (token, slot) pairs."""
    t = exp_idx.shape[0]
    lo = dp.index * t
    first, last = lo // tl, (lo + t - 1) // tl
    segments = [(max(j * tl, lo) - lo, min((j + 1) * tl, lo + t) - max(j * tl, lo))
                for j in range(first, last + 1)]
    experts = torch.arange(e, device=exp_idx.device)
    local = torch.zeros((grp, e), dtype=torch.int32, device=exp_idx.device)
    local[first:last + 1] = torch.stack([
        (exp_idx[a:a + n].reshape(-1)[None, :] == experts[:, None]).sum(1)
        for a, n in segments]).to(torch.int32)
    with counted_as("experts"):
        counts = all_gather(local, dp.group, 0).view(dp.parts, grp, e)
    _COUNT_BYTES[0] += counts.numel() * counts.element_size()
    choices = counts.sum(dim=(0, 1))
    if all(n == tl for _, n in segments):  # whole groups: nobody before me
        return _Plan(segments, None, c, choices)
    offsets = counts[:dp.index].sum(dim=0)[first:last + 1]
    if exp_idx.device.type == "meta":  # no counts: the balanced load
        share = -(-c * max(n for _, n in segments) // tl)  # ceil
        cl = min(c, max(8, (share + 7) // 8 * 8))
    else:  # the most kept pairs at any expert (one host read)
        kept = torch.clamp(torch.minimum(local[first:last + 1], c - offsets), min=0)
        cl = max(8, (int(kept.max()) + 7) // 8 * 8)
    return _Plan(segments, offsets, cl, choices)


def moe_ffn(p: dict, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantConfig,
            cdtype=torch.bfloat16, tp=None, dp=None, keep_mask: bool = False):
    """x (B, S, d) -> ((B, S, d), aux) with aux {"lb_loss": the
    Switch-style load-balance loss, "drop_frac": the share of (token, slot)
    pairs over capacity} (and with keep_mask, "keep": (B * S, k) bool, each
    pair kept). Routing and capacity apply within cfg.moe_dispatch_groups
    equal groups of tokens (1 unless it divides the token count). tp:
    `p`'s expert linears hold this rank's slices (see the module
    docstring); the router and aux are whole, the same on every model
    rank. dp: x is this data rank's share of the batch's rows, and the
    groups, capacities, keep mask and lb_loss are the whole batch's (see
    the module docstring)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.moe_top_k
    parts = 1 if dp is None else dp.parts
    grp = _dispatch_groups(t * parts, cfg)
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

    tl = t * parts // grp
    c = capacity(tl, cfg)
    if dp is None:
        plan = _Plan([(i * tl, tl) for i in range(grp)], None, c, None)
    else:
        with torch.no_grad():
            plan = _data_plan(exp_idx, dp, grp, tl, c, e)
    cl = plan.cl
    routed = [_route_group(xt[a:a + n], exp_idx[a:a + n], c, e, k, cdtype,
                           None if plan.offsets is None else plan.offsets[j], cl)
              for j, (a, n) in enumerate(plan.segments)]
    buf = torch.stack([r[0] for r in routed])             # (g, e, cl, d)
    rows = buf.shape[0] * cl
    _ROWS[rows] = _ROWS.get(rows, 0) + 1
    ep = tp is not None and tp.experts
    with counted_as("experts"):
        if ep:  # this rank's experts
            buf = tp.split_model(buf, 1)

        # expert compute: the batched QAT kernels (latent weights) or the
        # row-blocked fallback (int codes), per-expert scales
        if cfg.ffn_gated:
            gt = qlinear(p["moe_gate"], buf, "moe_gate", qcfg, "gecd,edf->gecf",
                         cdtype, tp)
            u = qlinear(p["moe_in"], buf, "moe_in", qcfg, "gecd,edf->gecf", cdtype,
                        tp)
            h = activation(gt, cfg.act) * u
        else:
            u = qlinear(p["moe_in"], buf, "moe_in", qcfg, "gecd,edf->gecf", cdtype,
                        tp)
            h = activation(u, cfg.act)
        out_buf = qlinear(p["moe_out"], h, "moe_out", qcfg, "gecf,efd->gecd",
                          cdtype, tp)
        if ep:  # every expert's outputs, on every model rank
            out_buf = tp.gather_model(out_buf, 1)

    y = torch.cat([_combine_group(out_buf[j], r[1], r[2],
                                  gate_vals[a:a + n], e, cl, k, cdtype)
                   for j, (r, (a, n)) in enumerate(zip(routed, plan.segments))])

    me = torch.mean(probs, dim=0)
    if plan.choices is None:
        onehot_all = torch.nn.functional.one_hot(exp_idx.reshape(-1), e).to(
            torch.float32)
        ce_frac = torch.mean(onehot_all, dim=0) * k
    else:  # the whole batch's mean of the one-hot choices, times k
        ce_frac = plan.choices.to(torch.float32) / (t * parts * k) * k
    keep = torch.cat([r[2] for r in routed])
    aux = {"lb_loss": e * torch.sum(me * ce_frac) / k,
           "drop_frac": 1.0 - torch.mean(keep.to(torch.float32))}
    if keep_mask:
        aux["keep"] = keep.reshape(t, k)
    return y.reshape(b, s, d), aux
