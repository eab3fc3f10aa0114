"""Recurrent blocks: mLSTM (chunkwise-parallel), sLSTM (scan), RG-LRU.

PyTorch counterpart of `repro.models.recurrent`, op for op:
  * mLSTM runs the stabilized chunkwise form: masked (L x L) products inside
    a chunk, the (C, n, m) state carried from chunk to chunk by a Python
    loop, log-domain maxima keeping every exp() bounded. The chunk length
    follows the reference's rule exactly (`chunk_len`), so both packages
    sum the same terms.
  * sLSTM is sequential (a scalar memory with a recurrent head-wise mix): a
    Python loop over time.
  * RG-LRU is a diagonal linear recurrence, computed by `assoc_scan`, the
    reference's `jax.lax.associative_scan` algorithm written out (the same
    odd / even recursion, so the same products in the same order: log2(S)
    levels of element-wise ops).
  * Causal depthwise convs (k <= 4) are k shifted multiplies summed in
    order j = 0..k-1, in the input's dtype.

The recurrences run in f32. `log_sigmoid` and `softplus` are XLA's
formulas with JAX's derivatives, as `common.sigmoid` is. With a carried
state (the serving path) every contraction is summed in f64 and rounded
once to f32 (`_ein`), so a row's bits do not depend on how many rows share
the step; training sums them in f32, as the reference does.

Every block takes (p, x, cfg, qcfg, cdtype, state=None, collect=False) and
returns (x + out, new_state): new_state is None unless a state was given
or collect asks for one (a fresh state carried through the sequence).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantConfig
from repro_torch.models.common import (_row_mean, _scalar, apply_norm, gelu,
                                       linear_init, norm_init, qlinear,
                                       quantized_weight, sigmoid, silu)

LRU_C = 8.0


# ---------------------------------------------------------------------------
# XLA's softplus / log_sigmoid
# ---------------------------------------------------------------------------

def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == float("inf"), torch.zeros_like(x), x)


class _Softplus(torch.autograd.Function):
    """logaddexp(x, 0) as XLA evaluates it, op by op in x's dtype:
    max(x, 0) + log1p(exp(-|x|)), with JAX's derivative exp(x - y) (+inf
    read as 0 on both sides)."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(_finite_or_zero(x) - _finite_or_zero(y))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """-softplus(-x), as jax.nn.log_sigmoid."""
    return -softplus(-x)


def _ein(eq: str, *ops: torch.Tensor, exact: bool) -> torch.Tensor:
    """f32 einsum; exact: summed in f64 and rounded once to f32."""
    if exact:
        return torch.einsum(eq, *(o.to(torch.float64) for o in ops)).to(torch.float32)
    return torch.einsum(eq, *ops)


def _head_norm(hs: torch.Tensor) -> torch.Tensor:
    """hs * rsqrt(mean(hs^2) + 1e-6) over the last axis, f32."""
    return hs * torch.rsqrt(_row_mean(hs * hs) + 1e-6)


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv. x: (B, S, C), w: (C, K).

    Training (state=None): left-pad K-1 zero rows. Decode: `state` holds the
    previous K-1 inputs (B, K-1, C); returns (y, new_state) with new_state
    the last K-1 rows of [state; x] in x's dtype.
    """
    k = w.shape[1]
    s = x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    wd = w.to(x.dtype)
    y = xp[:, 0:s] * wd[:, k - 1]
    for j in range(1, k):
        y = y + xp[:, j:j + s] * wd[:, k - 1 - j]
    new_state = xp[:, xp.shape[1] - (k - 1):] if k > 1 else xp[:, :0]
    return y, new_state


# ===========================================================================
# mLSTM
# ===========================================================================

def mlstm_init(gen: torch.Generator, cfg: ArchConfig, qcfg: QuantConfig,
               device=None) -> dict:
    """The reference's mLSTM leaves, shapes and deviations
    (recurrent.py:50-74)."""
    d = cfg.d_model
    du = 2 * d
    h = cfg.n_heads
    dh = du // h
    lin = lambda name, shape, std, ga=(), bias=None: linear_init(
        gen, name, qcfg, shape, std=std, group_axes=ga, bias_shape=bias,
        device=device)
    p = {"ln": norm_init(d, cfg.norm, device),
         "m_up_gate": lin("m_up_gate", (d, du), d ** -0.5),
         "m_up": lin("m_up", (d, du), d ** -0.5),
         "conv_w": torch.randn((du, cfg.conv_kernel), generator=gen,
                               dtype=torch.float32, device=device) * 0.1,
         "mq": lin("mq", (du, h, dh), du ** -0.5, (1,)),
         "mk": lin("mk", (du, h, dh), du ** -0.5, (1,)),
         "mv": lin("mv", (du, h, dh), du ** -0.5, (1,)),
         "m_i": lin("m_i", (du, h), du ** -0.5, bias=(h,)),
         "m_f": lin("m_f", (du, h), du ** -0.5, bias=(h,)),
         "hn_g": torch.ones((h, dh), dtype=torch.float32, device=device),
         "m_down": lin("m_down", (du, d), du ** -0.5)}
    return p


def chunk_len(s: int, chunk: int) -> int:
    """The reference's chunk length: min(chunk, s), halved until it
    divides s."""
    l = max(1, min(chunk, s))
    while s % l:
        l //= 2
    return l


def _mlstm_chunk_scan(q, k, v, i_raw, f_raw, carry, chunk: int, exact: bool):
    """Stabilized chunkwise mLSTM.

    q, k, v: (B, S, H, D); i_raw / f_raw: (B, S, H); carry (C (B, H, D, D),
    n (B, H, D), m (B, H)) with C and n stored scaled by exp(-m). Returns
    h (B, S, H, D) f32 and the new carry.
    """
    b, s, h, d = q.shape
    l = chunk_len(s, chunk)
    nc = s // l
    f32 = torch.float32

    def chunks(x):
        return x.reshape(b, nc, l, *x.shape[2:]).transpose(0, 1)

    qs = chunks(q * _scalar(d ** -0.5, q))
    ks_, vs, is_, fs = chunks(k), chunks(v), chunks(i_raw), chunks(f_raw)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=q.device))
    c_hat, n_hat, m_prev = carry
    outs = []
    for ci in range(nc):
        qc, kc, vc = qs[ci].to(f32), ks_[ci].to(f32), vs[ci].to(f32)
        ic = is_[ci].to(f32)
        lf = log_sigmoid(fs[ci].to(f32))                      # (B, L, H)
        a = torch.cumsum(lf, dim=1)                           # decay to t
        a_tot = a[:, -1]                                      # (B, H)
        m_loc = torch.cummax(ic - a, dim=1).values            # (B, L, H)
        m_t = a + torch.maximum(m_prev[:, None], m_loc)       # (B, L, H)

        # intra-chunk: w(t, j) = exp(a_t - a_j + i_j - m_t), j <= t
        log_w = (a[:, :, None] - a[:, None, :]                # (B, L, L, H)
                 + ic[:, None, :] - m_t[:, :, None])
        w = torch.where(mask[None, :, :, None], torch.exp(log_w),
                        torch.zeros((), dtype=f32, device=q.device))
        sc = _ein("bthd,bjhd->btjh", qc, kc, exact=exact)
        num = _ein("btjh,bjhd->bthd", w * sc, vc, exact=exact)
        den = _ein("btjh,bjhd->bthd", w, kc, exact=exact)

        # inter-chunk: exp(a_t + m_prev - m_t) * (q_t @ C_hat)
        w_in = torch.exp(a + m_prev[:, None] - m_t)           # (B, L, H)
        num = num + w_in[..., None] * _ein("bthd,bhde->bthe", qc, c_hat,
                                           exact=exact)
        den_v = den + w_in[..., None] * n_hat[:, None]
        prod = qc * den_v
        qn = (torch.sum(prod.to(torch.float64), dim=-1).to(f32) if exact
              else torch.sum(prod, dim=-1))                   # (B, L, H)
        denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))
        outs.append(num / denom[..., None])

        # carry update
        m_new = a_tot + torch.maximum(m_prev, m_loc[:, -1])   # (B, H)
        w_end = torch.exp(a_tot[:, None] - a + ic - m_new[:, None])
        decay = torch.exp(m_prev + a_tot - m_new)
        c_hat = (decay[..., None, None] * c_hat
                 + _ein("blh,blhd,blhe->bhde", w_end, kc, vc, exact=exact))
        n_hat = (decay[..., None] * n_hat
                 + _ein("blh,blhd->bhd", w_end, kc, exact=exact))
        m_prev = m_new
    hs = torch.stack(outs).transpose(0, 1).reshape(b, s, h, d)
    return hs, (c_hat, n_hat, m_prev)


def mlstm_state_init(batch: int, n_heads: int, dh: int, device=None):
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=device)
    return (z(batch, n_heads, dh, dh), z(batch, n_heads, dh),
            torch.full((batch, n_heads), -1e9, dtype=torch.float32,
                       device=device))


def mlstm_fresh_state(cfg: ArchConfig, batch: int, device=None) -> dict:
    du = 2 * cfg.d_model
    dh = du // cfg.n_heads
    c, n, m = mlstm_state_init(batch, cfg.n_heads, dh, device)
    return {"C": c, "n": n, "m": m,
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, du),
                                dtype=torch.float32, device=device)}


def _whole_only(tp, state, collect: bool) -> None:
    if tp is not None and (state is not None or collect):
        raise ValueError("a tensor-parallel recurrent block is for training: it "
                         "takes no state and collects none")


def _shared_input(tp):
    """The split of column-parallel linears whose one input the block fed
    through a model-axis operator (`TPSplit.summed`), or None."""
    return None if tp is None else tp._replace(summed=True)


def mlstm_block(p: dict, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantConfig,
                cdtype=torch.bfloat16, state=None, collect: bool = False,
                chunk: int = 64, tp=None):
    """Full mLSTM residual block; any S (decode: S = 1 with a state).

    tp (a `dist.spmd.TPSplit`, training only): the block on this rank's
    heads. m_up_gate / m_up give the rank's du columns (the channels of its
    heads: hs is head-major), the conv runs on them with its slice of
    conv_w, and the conv's output is all-gathered (`gather_sum`) for mq /
    mk / mv / m_i / m_f, which contract the whole du and give the rank's
    heads; the chunk scan and the head norm run on those heads, and
    m_down is row-parallel. The replicated conv_w and hn_g are read
    through `split_model`, so every rank holds their whole gradient."""
    _whole_only(tp, state, collect)
    b, s, d = x.shape
    parts = 1 if tp is None else tp.parts
    h = cfg.n_heads // parts
    du = 2 * d // parts
    dh = 2 * d // cfg.n_heads
    exact = state is not None
    if state is None and collect:
        state = mlstm_fresh_state(cfg, b, x.device)
    col = _shared_input(tp)
    xn = apply_norm(p["ln"], x, cfg.norm)
    if tp is not None:
        xn = tp.to_model(xn)
    zg = qlinear(p["m_up_gate"], xn, "m_up_gate", qcfg, "bsd,du->bsu", cdtype, col)
    xi = qlinear(p["m_up"], xn, "m_up", qcfg, "bsd,du->bsu", cdtype, col)
    conv_w = p["conv_w"] if tp is None else tp.split_model(p["conv_w"], 0)
    xc, new_conv = causal_conv(xi, conv_w, None if state is None else state["conv"])
    xc = silu(xc)
    if tp is not None:
        xc = tp.gather_sum(xc, -1)
    q = qlinear(p["mq"], xc, "mq", qcfg, "bsu,uhd->bshd", cdtype, col)
    k = qlinear(p["mk"], xc, "mk", qcfg, "bsu,uhd->bshd", cdtype, col)
    k = k * _scalar(dh ** -0.5, k)
    v = qlinear(p["mv"], xc, "mv", qcfg, "bsu,uhd->bshd", cdtype, col)
    i_raw = qlinear(p["m_i"], xc, "m_i", qcfg, "bsu,uh->bsh", cdtype, col)
    f_raw = qlinear(p["m_f"], xc, "m_f", qcfg, "bsu,uh->bsh", cdtype, col)

    carry = (mlstm_state_init(b, h, dh, x.device) if state is None
             else (state["C"], state["n"], state["m"]))
    hs, carry = _mlstm_chunk_scan(q, k, v, i_raw, f_raw, carry, chunk, exact)
    new_state = None
    if state is not None:
        new_state = {"C": carry[0], "n": carry[1], "m": carry[2],
                     "conv": new_conv}
    hn_g = p["hn_g"] if tp is None else tp.split_model(p["hn_g"], 0)
    hs = _head_norm(hs) * hn_g[None, None]
    hs = hs.reshape(b, s, du).to(cdtype) * silu(zg)
    out = qlinear(p["m_down"], hs, "m_down", qcfg, "bsu,ud->bsd", cdtype, tp)
    return x + out, new_state


# ===========================================================================
# sLSTM
# ===========================================================================

def slstm_ff(d: int) -> int:
    """The 4/3-GLU FFN width: 4d/3 rounded up to a multiple of 8."""
    return int(math.ceil(4 * d / 3 / 8) * 8)


def slstm_init(gen: torch.Generator, cfg: ArchConfig, qcfg: QuantConfig,
               device=None) -> dict:
    """The reference's sLSTM leaves (recurrent.py:198-215)."""
    d = cfg.d_model
    h = cfg.n_heads
    dh = d // h
    f_ff = slstm_ff(d)
    lin = lambda name, shape, std, bias=None: linear_init(
        gen, name, qcfg, shape, std=std, bias_shape=bias, device=device)
    ones = torch.ones((h, dh), dtype=torch.float32, device=device)
    p = {"ln": norm_init(d, cfg.norm, device), "ln2": norm_init(d, cfg.norm, device),
         "gn_g": ones, "f_bias": ones * 3.0}
    for nm in ("s_z", "s_i", "s_f", "s_o"):
        p[nm] = lin(nm, (d, h, dh), d ** -0.5, (h, dh))
    # block-diagonal recurrent mixing (per head)
    p["s_r"] = lin("s_r", (4, h, dh, dh), dh ** -0.5)
    p["w_gate"] = lin("w_gate", (d, f_ff), d ** -0.5)
    p["w_in"] = lin("w_in", (d, f_ff), d ** -0.5)
    p["w_out"] = lin("w_out", (f_ff, d), f_ff ** -0.5)
    return p


def slstm_state_init(batch: int, n_heads: int, dh: int, device=None) -> dict:
    z = lambda: torch.zeros((batch, n_heads, dh), dtype=torch.float32,
                            device=device)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, n_heads, dh), -1e9, dtype=torch.float32,
                            device=device)}


def slstm_block(p: dict, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantConfig,
                cdtype=torch.bfloat16, state=None, collect: bool = False,
                tp=None):
    """sLSTM residual block + its 4/3-GLU FFN sublayer (xLSTM recipe).

    tp (a `dist.spmd.TPSplit`, training only): the FFN on this rank's d_ff
    slice (w_gate / w_in column-parallel, w_out row-parallel). The cell
    runs whole on every rank: the rules cut s_z / s_i / s_f / s_o and s_r
    along dh, which every token's recurrent mix contracts."""
    _whole_only(tp, state, collect)
    b, s, d = x.shape
    h = cfg.n_heads
    dh = d // h
    exact = state is not None
    f32 = torch.float32
    xn = apply_norm(p["ln"], x, cfg.norm)
    # pre-activations from the inputs (the recurrent part is added per step)
    pre = {nm: qlinear(p[nm], xn, nm, qcfg, "bsd,dhk->bshk", cdtype)
           for nm in ("s_z", "s_i", "s_f", "s_o")}
    pre["s_f"] = pre["s_f"] + p["f_bias"].to(cdtype)
    # (4, h, dh, dh) recurrent mixing; fp / fake-quant / int codes
    r = quantized_weight(p["s_r"], "s_r", qcfg).to(f32)
    want_state = collect or state is not None
    st = slstm_state_init(b, h, dh, x.device) if state is None else state
    c, n, hh, m = st["c"], st["n"], st["h"], st["m"]
    outs = []
    for t in range(s):
        rh = _ein("bhk,ghkl->gbhl", hh, r, exact=exact)        # (4, B, H, dh)
        zt = torch.tanh(pre["s_z"][:, t].to(f32) + rh[0])
        it = pre["s_i"][:, t].to(f32) + rh[1]
        ft = pre["s_f"][:, t].to(f32) + rh[2]
        ot = sigmoid(pre["s_o"][:, t].to(f32) + rh[3])
        lf = log_sigmoid(ft)
        m_new = torch.maximum(lf + m, it)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(it - m_new)
        c = fp * c + ip * zt
        n = fp * n + ip
        hh = ot * c / torch.maximum(n, torch.full_like(n, 1e-6))
        m = m_new
        outs.append(hh)
    hs = torch.stack(outs, dim=1)                              # (B, S, H, dh)
    hs = (_head_norm(hs) * p["gn_g"][None, None]).reshape(b, s, d).to(cdtype)
    x = x + hs
    # FFN sublayer (4/3 GLU)
    col = _shared_input(tp)
    xn2 = apply_norm(p["ln2"], x, cfg.norm)
    if tp is not None:
        xn2 = tp.to_model(xn2)
    g = qlinear(p["w_gate"], xn2, "w_gate", qcfg, "bsd,df->bsf", cdtype, col)
    u = qlinear(p["w_in"], xn2, "w_in", qcfg, "bsd,df->bsf", cdtype, col)
    y = qlinear(p["w_out"], silu(g) * u, "w_out", qcfg, "bsf,fd->bsd", cdtype, tp)
    new_state = {"c": c, "n": n, "h": hh, "m": m} if want_state else None
    return x + y, new_state


# ===========================================================================
# RG-LRU (Griffin / RecurrentGemma recurrent block)
# ===========================================================================

def rglru_init(gen: torch.Generator, cfg: ArchConfig, qcfg: QuantConfig,
               device=None) -> dict:
    """The reference's RG-LRU leaves (recurrent.py:277-295): Lambda drawn
    so that a = sigmoid(Lambda)^c lies in ~(0.9, 0.999)."""
    d = cfg.d_model
    w = cfg.lru_width or d
    lin = lambda name, shape, std, bias=None: linear_init(
        gen, name, qcfg, shape, std=std, bias_shape=bias, device=device)
    lam = torch.rand((w,), generator=gen, dtype=torch.float32,
                     device=device) * (0.8 - 0.38) + 0.38
    return {"ln": norm_init(d, cfg.norm, device),
            "g_gate": lin("g_gate", (d, w), d ** -0.5),
            "g_in": lin("g_in", (d, w), d ** -0.5),
            "conv_w": torch.randn((w, cfg.conv_kernel), generator=gen,
                                  dtype=torch.float32, device=device) * 0.1,
            "g_a": lin("g_a", (w, w), w ** -0.5, (w,)),
            "g_x": lin("g_x", (w, w), w ** -0.5, (w,)),
            "lam": lam,
            "g_out": lin("g_out", (w, d), w ** -0.5)}


def rglru_state_init(batch: int, width: int, conv_kernel: int,
                     device=None) -> dict:
    return {"h": torch.zeros((batch, width), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, conv_kernel - 1, width),
                                dtype=torch.float32, device=device)}


def _interleave(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[x0, y0, x1, y1, ...] along axis 1; x has as many rows as y or one
    more."""
    n = y.shape[1]
    both = torch.stack([x[:, :n], y], dim=2).reshape(
        x.shape[0], 2 * n, *x.shape[2:])
    return torch.cat([both, x[:, n:]], dim=1) if x.shape[1] > n else both


def assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t along axis 1 with the
    combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2), by
    `jax.lax.associative_scan`'s recursion: combine adjacent pairs, scan
    the pairs, then fill in the even positions. Returns (A, H)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra = a[:, 0:n - 1:2] * a[:, 1::2]
    rb = a[:, 1::2] * b[:, 0:n - 1:2] + b[:, 1::2]
    oa, ob = assoc_scan(ra, rb)
    if n % 2 == 0:
        pa, pb = oa[:, :-1], ob[:, :-1]
    else:
        pa, pb = oa, ob
    a2, b2 = a[:, 2::2], b[:, 2::2]
    ea = torch.cat([a[:, :1], pa * a2], dim=1)
    eb = torch.cat([b[:, :1], a2 * pb + b2], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_block(p: dict, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantConfig,
                cdtype=torch.bfloat16, state=None, collect: bool = False,
                tp=None):
    """RG-LRU residual block. tp (a `dist.spmd.TPSplit`, training only):
    the block on this rank's channels. g_gate / g_in give the rank's w
    columns, the conv runs on them with its slice of conv_w; g_a / g_x read
    the conv's whole output (`gather_sum`) and give the rank's channels,
    which meet its own slice of it in the gated input; the scan runs per
    channel, lam is read on the rank's channels (`split_model`) and g_out
    is row-parallel."""
    _whole_only(tp, state, collect)
    b, s, d = x.shape
    f32 = torch.float32
    col = _shared_input(tp)
    xn = apply_norm(p["ln"], x, cfg.norm)
    if tp is not None:
        xn = tp.to_model(xn)
    gate = qlinear(p["g_gate"], xn, "g_gate", qcfg, "bsd,dw->bsw", cdtype, col)
    xi = qlinear(p["g_in"], xn, "g_in", qcfg, "bsd,dw->bsw", cdtype, col)
    conv_w, lam = p["conv_w"], p["lam"]
    if tp is not None:
        conv_w, lam = tp.split_model(conv_w, 0), tp.split_model(lam, 0)
    xc, new_conv = causal_conv(xi, conv_w, None if state is None else state["conv"])
    xw = xc if tp is None else tp.gather_sum(xc, -1)
    r = sigmoid(qlinear(p["g_a"], xw, "g_a", qcfg, "bsw,wv->bsv", f32, col))
    i = sigmoid(qlinear(p["g_x"], xw, "g_x", qcfg, "bsw,wv->bsv", f32, col))
    sp = softplus(lam)
    log_a = (_scalar(-LRU_C, sp) * sp) * r                   # (B, S, w)
    a = torch.exp(log_a)
    gated_x = i * xc.to(f32)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) * gated_x
    want_state = collect or state is not None
    if state is not None:
        # fold the carried state into the first recurrence element
        beta = torch.cat([beta[:, :1] + a[:, :1] * state["h"][:, None],
                          beta[:, 1:]], dim=1)
    _, hseq = assoc_scan(a, beta)
    new_state = {"h": hseq[:, -1], "conv": new_conv} if want_state else None
    out = (gelu(gate.to(f32)) * hseq).to(cdtype)
    y = qlinear(p["g_out"], out, "g_out", qcfg, "bsw,wd->bsd", cdtype, tp)
    return x + y, new_state
