"""Shared model primitives: quantized linears and embeddings, the lm head,
norms, activations, RoPE.

PyTorch counterpart of `repro.models.common`. Every quantizable tensor lives
in a small sub-dict keyed by a NAME whose identity maps to a policy "kind"
(NAME2KIND). For QAT a linear holds {"w" (latent f32), ["b"], ["w_scale"],
["a_scale", "a_offset"]}; in serving form {"codes" | "codes4", "w_scale"
[, "b"]}: int8 codes at 5-8 bits, nibble-packed int4 pairs at <= 4 bits.

Element-wise math follows the JAX package's op order and dtypes, so bf16
values round at the same places: scalars meet bf16 tensors as bf16 0-d
tensors (a JAX weak-typed scalar is cast to the array's dtype first), and
sigmoid / gelu are written out op by op as XLA evaluates them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.policy import QuantConfig, act_spec, weight_spec
from repro_torch.core.quantizer import (QuantSpec, fake_quant, grad_scale,
                                        init_scale, pack_int4, quantize_int,
                                        scale_grad_factor, unpack_int4)
from repro_torch.kernels import ops

_SPEC8 = QuantSpec(bits=8)  # spec placeholder for serving int matmuls

# Param-name -> policy kind. Names are unique per kind across all block types.
NAME2KIND = {
    # attention
    "wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_o",
    # cross attention (VLM)
    "xq": "cross_q", "xk": "cross_k", "xv": "cross_v", "xo": "cross_o",
    # dense ffn
    "w_in": "ffn_in", "w_gate": "ffn_gate", "w_out": "ffn_out",
    # moe
    "moe_in": "moe_in", "moe_gate": "moe_gate", "moe_out": "moe_out",
    "router": "router",
    # xlstm
    "mq": "xlstm_qkv", "mk": "xlstm_qkv", "mv": "xlstm_qkv",
    "m_up": "xlstm_proj", "m_up_gate": "xlstm_proj", "m_down": "xlstm_proj",
    "m_i": "xlstm_gates", "m_f": "xlstm_gates",
    "s_z": "xlstm_proj", "s_r": "xlstm_proj",
    "s_i": "xlstm_gates", "s_f": "xlstm_gates", "s_o": "xlstm_gates",
    # rglru
    "g_in": "rglru_in", "g_gate": "rglru_in", "g_a": "rglru_in",
    "g_x": "rglru_in", "g_out": "rglru_out",
    # edges
    "embed": "embed", "lm_head": "lm_head", "frontend": "frontend",
}


def kind_of(name: str) -> str:
    return NAME2KIND[name]


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor of `like`'s dtype: JAX casts a Python scalar to the
    array's dtype before the op; torch would compute in f32 and round once."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Int-matmul dispatch (kernels/quant_matmul via kernels/ops)
# ---------------------------------------------------------------------------

# 2D-contraction einsums the serving matmul covers. Value = number of
# LEADING w axes that are contracted (the 2D reshape's K side).
FUSED_EQS = {
    "bsd,df->bsf": 1,   # ffn in/gate
    "bsf,fd->bsd": 1,   # ffn out
    "bsd,dhk->bshk": 1,  # attention q/k/v (heads on the N side)
    "bshk,hkd->bsd": 2,  # attention o (heads on the K side)
    "bsd,dv->bsv": 1,   # lm head
    # xlstm / rglru projections (same 2D-contraction family)
    "bsd,du->bsu": 1, "bsu,ud->bsd": 1, "bsu,uh->bsh": 1,
    "bsu,uhd->bshd": 1,
    "bsd,dw->bsw": 1, "bsw,wv->bsv": 1, "bsw,wd->bsd": 1,
}

# MoE batched expert einsums: the LEADING w axis is the expert batch axis
# (the batched kernel's expert grid axis), then one contracted axis. The
# router ("td,de->te") is in neither table: it stays on the f32 einsum, which
# keeps its top-k decisions off the kernels.
FUSED_BATCHED_EQS = ("gecd,edf->gecf", "gecf,efd->gecd")

# Int4 serving codes are nibble-packed along the matmul contraction axis,
# counted from the END (the JAX package stacks layers on a leading axis).
# The embedding is gathered, not contracted: it packs along d_model (-1) so
# each vocab row stays a contiguous run of bytes.
_PACK_AXIS = dict.fromkeys(
    ("wq", "wk", "wv", "xq", "xk", "xv", "mq", "mk", "mv"), -3)
_PACK_AXIS["embed"] = -1


def pack_axis_of(name: str) -> int:
    return _PACK_AXIS.get(name, -2)


def _use_fused(qcfg: QuantConfig, x: torch.Tensor) -> bool:
    """The kernel route ("auto"/"on") or the unfused composition ("off").

    On the kernel route a CUDA tensor launches the kernel and a CPU tensor
    takes its plain version; "on" refuses a tensor that is not on CUDA.
    """
    if qcfg.fused_matmul == "off":
        return False
    if qcfg.fused_matmul == "on" and x.device.type != "cuda":
        raise ValueError("fused_matmul='on' needs CUDA tensors (there is no "
                         f"kernel off the GPU); got {x.device}")
    return True


def _w_scale_side(scale_shape, w_shape, n_k: int):
    """Which side of the 2D reshape a weight scale's groups lie on: "n"
    (per-tensor, or 1s on every contracted axis), "k" (1s on every output
    axis — per-head wo/xo under MDQ), or None (groups straddle both sides)."""
    if len(scale_shape) == 0:
        return "n"
    if len(scale_shape) != len(w_shape):
        return None
    if any(s not in (1, t) for s, t in zip(scale_shape, w_shape)):
        return None
    if all(s == 1 for s in scale_shape[:n_k]):
        return "n"
    if all(s == 1 for s in scale_shape[n_k:]):
        return "k"
    return None


def _cols_shape_ok(scale_shape, w_shape, n_k: int) -> bool:
    """True when the scale's groups lie on the N side of the 2D reshape —
    the only scales the serving int(4)_matmul folds (one per column)."""
    return _w_scale_side(scale_shape, w_shape, n_k) == "n"


def _scale_cols(scale: torch.Tensor, w_shape, n_k: int) -> torch.Tensor:
    """Differentiable (N,) per-column expansion of a broadcastable N-side
    scale: the scale cotangent group-sums back to the stored shape through
    autograd, so the kernel only ever sees per-column scales."""
    tgt = (1,) * n_k + tuple(w_shape[n_k:])
    if scale.dim() == 0:
        scale = scale.reshape((1,) * len(w_shape))
    return torch.broadcast_to(scale, tgt).reshape(-1)


def _scale_rows(scale: torch.Tensor, w_shape, n_k: int) -> torch.Tensor:
    """Differentiable (K,) per-row expansion of a K-side scale (per-head
    wo/xo): the kernel's per-row scale gradient group-sums back to the
    stored per-head shape, e.g. wo's (h, 1, 1)."""
    tgt = tuple(w_shape[:n_k]) + (1,) * (len(w_shape) - n_k)
    return torch.broadcast_to(scale, tgt).reshape(-1)


def _fused_eligible(qcfg: QuantConfig, aspec, wspec, eq: str, p: dict,
                    w: torch.Tensor, x: torch.Tensor) -> bool:
    """A latent linear takes the fused QAT route: a covered einsum, both
    quantizers present and not 1-bit (sign_ste differs from round/clip),
    and a weight scale whose groups lie on one side of the 2D reshape."""
    if eq not in FUSED_EQS or aspec is None or wspec is None:
        return False
    if "a_scale" not in p or aspec.bits == 1 or wspec.bits == 1:
        return False
    if _w_scale_side(tuple(p["w_scale"].shape), tuple(w.shape),
                     FUSED_EQS[eq]) is None:
        return False
    return _use_fused(qcfg, x)


def _fused_qat_linear(p: dict, x: torch.Tensor, aspec, wspec, n_k: int, *,
                      cotangent_rounding: bool = True) -> torch.Tensor:
    """One QAT linear through `ops.fused_qat_matmul` -> f32.

    grad_scale (the module-wise g factor, Sec. 4.4.1) is applied here,
    outside the autograd Function, exactly as `fake_quant` does, so the five
    gradients match the unfused composition's autograd. N-side scales fold
    to a (N,) column vector, K-side per-head scales (wo/xo) to a (K,) row
    vector.
    """
    w = p["w"]
    k = math.prod(w.shape[:n_k])
    n = w.numel() // k
    ref = w.detach()
    g_w = scale_grad_factor(wspec, ref, tuple(p["w_scale"].shape))
    s_w = grad_scale(p["w_scale"], g_w)
    side = _w_scale_side(tuple(p["w_scale"].shape), tuple(w.shape), n_k)
    if side == "k":
        ws_vec = _scale_rows(s_w, w.shape, n_k)
    else:
        ws_vec = _scale_cols(s_w, w.shape, n_k)
    g_a = scale_grad_factor(aspec, ref, ())
    s_a = grad_scale(p["a_scale"], g_a)
    if "a_offset" in p:
        b_a = grad_scale(p["a_offset"], g_a)
    else:
        b_a = torch.zeros((), dtype=torch.float32, device=x.device)
    lead = tuple(x.shape[:x.dim() - n_k])
    x2 = x.reshape(lead + (k,))
    y = ops.fused_qat_matmul(x2, w.reshape(k, n), s_a, b_a, ws_vec, aspec,
                             wspec, cotangent_rounding=cotangent_rounding,
                             w_scale_axis=side)
    return y.reshape(lead + tuple(w.shape[n_k:]))


def _fused_eligible_batched(qcfg: QuantConfig, aspec, wspec, eq: str,
                            p: dict, w: torch.Tensor, x: torch.Tensor) -> bool:
    """A latent expert weight (E, K, N) takes the batched kernels: a covered
    einsum, both quantizers present and not 1-bit, and a per-tensor or
    N-side per-expert scale ((E,1,1), (1,1,N), (E,1,N)); K-side expert
    groups take the unfused composition."""
    if eq not in FUSED_BATCHED_EQS or aspec is None or wspec is None:
        return False
    if "a_scale" not in p or aspec.bits == 1 or wspec.bits == 1:
        return False
    ss = tuple(p["w_scale"].shape)
    if ss and not (len(ss) == 3 and ss[1] == 1
                   and all(s in (1, t) for s, t in zip(ss, w.shape))):
        return False
    return _use_fused(qcfg, x)


def _fused_qat_linear_batched(p: dict, x: torch.Tensor, aspec, wspec, *,
                              cotangent_rounding: bool = True) -> torch.Tensor:
    """Batched per-expert QAT matmul (MoE): x (g, E, c, K) @ w (E, K, N)
    -> (g, E, c, N) f32 through `ops.fused_qat_matmul_batched`.

    The expert axis leads the kernels' grid; the per-expert weight scales
    expand to (E, N) columns and the scalar activation quantizer broadcasts
    to (E,), both by plain tensor ops, so autograd sums their cotangents
    back to the stored shapes, as in the 2D path.
    """
    w = p["w"]
    e, k, n = w.shape
    ref = w.detach()
    g_w = scale_grad_factor(wspec, ref, tuple(p["w_scale"].shape))
    s_w = grad_scale(p["w_scale"], g_w)
    s_w3 = s_w.reshape(1, 1, 1) if s_w.dim() == 0 else s_w
    ws_en = torch.broadcast_to(s_w3, (e, 1, n)).reshape(e, n)
    g_a = scale_grad_factor(aspec, ref, ())
    s_a = torch.broadcast_to(grad_scale(p["a_scale"], g_a), (e,))
    if "a_offset" in p:
        b_a = torch.broadcast_to(grad_scale(p["a_offset"], g_a), (e,))
    else:
        b_a = torch.zeros((e,), dtype=torch.float32, device=x.device)
    g, _, c, _ = x.shape
    x3 = x.transpose(0, 1).reshape(e, g * c, k)
    y = ops.fused_qat_matmul_batched(x3, w, s_a, b_a, ws_en, aspec, wspec,
                                     cotangent_rounding=cotangent_rounding)
    return y.reshape(e, g, c, n).transpose(0, 1)


ROW_BLOCK = 128


def _row_matmul(x2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x2 (M, K) @ w2 (K, N) in blocks of ROW_BLOCK rows (the last one
    zero-padded): the library sees one shape whatever M is, so a row's sum
    order, and its bits, do not depend on how many rows share the call —
    the engine's streams equal single-request greedy_generate's."""
    m = x2.shape[0]
    pad = (-m) % ROW_BLOCK
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))])
    out = torch.cat([torch.matmul(blk, w2) for blk in x2.split(ROW_BLOCK)])
    return out[:m]


def _einsum(eq: str, x: torch.Tensor, w: torch.Tensor, out_dtype=None, *,
            row_blocks: bool = True):
    """jnp.einsum over operands of one dtype: with out_dtype (JAX's
    preferred_element_type) the products are summed in that dtype; bf16
    operands are exact in f32, so upcasting them first is the same sum.
    The 2D contractions of FUSED_EQS run through `_row_matmul` for serving
    (row_blocks); training contracts latent weights in one product, so that
    a weight's gradient is one f32 sum rounded once (a bf16 gradient summed
    over row blocks would round at every block)."""
    if out_dtype is not None:
        x, w = x.to(out_dtype), w.to(out_dtype)
    n_k = FUSED_EQS.get(eq)
    if n_k is None:
        return torch.einsum(eq, x, w)
    k = math.prod(w.shape[:n_k])
    lead = tuple(x.shape[:x.dim() - n_k])
    x2, w2 = x.reshape(-1, k), w.reshape(k, -1)
    y = _row_matmul(x2, w2) if row_blocks else torch.matmul(x2, w2)
    return y.reshape(lead + tuple(w.shape[n_k:]))


def _serving_linear(p: dict, x: torch.Tensor, name: str, qcfg: QuantConfig,
                    eq: str, cdtype, out_dtype=None) -> torch.Tensor:
    """Serving linear over int codes: the int(4)_matmul kernel route when
    the shape is covered, dequantize + einsum fallback otherwise.

    The two round differently, as in the JAX package: the kernel route
    dequantizes bf16(f32(code) * max(f32 scale, 1e-9)); the fallback
    multiplies bf16(code) * bf16(scale) with no floor.
    """
    kind = kind_of(name)
    wspec = weight_spec(qcfg, kind) or _SPEC8
    packed = "codes4" in p
    codes = p["codes4"] if packed else p["codes"]
    n_k = FUSED_EQS.get(eq)
    orig_shape = list(codes.shape)
    ax = pack_axis_of(name) % len(orig_shape)
    if packed:
        orig_shape[ax] *= 2
    orig_shape = tuple(orig_shape)
    fused = (n_k is not None and _use_fused(qcfg, x)
             and (not packed or ax < n_k)
             and _cols_shape_ok(tuple(p["w_scale"].shape), orig_shape, n_k))
    if fused:
        k = math.prod(orig_shape[:n_k])
        n = codes.numel() // (k // 2 if packed else k)
        cols = _scale_cols(p["w_scale"], orig_shape, n_k)
        lead = tuple(x.shape[:x.dim() - n_k])
        x2 = x.reshape(lead + (k,)).to(cdtype)
        codes2 = codes.reshape((k // 2 if packed else k, n))
        y = ops.int_matmul(x2, codes2, cols, wspec, packed=packed,
                           out_dtype=torch.float32)
        y = y.reshape(lead + tuple(orig_shape[n_k:]))
        y = y.to(out_dtype or cdtype)
    else:
        full = unpack_int4(codes, ax) if packed else codes
        w = full.to(cdtype) * p["w_scale"].to(cdtype)
        y = _einsum(eq, x.to(cdtype), w, out_dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Quantized linear
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, name: str, qcfg: QuantConfig,
                shape: tuple, *, std: float, group_axes: tuple = (),
                bias_shape: Optional[tuple] = None, device=None) -> dict:
    """One (possibly quantized) linear's latent parameter sub-dict: a
    normal f32 weight with standard deviation `std`, a zero bias, the LSQ
    scale init per group, activation scale 1 and offset 0."""
    kind = kind_of(name)
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device) * std
    p = {"w": w}
    if bias_shape is not None:
        p["b"] = torch.zeros(bias_shape, dtype=torch.float32, device=device)
    wspec = weight_spec(qcfg, kind)
    if wspec is not None:
        ga = group_axes if wspec.granularity != "per_tensor" else ()
        p["w_scale"] = init_scale(w, wspec, ga)
    aspec = act_spec(qcfg, kind)
    if aspec is not None:
        p["a_scale"] = torch.ones((), dtype=torch.float32, device=device)
        if aspec.offset:
            p["a_offset"] = torch.zeros((), dtype=torch.float32, device=device)
    return p


def qlinear(p: dict, x: torch.Tensor, name: str, qcfg: QuantConfig, eq: str,
            cdtype=torch.bfloat16) -> torch.Tensor:
    """Apply a quantized einsum-linear.

    Int codes (serving) go through `_serving_linear`. A latent QAT weight
    takes the batched expert kernels when `_fused_eligible_batched` (the
    MoE expert einsums), the fused QAT kernels when `_fused_eligible`
    (every 2D contraction of FUSED_EQS with N- or K-side scales), else the
    unfused composition: fake-quant the activations in f32 (g from the
    weight) and the weight, and contract in the compute dtype.
    """
    if "codes" in p or "codes4" in p:
        return _serving_linear(p, x, name, qcfg, eq, cdtype)
    kind = kind_of(name)
    w = p["w"]
    aspec = act_spec(qcfg, kind)
    wspec = weight_spec(qcfg, kind)
    if _fused_eligible_batched(qcfg, aspec, wspec, eq, p, w, x):
        y = _fused_qat_linear_batched(p, x, aspec, wspec).to(cdtype)
    elif _fused_eligible(qcfg, aspec, wspec, eq, p, w, x):
        y = _fused_qat_linear(p, x, aspec, wspec, FUSED_EQS[eq]).to(cdtype)
    else:
        latent = w.dtype == torch.float32  # serving keeps bf16 weights
        if aspec is not None:
            x = fake_quant(x.to(torch.float32), p["a_scale"], aspec,
                           offset=p.get("a_offset"), grad_scale_ref=w)
        if wspec is not None:
            w = fake_quant(w, p["w_scale"], wspec)
        y = _einsum(eq, x.to(cdtype), w.to(cdtype), row_blocks=not latent)
    if "b" in p:
        y = y + p["b"].to(cdtype)
    return y


def quantized_weight(p: dict, name: str, qcfg: QuantConfig) -> torch.Tensor:
    """The dequantized (f32 for int codes) or fake-quantized latent weight."""
    if "codes4" in p:
        codes = unpack_int4(p["codes4"], pack_axis_of(name))
        return codes.to(torch.float32) * p["w_scale"].to(torch.float32)
    if "codes" in p:
        return p["codes"].to(torch.float32) * p["w_scale"].to(torch.float32)
    wspec = weight_spec(qcfg, kind_of(name))
    if wspec is None:
        return p["w"]
    return fake_quant(p["w"], p["w_scale"], wspec)


def convert_to_serving(params, qcfg: QuantConfig):
    """Freeze QAT weights into int code + scale storage for serving.

    Every quantized linear's latent f32 "w" becomes int codes: one byte an
    element at 5-8 bits ("codes"), two nibble-packed codes a byte at <= 4
    bits ("codes4") — along the matmul contraction axis for linears and
    along d_model for the gathered embedding. Activation quantizer params of
    converted linears are dropped; every other f32 tensor is cast to bf16.
    Same walk as `repro.models.common.convert_to_serving`, over the port's
    per-layer list.
    """
    def walk(node):
        if isinstance(node, dict):
            out = {}
            for name, child in node.items():
                if (isinstance(child, dict) and "w" in child
                        and "w_scale" in child and name in NAME2KIND
                        and weight_spec(qcfg, NAME2KIND[name]) is not None):
                    out[name] = _convert_linear(name, child, qcfg)
                else:
                    out[name] = walk(child)
            return out
        if isinstance(node, (tuple, list)):
            return type(node)(walk(c) for c in node)
        if isinstance(node, torch.Tensor) and node.dtype == torch.float32:
            return node.to(torch.bfloat16)
        return node

    return walk(params)


def _convert_linear(name: str, child: dict, qcfg: QuantConfig) -> dict:
    spec = weight_spec(qcfg, NAME2KIND[name])
    w, sc = child["w"], child["w_scale"]
    codes = quantize_int(w, sc, spec)
    ax = pack_axis_of(name)
    if spec.bits <= 4 and w.shape[ax] % 2 == 0:
        new = {"codes4": pack_int4(codes, ax % w.dim()), "w_scale": sc}
    else:
        new = {"codes": codes, "w_scale": sc}
    if "b" in child:
        new["b"] = child["b"].to(torch.bfloat16)
    return new


# ---------------------------------------------------------------------------
# Embedding and lm head
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, qcfg: QuantConfig, vocab_padded: int,
               d_model: int, device=None) -> dict:
    w = torch.randn((vocab_padded, d_model), generator=gen,
                    dtype=torch.float32, device=device) * 0.02
    p = {"w": w}
    spec = weight_spec(qcfg, "embed")
    if spec is not None:
        p["w_scale"] = init_scale(w, spec)
    return p


def embed_lookup(p: dict, tokens: torch.Tensor, qcfg: QuantConfig,
                 cdtype=torch.bfloat16) -> torch.Tensor:
    if "codes4" in p:
        # gather the packed (V, d/2) byte rows, then unpack + dequantize the
        # gathered rows only: reads stay 0.5 byte/element
        rows = p["codes4"][tokens]
        return unpack_int4(rows, -1).to(cdtype) * p["w_scale"].to(cdtype)
    if "codes" in p:
        return p["codes"][tokens].to(cdtype) * p["w_scale"].to(cdtype)
    w = quantized_weight(p, "embed", qcfg)
    return w.to(cdtype)[tokens]


def lm_head_init(gen: torch.Generator, qcfg: QuantConfig, d_model: int,
                 vocab_padded: int, device=None) -> dict:
    return linear_init(gen, "lm_head", qcfg, (d_model, vocab_padded),
                       std=d_model ** -0.5, device=device)


def tied_head_act_init(qcfg: QuantConfig, device=None,
                       dtype=torch.float32) -> dict:
    """Activation quantizer params of a tied lm_head (it has no weight of
    its own): f32 for training, bf16 as serving conversion leaves them."""
    p = {}
    aspec = act_spec(qcfg, "lm_head")
    if aspec is not None:
        p["a_scale"] = torch.ones((), dtype=dtype, device=device)
        if aspec.offset:
            p["a_offset"] = torch.zeros((), dtype=dtype, device=device)
    return p


def lm_head_apply(p: dict, x: torch.Tensor, qcfg: QuantConfig, vocab_size: int,
                  vocab_padded: int, final_softcap: float = 0.0,
                  tied_embed: Optional[dict] = None) -> torch.Tensor:
    """Project to (padded) vocab logits in f32; mask padding columns.

    The untied latent head, and the tied latent head (the transposed
    embedding as an N-side per-tensor weight), take the fused QAT kernels
    with f32 cotangents (the unfused head einsum sums in f32, so its
    autograd never rounds dY to bf16). The untied serving head (int codes)
    goes through `_serving_linear`. Otherwise the unfused composition:
    the activation quantizer with g from the latent weight (or, in
    serving, from the dequantized embedding), and a bf16 einsum summed in
    f32.
    """
    if tied_embed is not None:
        aspec = act_spec(qcfg, "lm_head")
        wspec = weight_spec(qcfg, "embed")
        if ("w" in tied_embed and "w_scale" in tied_embed
                and tied_embed["w_scale"].dim() == 0
                and "a_scale" in p and aspec is not None and wspec is not None
                and aspec.bits != 1 and wspec.bits != 1
                and _use_fused(qcfg, x)):
            pseudo = {"w": tied_embed["w"].T,  # (d, V) view of the latent table
                      "w_scale": tied_embed["w_scale"],
                      "a_scale": p["a_scale"]}
            if "a_offset" in p:
                pseudo["a_offset"] = p["a_offset"]
            logits = _fused_qat_linear(pseudo, x, aspec, wspec, 1,
                                       cotangent_rounding=False)
        else:
            w_latent = tied_embed.get("w")
            w = quantized_weight(tied_embed, "embed", qcfg).T  # (d, V)
            if aspec is not None and "a_scale" in p:
                ref = w_latent.T if w_latent is not None else w
                x = fake_quant(x.to(torch.float32), p["a_scale"], aspec,
                               offset=p.get("a_offset"), grad_scale_ref=ref)
            logits = _einsum("bsd,dv->bsv", x.to(torch.bfloat16),
                             w.to(torch.bfloat16), torch.float32,
                             row_blocks=w_latent is None)
    elif "codes" in p or "codes4" in p:
        logits = _serving_linear(p, x, "lm_head", qcfg, "bsd,dv->bsv",
                                 torch.bfloat16, out_dtype=torch.float32)
    else:
        w = p["w"]
        aspec = act_spec(qcfg, "lm_head")
        wspec = weight_spec(qcfg, "lm_head")
        if _fused_eligible(qcfg, aspec, wspec, "bsd,dv->bsv", p, w, x):
            logits = _fused_qat_linear(p, x, aspec, wspec, 1,
                                       cotangent_rounding=False)
        else:
            if aspec is not None:
                x = fake_quant(x.to(torch.float32), p["a_scale"], aspec,
                               offset=p.get("a_offset"), grad_scale_ref=w)
            latent = w.dtype == torch.float32  # serving keeps bf16 weights
            if wspec is not None:
                w = fake_quant(w, p["w_scale"], wspec)
            logits = _einsum("bsd,dv->bsv", x.to(torch.bfloat16),
                             w.to(torch.bfloat16), torch.float32,
                             row_blocks=not latent)
    if final_softcap > 0.0:
        logits = final_softcap * torch.tanh(logits / final_softcap)
    if vocab_padded != vocab_size:
        pad_mask = torch.arange(vocab_padded, device=logits.device) < vocab_size
        logits = torch.where(pad_mask, logits, -1e9)
    return logits


# ---------------------------------------------------------------------------
# Norms / activations / RoPE
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str, device=None,
              dtype=torch.float32) -> dict:
    p = {"g": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis, summed in f64 and rounded once to f32: the
    f64 sum is exact far below f32's ulp whichever order the reduction
    kernel takes, and that order depends on how many rows the call has."""
    return torch.mean(x.to(torch.float64), dim=-1, keepdim=True).to(torch.float32)


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = _row_mean(xf)
        var = _row_mean(torch.square(xf - mu))
        out = (xf - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]
    else:  # rmsnorm
        ms = _row_mean(xf * xf)
        out = xf * torch.rsqrt(ms + eps) * p["g"]
    return out.to(x.dtype)


class _Sigmoid(torch.autograd.Function):
    """1 / (1 + exp(-x)), each op rounded in x's dtype (XLA's logistic),
    with JAX's logistic derivative g * (s * (1 - s)): autograd through the
    written-out form would give 0 * inf = NaN where exp(-x) overflows."""

    @staticmethod
    def forward(ctx, x):
        one = _scalar(1.0, x)
        s = one / (one + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (_scalar(1.0, s) - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), op by op in x's dtype."""
    c = math.sqrt(2 / math.pi)
    inner = _scalar(c, x) * (x + _scalar(0.044715, x) * (x * x * x))
    return x * (_scalar(0.5, x) * (_scalar(1.0, x) + torch.tanh(inner)))


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        return gelu(x)
    return silu(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freq = torch.exp(-log_theta * torch.arange(0, half, dtype=torch.float32,
                                               device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # (..., seq, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
