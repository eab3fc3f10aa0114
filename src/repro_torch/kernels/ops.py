"""Dispatch over the kernels, and the device rule of the package.

`int_matmul` is the one entry the model uses for an int-coded linear: it
reshapes an arbitrary-rank x to 2D, expands the weight scale to one value
per output column, and calls `quant_matmul.int_matmul` or `int4_matmul`,
which launch the CUDA kernel for a CUDA tensor and take the plain version
for a CPU tensor. Edges are masked inside the kernel, so nothing is padded.

`fused_qat_matmul` is the differentiable QAT entry (the JAX package's
`_fused_qmm2d` custom_vjp, src/repro/kernels/ops.py:143-217): a
`torch.autograd.Function` whose forward is `quant_matmul` and whose
backward is `quant_matmul_bwd` (combined, or split into dx / dw for
vocab-wide N), with the LSQ/LSQ+ gradients of all five inputs. The
module-wise gradient scale g and the group broadcast of the weight scale
stay outside the Function (in the caller), as in the reference.
`fused_qat_matmul_batched` is its per-expert counterpart for the MoE
expert einsums (the reference's `_fused_qmm3d`, ops.py:224-300), over
`quant_matmul_batched` / `quant_matmul_bwd_batched`.

`fake_quant`, `fake_quant_grouped` and `bin_stats` take tensors of any rank
to the 2D kernels `fake_quant_2d`, `fake_quant_rows` and `bin_stats_2d`
(the reference's ops.py:47-71, 303-322); no training or serving path calls
them, only the kernel benchmark (`launch/kernel_bench.py`).

The reference pads every operand to its tiles before the kernels; here the
kernels mask their edges instead, which gives the same values (padded rows
and columns contribute zeros to every output and scale sum), and the
combined-vs-split route is decided on the padded shape.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QuantSpec
from repro_torch.kernels import bin_stats as _bs
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import fake_quant as _fq
from repro_torch.kernels import quant_matmul as _qmm

KERNEL_WRAPPERS = {
    "int_matmul": _qmm.int_matmul,
    "int4_matmul": _qmm.int4_matmul,
    "pooled_decode_attention": _da.pooled_decode_attention,
    "quant_matmul": _qmm.quant_matmul,
    "quant_matmul_dx": _qmm.quant_matmul_dx,
    "quant_matmul_dw": _qmm.quant_matmul_dw,
    "quant_matmul_bwd": _qmm.quant_matmul_bwd,
    "quant_matmul_batched": _qmm.quant_matmul_batched,
    "quant_matmul_bwd_batched": _qmm.quant_matmul_bwd_batched,
    "fake_quant_2d": _fq.fake_quant_2d,
    "fake_quant_rows": _fq.fake_quant_rows,
    "bin_stats_2d": _bs.bin_stats_2d,
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or left to default) and absent;
    there is no silent fallback to the CPU. "meta" builds shape-only trees
    (init_params / init_serving_params / init_cache) for the sharding rules,
    and runs whole steps for the dry run (`launch.dryrun`): every kernel
    wrapper takes its plain version there, which gives its outputs' shapes
    and dtypes, and nothing computes. Only the dry run and the sharding
    rules ask for meta; the card's main path never takes that route."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def int_matmul(x: torch.Tensor, w_codes: torch.Tensor, w_scale,
               w_spec: QuantSpec, *, packed: bool = False,
               out_dtype=torch.float32) -> torch.Tensor:
    """Serving matmul over int-coded weights.

    packed=False: w_codes (K, N) int8 — 1 byte/weight reads.
    packed=True:  w_codes (K//2, N) int8 nibble-packed int4 pairs (see
    core.quantizer.pack_int4) — 0.5 byte/weight.
    w_scale broadcasts to (N,) per-column scales; w_spec names the code
    range (the kernel reads codes as stored, so it needs no clip).
    """
    del w_spec  # codes are already clipped to the spec's range
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = w_codes.shape[-1]
    x2 = x.reshape(-1, k)
    cols = torch.as_tensor(w_scale, dtype=torch.float32, device=x.device)
    cols = torch.broadcast_to(cols.reshape(1, -1), (1, n)).reshape(n)
    if packed:
        if w_codes.shape[0] * 2 != k:
            raise ValueError(f"packed codes {tuple(w_codes.shape)} vs K={k}")
        out = _qmm.int4_matmul(x2, w_codes, cols)
    else:
        out = _qmm.int_matmul(x2, w_codes, cols)
    return out.reshape(*lead, n).to(out_dtype)


# ---------------------------------------------------------------------------
# Fused QAT matmul (the training hot path)
# ---------------------------------------------------------------------------

class _FusedQmm2d(torch.autograd.Function):
    """y = q_a(x2) @ q_w(w2) with the reference's five cotangents.

    ws_vec is the weight scale expanded per column (N,) or per contracted
    row (K,) (`k_side`); it is reshaped to the kernels' (1, N) / (K, 1).
    dx comes back in x2's dtype, dw in w2's, the scalars in their shapes.
    """

    @staticmethod
    def forward(ctx, x2, w2, a_scale, a_offset, ws_vec, static):
        q_n_a, q_p_a, q_n_w, q_p_w, _round_cot, k_side = static
        ws2 = ws_vec.reshape(-1, 1) if k_side else ws_vec.reshape(1, -1)
        ctx.save_for_backward(x2, w2, a_scale, a_offset, ws_vec)
        ctx.static = static
        return _qmm.quant_matmul(x2, w2, a_scale, a_offset, ws2, q_n_a=q_n_a,
                                 q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)

    @staticmethod
    def backward(ctx, dy):
        x2, w2, a_scale, a_offset, ws_vec = ctx.saved_tensors
        q_n_a, q_p_a, q_n_w, q_p_w, round_cot, k_side = ctx.static
        ws2 = ws_vec.reshape(-1, 1) if k_side else ws_vec.reshape(1, -1)
        dx, dsa, dba, dw, dws = _qmm.quant_matmul_bwd(
            dy.to(torch.float32), x2, w2, a_scale, a_offset, ws2,
            q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w,
            round_cot=round_cot)
        return (dx.to(x2.dtype), dw.to(w2.dtype),
                dsa.to(a_scale.dtype).reshape(a_scale.shape),
                dba.to(a_offset.dtype).reshape(a_offset.shape),
                dws.reshape(-1).to(ws_vec.dtype), None)


def fused_qat_matmul(x, w2, a_scale, a_offset, ws_vec, a_spec: QuantSpec,
                     w_spec: QuantSpec, *, cotangent_rounding: bool = True,
                     w_scale_axis: str = "n") -> torch.Tensor:
    """Differentiable fused q(x) @ q(w) -> (..., N) f32.

    x: (..., K); w2: (K, N); a_scale / a_offset: 0-d (grad_scale'd by the
    caller); ws_vec: the weight scale per column (N,) for
    w_scale_axis="n", or per contracted row (K,) for "k" (K-side per-head
    scales), expanded from its group shape by a differentiable broadcast.
    cotangent_rounding=False keeps dY in f32 (the lm head).
    """
    if w_scale_axis not in ("n", "k"):
        raise ValueError(f"w_scale_axis must be 'n' or 'k', got {w_scale_axis!r}")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    static = (a_spec.q_n, a_spec.q_p, w_spec.q_n, w_spec.q_p,
              bool(cotangent_rounding), w_scale_axis == "k")
    y2 = _FusedQmm2d.apply(x2, w2, a_scale, a_offset, ws_vec, static)
    return y2.reshape(*lead, w2.shape[-1])


class _FusedQmm3d(torch.autograd.Function):
    """y[e] = q_a(x3[e]) @ q_w(w3[e]) with the reference's five per-expert
    cotangents. a_scale / a_offset are (E,) (broadcast from the module's
    scalar by the caller, so autograd sums the per-expert partials back);
    ws_en is (E, N). Each cotangent comes back in its primal's dtype."""

    @staticmethod
    def forward(ctx, x3, w3, a_scale, a_offset, ws_en, static):
        q_n_a, q_p_a, q_n_w, q_p_w, _round_cot = static
        e = x3.shape[0]
        ctx.save_for_backward(x3, w3, a_scale, a_offset, ws_en)
        ctx.static = static
        return _qmm.quant_matmul_batched(
            x3, w3, a_scale.reshape(e, 1), a_offset.reshape(e, 1), ws_en,
            q_n_a=q_n_a, q_p_a=q_p_a, q_n_w=q_n_w, q_p_w=q_p_w)

    @staticmethod
    def backward(ctx, dy):
        x3, w3, a_scale, a_offset, ws_en = ctx.saved_tensors
        q_n_a, q_p_a, q_n_w, q_p_w, round_cot = ctx.static
        e = x3.shape[0]
        dx, dsa, dba, dw, dws = _qmm.quant_matmul_bwd_batched(
            dy.to(torch.float32), x3, w3, a_scale.reshape(e, 1),
            a_offset.reshape(e, 1), ws_en, q_n_a=q_n_a, q_p_a=q_p_a,
            q_n_w=q_n_w, q_p_w=q_p_w, round_cot=round_cot)
        return (dx.to(x3.dtype), dw.to(w3.dtype),
                dsa.to(a_scale.dtype).reshape(a_scale.shape),
                dba.to(a_offset.dtype).reshape(a_offset.shape),
                dws.to(ws_en.dtype), None)


def fused_qat_matmul_batched(x3, w3, a_scale, a_offset, ws_en,
                             a_spec: QuantSpec, w_spec: QuantSpec, *,
                             cotangent_rounding: bool = True) -> torch.Tensor:
    """Per-expert differentiable fused matmul -> (E, M, N) f32.

    x3: (E, M, K); w3: (E, K, N); a_scale / a_offset: (E,) per-expert
    scalars (grad_scale'd and broadcast by the caller); ws_en: (E, N)
    per-expert column scales, expanded from the (E, 1, 1) group shape by a
    differentiable broadcast. cotangent_rounding=False keeps dY in f32.
    """
    static = (a_spec.q_n, a_spec.q_p, w_spec.q_n, w_spec.q_p,
              bool(cotangent_rounding))
    return _FusedQmm3d.apply(x3, w3, a_scale, a_offset, ws_en, static)


# ---------------------------------------------------------------------------
# Standalone quantizer kernels (the kernel benchmark's)
# ---------------------------------------------------------------------------

def _rows2d(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1, x.shape[-1]) if x.dim() > 1 else x.reshape(1, -1)


def fake_quant(x: torch.Tensor, scale, spec: QuantSpec,
               offset=None) -> torch.Tensor:
    """Per-tensor fake-quant of an arbitrary-rank tensor (scalar scale and
    optional scalar offset), in x's dtype."""
    out = _fq.fake_quant_2d(_rows2d(x), scale, offset, q_n=spec.q_n,
                            q_p=spec.q_p)
    return out.reshape(x.shape)


def fake_quant_grouped(x: torch.Tensor, group_scale: torch.Tensor,
                       spec: QuantSpec) -> torch.Tensor:
    """Row-grouped fake-quant: x (G, ...) with scale (G,) — per head or
    expert."""
    g = x.shape[0]
    out = _fq.fake_quant_rows(x.reshape(g, -1), group_scale.reshape(-1, 1),
                              q_n=spec.q_n, q_p=spec.q_p)
    return out.reshape(x.shape)


def bin_stats(w: torch.Tensor, scale, spec: QuantSpec) -> torch.Tensor:
    """(count, sum, sumsq) per bin, (3, n_bins) f32, for a per-tensor-scaled
    weight tensor of any rank. The reference pads rows with zeros and takes
    their count back out of bin Q_N; the kernel masks its edge instead."""
    return _bs.bin_stats_2d(_rows2d(w), scale, q_n=spec.q_n, q_p=spec.q_p)
