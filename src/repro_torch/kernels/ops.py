"""Dispatch over the serving kernels, and the device rule of the package.

`int_matmul` is the one entry the model uses for an int-coded linear: it
reshapes an arbitrary-rank x to 2D, expands the weight scale to one value
per output column, and calls `quant_matmul.int_matmul` or `int4_matmul`,
which launch the CUDA kernel for a CUDA tensor and take the plain version
for a CPU tensor. Edges are masked inside the kernel, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantizer import QuantSpec
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import quant_matmul as _qmm

KERNEL_WRAPPERS = {
    "int_matmul": _qmm.int_matmul,
    "int4_matmul": _qmm.int4_matmul,
    "pooled_decode_attention": _da.pooled_decode_attention,
}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (or left to default) and absent;
    there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
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
