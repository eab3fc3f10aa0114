"""Roofline analysis from a counted step (`launch.cost`).

PyTorch counterpart of `repro.launch.roofline`. Terms (seconds, per step,
per card; the counted program is one rank's, so its FLOPs, bytes and
collective bytes are already per card):

  compute    = FLOPs / PEAK_FLOPS        (989 TFLOP/s dense bf16)
  memory     = bytes / HBM_BW            (3.35 TB/s)
  collective = collective_bytes / LINK_BW (50 GB/s: output bytes of each
               collective, a ~1-2x proxy for the on-wire volume depending
               on the algorithm, as in the reference)

The constants are the NVIDIA H100 SXM data sheet's (dense rates, no
sparsity, at the full 700 W power limit). LINK_BW is one 400 Gb/s network
card per GPU: the production meshes (256 and 512 ranks) span many 8-card
nodes, so a collective over them crosses the network, not only NVLink.

MODEL_FLOPS = 6*N*D (training) or 2*N*D (inference) with N the active
parameters; MODEL_FLOPS / (FLOPs * chips) exposes remat and redundant work
(each rank computing a layer whole where tensor parallelism would split
it).

The reference parses collectives out of HLO text (`parse_collectives`);
an eager program has no HLO, so `launch.cost.CostMode` records each
collective of `dist.spmd` as it runs instead.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig

PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s, H100 SXM
F32_FLOPS = 67e12          # f32 FLOP/s outside the tensor cores, H100 SXM
HBM_BW = 3.35e12           # HBM3 bytes/s, H100 SXM
HBM_BYTES = 80e9           # device memory, H100 SXM
LINK_BW = 50e9             # bytes/s a card: one 400 Gb/s network card


def model_flops_per_step(cfg: ArchConfig, tokens: int, *, train: bool) -> float:
    """6*N*D (training) / 2*N*D (inference fwd) with N = active params."""
    n_active = cfg.param_count(active_only=True)
    mult = 6.0 if train else 2.0
    return mult * n_active * tokens


def roofline_from_cost(cost: dict, *, chips: int,
                       model_flops: Optional[float] = None) -> dict:
    """Terms from a `launch.cost.CostMode.result()`."""
    return roofline(cost["flops"], cost["bytes"], cost["collective_bytes"],
                    chips=chips, model_flops=model_flops)


def roofline(flops: float, bytes_acc: float, coll_bytes: float, *, chips: int,
             model_flops: Optional[float] = None) -> dict:
    """The three terms, the dominant one, and (with model_flops) the useful
    FLOPs ratio and roofline fraction; the keys are the reference's
    ("hlo_flops_per_chip" holds the counted FLOPs)."""
    compute_s = flops / PEAK_FLOPS
    memory_s = bytes_acc / HBM_BW
    coll_s = coll_bytes / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(compute_s, memory_s, coll_s)
    out = {
        **terms,
        "dominant": dominant,
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_acc,
        "collective_bytes_per_chip": coll_bytes,
        "chips": chips,
    }
    if model_flops:
        out["model_flops"] = model_flops
        out["useful_flops_ratio"] = model_flops / max(flops * chips, 1.0)
        # roofline fraction: useful-FLOPs time vs. the binding term
        ideal_s = model_flops / (chips * PEAK_FLOPS)
        out["roofline_fraction"] = ideal_s / max(bound_s, 1e-30)
    return out
