"""Quantization-sensitivity harness (Tab. 1, Tab. 9).

PyTorch counterpart of `repro.core.sensitivity`: QuantConfig variants that
quantize everything except one module group (leave-one-out) or only that
group. The table drivers (`repro_torch.tables.table1_sensitivity`) run a
short QAT for each and tabulate the metrics.
"""
from __future__ import annotations

from typing import Iterator

from repro_torch.core.policy import FFN_KINDS, QuantConfig

# The module groups the paper ablates (Tab. 1 rows).
GROUPS = {
    "FFN": FFN_KINDS,
    "MHSA": ("attn_q", "attn_k", "attn_v", "attn_o"),
    "query": ("attn_q",),
    "key": ("attn_k",),
    "value": ("attn_v",),
}


def leave_one_out_configs(base: QuantConfig) -> Iterator[tuple[str, QuantConfig]]:
    """(row name, cfg) per Tab. 1: "All", then "All, except <group>"."""
    yield "All", base
    for name, kinds in GROUPS.items():
        yield f"All, except {name}", base.replace(fp_kinds=tuple(kinds))


def quantize_one_only_configs(base: QuantConfig) -> Iterator[tuple[str, QuantConfig]]:
    """(row name, cfg) per Tab. 9: "<group> only"."""
    for name, kinds in GROUPS.items():
        yield f"{name} only", base.replace(only_kinds=tuple(kinds))
