"""Carry weights and caches from the JAX package into the port (and back).

The JAX package stacks the layers of each pattern position along a leading
axis so `lax.scan` can walk them ("groups", n_groups x period layers) and
unrolls the remainder ("tail"). The port keeps a plain per-layer list:
layer i is group position i % period of group i // period, or tail entry
i - n_groups * period. Trees cross as numpy (`jax.tree.map(np.asarray,
tree)` on the JAX side); nothing here imports JAX. bf16 arrays (numpy dtype
named "bfloat16") are reinterpreted bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.oscillation import OscState
from repro_torch.kernels.ops import resolve_device
from repro_torch.models.attention import KVCache
from repro_torch.models.model import jax_leaf_groups, quant_leaf_paths
from repro_torch.train.sentinel import SentinelState


def to_torch(a, device) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bf16 becomes f32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def _layer_paths(cfg: ArchConfig):
    """(key, position, group index or None) of layer i in the JAX tree."""
    period, n_groups = cfg.period, cfg.n_groups
    for i in range(cfg.n_layers):
        if i < n_groups * period:
            yield "groups", i % period, i // period
        else:
            yield "tail", i - n_groups * period, None


def _convert(node, device, index=None):
    if isinstance(node, dict):
        out = {k: _convert(v, device, index) for k, v in node.items()}
        sc = out.get("w_scale")
        if sc is not None and sc.numel() == 1 and all(s == 1 for s in sc.shape):
            # per-tensor scale of a stacked layer, (1, 1[, 1]) after the slice
            out["w_scale"] = sc.reshape(())
        return out
    if node is None:
        return None
    a = np.asarray(node)
    return to_torch(a if index is None else a[index], device)


def params_from_jax(np_tree: dict, cfg: ArchConfig, device=None) -> dict:
    """JAX param tree (numpy leaves; latent QAT or already serving) -> the
    port's params: the same leaves per layer under params["layers"]."""
    device = resolve_device(device)
    params = {k: _convert(v, device) for k, v in np_tree.items()
              if k not in ("groups", "tail")}
    params["layers"] = [_convert(np_tree[key][pos], device, g)
                        for key, pos, g in _layer_paths(cfg)]
    return params


def tree_to_jax_layout(tree: dict, cfg: ArchConfig) -> dict:
    """The port's per-layer tree (params, or grads / moments shaped like
    them) -> numpy in the JAX package's layout: layer i of each pattern
    position stacked along a leading axis under "groups", the remainder
    under "tail"; bf16 as f32. For comparing trees leaf by leaf."""
    out = {k: _tree_numpy(v) for k, v in tree.items() if k != "layers"}
    layers = [_tree_numpy(lay) for lay in tree["layers"]]
    period, n_groups = cfg.period, cfg.n_groups
    if n_groups:
        out["groups"] = tuple(
            _stack([layers[g * period + pos] for g in range(n_groups)])
            for pos in range(period))
    if cfg.n_tail:
        out["tail"] = tuple(layers[n_groups * period:])
    return out


def _tree_numpy(node):
    if isinstance(node, dict):
        return {k: _tree_numpy(v) for k, v in node.items()}
    return to_numpy(node)


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def _osc_slices(params: dict, qcfg, cfg: ArchConfig) -> list:
    """For each of the port's quant leaves (`quant_leaf_paths` order): the
    index of the reference's oscillation-state entry that holds it, and
    its layer's index in that entry's stacked leading axis (None where
    the reference does not stack the leaf)."""
    paths = [p for p, _, _, _ in quant_leaf_paths(params, qcfg)]
    out = [None] * len(paths)
    for j, (key, members) in enumerate(jax_leaf_groups(paths, cfg)):
        for g, idx in enumerate(members):
            out[idx] = (j, g if key[0] == "groups" else None)
    return out


def osc_from_jax(np_osc: tuple, params: dict, qcfg, cfg: ArchConfig,
                 device=None) -> tuple:
    """The reference's oscillation state (a tuple of OscState, numpy, one
    per stacked or unstacked quant leaf) -> the port's, one per layer's
    leaf in `quant_leaf_paths` order."""
    device = resolve_device(device)
    out = []
    for j, g in _osc_slices(params, qcfg, cfg):
        st = np_osc[j]
        out.append(OscState(*(to_torch(np.asarray(v) if g is None
                                       else np.asarray(v)[g], device)
                              for v in st)))
    return tuple(out)


def osc_to_jax(osc: tuple, params: dict, qcfg, cfg: ArchConfig) -> tuple:
    """The port's oscillation state -> numpy in the reference's layout
    (stacked layers of a pattern position under one entry)."""
    slices = _osc_slices(params, qcfg, cfg)
    n = max(j for j, _ in slices) + 1 if slices else 0
    parts = [[] for _ in range(n)]
    for st, (j, g) in zip(osc, slices):
        parts[j].append((g, tuple(to_numpy(v) for v in st)))
    res = []
    for members in parts:
        if members[0][0] is None:
            res.append(OscState(*members[0][1]))
        else:
            members.sort(key=lambda m: m[0])
            res.append(OscState(*(np.stack([m[1][f] for m in members])
                                  for f in range(3))))
    return tuple(res)


def state_from_jax(np_state: dict, cfg: ArchConfig, device=None,
                   qcfg=None) -> dict:
    """The JAX package's train state (numpy leaves) -> the port's: params,
    mu and nu per layer, step as an int32 CPU tensor, the oscillation
    state per layer (`qcfg` names the quantized leaves; needed only when
    the JAX state carries one), and the sentinel state when the JAX state
    carries one."""
    device = resolve_device(device)
    state = {k: params_from_jax(np_state[k], cfg, device)
             for k in ("params", "mu", "nu")}
    state["step"] = torch.tensor(int(np.asarray(np_state["step"])),
                                 dtype=torch.int32)
    osc = np_state.get("osc", ())
    if len(osc) and qcfg is None:
        raise ValueError("state_from_jax: the state tracks oscillation; "
                         "pass qcfg to place it")
    state["osc"] = (osc_from_jax(osc, state["params"], qcfg, cfg, device)
                    if len(osc) else ())
    state["err"] = ()
    sent = np_state.get("sent", ())
    state["sent"] = (SentinelState(*(to_torch(np.asarray(v), device)
                                     for v in sent)) if len(sent) else ())
    return state


def cache_from_jax(np_cache: dict, cfg: ArchConfig, device=None) -> dict:
    """JAX decode cache (numpy leaves; KVCache tuples) -> the port's cache."""
    device = resolve_device(device)
    layers = []
    for key, pos, g in _layer_paths(cfg):
        kv = np_cache[key][pos]["kv"]
        layers.append({"kv": KVCache(*(
            None if leaf is None else to_torch(np.asarray(leaf) if g is None
                                               else np.asarray(leaf)[g], device)
            for leaf in kv))})
    return {"layers": layers}


def cache_to_numpy(cache: dict) -> list:
    """The port's cache -> per layer (k, v, k_scale, v_scale, pos) numpy
    tuples (None for the fp cache's scales); bf16 as f32."""
    return [tuple(None if t is None else to_numpy(t) for t in lay["kv"])
            for lay in cache["layers"]]
