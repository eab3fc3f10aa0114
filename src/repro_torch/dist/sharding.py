"""Production sharding rules: FSDP + TP + EP over a (pod, data, model) mesh.

PyTorch counterpart of `repro.dist.sharding`, function for function. The
rules are name-driven and shape-checked: each quantizable linear's role
(NAME2KIND in models/common.py) picks the rule, and every axis assignment is
guarded by a divisibility check against the mesh; an axis that does not
divide replicates, so the same rules cover every (arch x mesh) cell without
per-model configuration.

Rules:
  * q/k/v projections (d, h, hd):   d -> data (FSDP), heads -> model (TP)
  * o projections   (h, hd, d):     heads -> model (row-parallel), d -> data
  * ffn in/gate     (d, f):         column-parallel  (data, model)
  * ffn out         (f, d):         row-parallel     (model, data)
  * MoE experts     (E, din, dout): experts -> model (EP) when E divides,
                                    else TP on the ffn axis within experts
  * embed           (V, d):         vocab -> model only (no FSDP d-axis)
  * lm_head         (d, V):         (data, model)
  * scales:         inherit the sharded axes of their weight where the
                    group axis matches (per-head scales shard with heads)
  * KV caches:      batch -> data axes, SEQUENCE -> model (decode-time
                    sequence sharding; attention reduces over it)

A spec is a plain tuple with one entry per axis of the array: None, an axis
name, or a tuple of axis names (one array axis split over several mesh
axes, major first). `()` replicates. The JAX package stacks the layers of a
pattern position along a leading (scan) axis that is never sharded; this
port keeps a per-layer list (`params["layers"][i]`), so a layer's spec is
the reference's stacked spec without its leading None. `no_tp` turns the
model axis into extra data parallelism (weights replicated across it).

A mesh is anything with `.shape` (an ordered axis name -> size mapping) and
`.axis_names`: the sizes-only `AxisSizes` of `launch.mesh.
make_production_mesh`, or the process-group mesh of `launch.mesh.
make_host_mesh`. `local_shard` cuts this rank's slice of a full tensor by
a spec; `spmd.gather` puts the slices back together over the process group.

The reference's `make_constrains` and `named_tree` have no counterpart: the
first gives XLA's partitioner sharding hints inside jit, the second wraps
specs into jax NamedShardings. Here the sharded runtime (`dist.spmd`)
places and gathers tensors itself.
"""
from __future__ import annotations

import math
from typing import Any, Iterator, NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.models.common import NAME2KIND

# Weight-name role sets (see models/common.py layouts).
_QKV = {"wq", "wk", "wv", "xq", "xk", "xv", "mq", "mk", "mv"}  # (d, h, hd)
_OUT_HEAD = {"wo", "xo"}                                       # (h, hd, d)
_ROW = {"w_out", "m_down", "g_out"}                            # (f, d)
_MOE = {"moe_in", "moe_gate", "moe_out"}                       # (E, din, dout)
_BASE_RANK = {**dict.fromkeys(_QKV | _OUT_HEAD | _MOE, 3)}     # default 2


class Layout(NamedTuple):
    """Where a tree's leaves live: a spec tree over a mesh with this rank's
    coordinates (`launch.mesh.HostMesh`). Checkpoints take it as
    `shardings` (a full-array checkpoint restores as this rank's slices;
    a sharded state saves as full arrays)."""
    mesh: Any
    specs: Any


class AxisSizes(NamedTuple):
    """A mesh by its sizes only (no process group): what the rules need."""
    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def _sizes(mesh) -> dict:
    return mesh.shape


def _div(dim: int, mesh, axis: str) -> bool:
    n = _sizes(mesh).get(axis, 0)
    return n > 0 and dim % n == 0


def batch_axes(mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def spec_axes(entry) -> tuple:
    """The mesh axes one spec entry names, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def weight_pspec(name: str, shape, mesh, fsdp: bool = True,
                 tp: bool = True) -> tuple:
    """Spec of one (possibly stacked) weight of a named linear."""
    shape = tuple(shape)
    base = _BASE_RANK.get(name, 2)
    lead = (None,) * (len(shape) - base)
    core = shape[-base:]

    def d(dim):  # FSDP assignment
        return "data" if fsdp and _div(dim, mesh, "data") else None

    def m(dim):  # TP assignment
        return "model" if tp and _div(dim, mesh, "model") else None

    if name == "embed":
        return (m(core[0]), d(core[1]))
    if name in _QKV:
        return (*lead, d(core[0]), m(core[1]), None)
    if name in _OUT_HEAD:
        return (*lead, m(core[0]), None, d(core[2]))
    if name in _MOE:
        e, din, dout = core
        if tp and _div(e, mesh, "model"):
            return (*lead, "model", d(din), None)       # expert parallel
        if name == "moe_out":
            return (*lead, None, m(din), d(dout))       # row-parallel TP
        return (*lead, None, d(din), m(dout))           # col-parallel TP
    if name in _ROW:
        return (*lead, m(core[0]), d(core[1]))
    # default: column-parallel 2D (ffn in/gate, gates, heads, router, ...)
    return (*lead, d(core[0]), m(core[1]))


def _scale_pspec(scale_shape, w_shape, wspec: tuple) -> tuple:
    """Scale axes of size > 1 shard with the matching weight axis."""
    scale_shape, w_shape = tuple(scale_shape), tuple(w_shape)
    if len(scale_shape) != len(w_shape):
        return ()  # 0-d, or a per-tensor scale: replicate
    wtuple = tuple(wspec) + (None,) * (len(w_shape) - len(wspec))
    return tuple(wtuple[i] if (s > 1 and s == w_shape[i]) else None
                 for i, s in enumerate(scale_shape))


def _linear_pspecs(name: str, sub: dict, mesh, no_tp: bool) -> dict:
    wkey = "w" if "w" in sub else ("codes" if "codes" in sub else "codes4")
    w = sub[wkey]
    wspec = weight_pspec(name, w.shape, mesh, fsdp=(name != "embed"),
                         tp=not no_tp)
    out = {wkey: wspec}
    if "w_scale" in sub:
        out["w_scale"] = _scale_pspec(sub["w_scale"].shape, w.shape, wspec)
    for k in sub:
        if k not in out:
            out[k] = ()  # biases, activation quantizer params
    return out


def param_pspecs(params, mesh, no_tp: bool = False):
    """Spec tree mirroring a params (or moments / error) tree."""

    def walk(node):
        if isinstance(node, dict):
            out = {}
            for name, child in node.items():
                if (isinstance(child, dict) and name in NAME2KIND
                        and ("w" in child or "codes" in child
                             or "codes4" in child)):
                    out[name] = _linear_pspecs(name, child, mesh, no_tp)
                else:
                    out[name] = walk(child)
            return out
        if isinstance(node, (tuple, list)):
            return type(node)(walk(c) for c in node)
        return ()

    return walk(params)


def state_pspecs(state: dict, mesh, qcfg, no_tp: bool = False) -> dict:
    """Spec tree for the full train state (params + moments + telemetry)."""
    specs = {
        "params": param_pspecs(state["params"], mesh, no_tp),
        "mu": param_pspecs(state["mu"], mesh, no_tp),
        "nu": param_pspecs(state["nu"], mesh, no_tp),
        "step": (),
    }
    osc = state.get("osc", ())
    if osc:
        from repro_torch.models.model import quant_leaf_paths
        osc_specs = []
        for (path, w, _, _), st in zip(quant_leaf_paths(state["params"], qcfg), osc):
            wspec = weight_pspec(path[-1], w.shape, mesh, tp=not no_tp)
            osc_specs.append(type(st)(*(
                wspec if tuple(leaf.shape) == tuple(w.shape) else ()
                for leaf in st)))
        specs["osc"] = tuple(osc_specs)
    else:
        specs["osc"] = ()
    err = state.get("err", ())
    if isinstance(err, tuple) and not err:
        specs["err"] = ()
    else:
        specs["err"] = param_pspecs(err, mesh, no_tp)
    sent = state.get("sent", ())
    # the sentinel's five scalars: always replicated
    specs["sent"] = type(sent)(*(() for _ in sent)) if sent else ()
    return specs


def batch_pspecs(batch, mesh, extra_model_dp: bool = False):
    """Shard the batch (leading) axis over the data axes when divisible."""
    axes = list(batch_axes(mesh)) + (["model"] if extra_model_dp else [])
    sizes = _sizes(mesh)

    def one(a):
        use = axes[:]
        while use and a.shape[0] % math.prod(sizes.get(x, 1) for x in use):
            use.pop()
        if not use:
            return (None,) * len(a.shape)
        return (tuple(use),) + (None,) * (len(a.shape) - 1)

    return {k: one(v) for k, v in batch.items()}


def cache_pspecs(cache, mesh, *, shard_batch: bool = True):
    """Decode-cache specs: batch -> data axes, KV sequence axis -> model.

    shard_batch=False replicates the batch axis instead: the serving
    engine's pooled cache wants this (slot rows are written one at a time,
    and the slot count need not divide the data axes). Every tensor of a
    KVCache (k, v, their scales, pos) has the sequence as axis 1.
    """
    from repro_torch.models.attention import KVCache
    bt = batch_axes(mesh)
    nb = math.prod(_sizes(mesh).get(a, 1) for a in bt)

    def arr(a, seq_axis=None):
        shape = tuple(a.shape)
        entries = [None] * len(shape)
        if shard_batch and shape and shape[0] % nb == 0 and bt:
            entries[0] = bt
        if (seq_axis is not None and len(shape) > seq_axis
                and _div(shape[seq_axis], mesh, "model")):
            entries[seq_axis] = "model"
        return tuple(entries)

    def walk(node):
        if isinstance(node, KVCache):
            return KVCache(*(None if t is None else arr(t, seq_axis=1)
                             for t in node))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(c) for c in node)
        if node is None:
            return None
        return arr(node)

    return {"layers": [walk(layer) for layer in cache["layers"]]}


# ---------------------------------------------------------------------------
# specs against tensors: walking a tree beside its spec tree, local slices
# ---------------------------------------------------------------------------

def with_specs(tree: Any, specs: Any, prefix: tuple = ()) -> Iterator:
    """(path, leaf, spec) for every leaf of `tree` in `tree.flatten` order,
    `specs` being a spec tree of the same structure (a spec is the tuple at
    the place of a tensor; None stays None)."""
    if isinstance(tree, torch.Tensor) or tree is None or not isinstance(
            tree, (dict, list, tuple)):
        yield prefix, tree, specs
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from with_specs(tree[k], specs[k], prefix + (k,))
    elif hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from with_specs(getattr(tree, name), getattr(specs, name),
                                  prefix + (name,))
    else:
        for i, child in enumerate(tree):
            yield from with_specs(child, specs[i], prefix + (i,))


def map_specs(fn, tree: Any, specs: Any) -> Any:
    """fn(leaf, spec) leaf by leaf (None leaves stay None)."""
    return T.unflatten(tree, [None if leaf is None else fn(leaf, spec)
                              for _, leaf, spec in with_specs(tree, specs)])


def split_dims(spec: tuple, mesh) -> list:
    """[(array dim, mesh axes, parts)] of every axis a spec splits in more
    than one part."""
    sizes = _sizes(mesh)
    out = []
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        parts = math.prod(sizes[a] for a in axes)
        if parts > 1:
            out.append((dim, axes, parts))
    return out


def axes_index(axes: tuple, mesh, coords: dict) -> int:
    """This rank's position along the mesh axes `axes`, major first."""
    sizes = _sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coords[a]
    return idx


def local_shape(shape, spec: tuple, mesh) -> tuple:
    out = list(shape)
    for dim, _, parts in split_dims(spec, mesh):
        if out[dim] % parts:
            raise ValueError(f"axis {dim} of {tuple(shape)} does not split in "
                             f"{parts} (spec {spec})")
        out[dim] //= parts
    return tuple(out)


def local_shard(full: torch.Tensor, spec: tuple, mesh, coords: dict
                ) -> torch.Tensor:
    """This rank's slice of `full` by `spec` (coords: axis name -> this
    rank's coordinate). A replicated tensor comes back as is; a split one
    as a contiguous copy, so the full tensor can be freed."""
    dims = split_dims(spec, mesh)
    if not dims:
        return full
    out = full
    for dim, axes, parts in dims:
        if full.shape[dim] % parts:
            raise ValueError(f"axis {dim} of {tuple(full.shape)} does not "
                             f"split in {parts} (spec {spec})")
        n = full.shape[dim] // parts
        out = out.narrow(dim, axes_index(axes, mesh, coords) * n, n)
    return out.clone(memory_format=torch.contiguous_format)


def shard_tree(tree: Any, specs: Any, mesh, coords: dict) -> Any:
    """`local_shard` leaf by leaf."""
    return map_specs(lambda t, s: local_shard(t, s, mesh, coords), tree, specs)
