"""The sharded runtime: state held as shards, gathered on use.

PyTorch counterpart of what `jax.jit` with NamedShardings does for the JAX
package's train step and decode (tests/test_spmd.py is its oracle). Every
rank runs the same program on its own shards over a `launch.mesh.HostMesh`:

* State at rest. params, mu, nu, osc and err are this rank's slices by
  `sharding.state_pspecs`; the step and the sentinel's scalars are
  replicated (`init_sharded_state`).
* Batch. Every rank draws the global batch and keeps its rows by
  `sharding.batch_pspecs` (`Spmd.rows`): over the data axes, and over the
  model axis too with no_tp (the weights then whole on every model rank);
  under gradient accumulation its share of each microbatch, so that
  microbatch i over the ranks is the reference's. `Spmd.dp` names that
  split (a `DPSplit`): the MoE FFN routes the global batch over it
  (`models.moe`).
* Gather on use. `Spmd.gather` all-gathers a layer's leaves just before
  the layer runs (`models.model.forward(spmd=...)`, inside the block's
  checkpoint, so a remat backward gathers again) through `_GatherMany`,
  whose backward turns the full gradients back into this rank's slices
  (a layer's collectives are launched together, `collect`): the data
  axes are reduce-scattered where the leaf splits over them and
  all-reduced where it does not, and the sum is divided by the number of
  data ranks (each local loss is a mean over local rows). A leaf gathered
  whole over the model axis keeps its own model slice of the full
  gradient (the ranks of a data group hold the same rows and the same
  gradient: it is summed once, not once per model rank).
* Tensor-parallel compute (`tp_compute=True`, the default). Where the
  model names a sublayer that may run so (`models.model.layer_tp`: a
  block's attention, wq / wk / wv / wo on heads, and its dense FFN,
  w_in / w_gate / w_out on d_ff, or its MoE FFN's experts; in training
  also an mLSTM on heads, an RG-LRU on channels, an sLSTM's FFN on d_ff
  and cross-attention on heads; the embedding and the head on vocab)
  and the rules split every weight of it over
  `model` (`Spmd.tp`), its leaves are gathered over the data axes only
  and each rank runs the kernels on its own slices, as GSPMD partitions
  the reference's einsums: a
  column-parallel linear (q / k / v, w_in / w_gate, the head) takes its
  input through `to_model` (identity forward, all-reduce backward) and
  gives this rank's output columns; a row-parallel one (wo, w_out) takes
  this rank's input columns and its partial output goes through
  `from_model` (a sum forward, identity backward: an all-reduce, or with
  `ordered_sums`, which the serving runtime asks for, the partials
  gathered and added in rank order). The training loss reads the head's
  logits as this rank's columns (`core.kd` with `tp`: each row's max
  over the model ranks through `max_model`, its sum of exp and target
  terms through `from_model`, launched under the use "loss"); serving
  and eval take them whole through `gather_model` (all-gather forward;
  the backward keeps this rank's slice, every model rank holding the
  same loss). Replicated leaves that
  model-split work reads (activation scales and offsets, per-tensor
  weight scales, biases) go through `to_model`, so their partial
  gradients are summed over the model ranks, and the module-wise g
  factor is the whole weight's (`core.quantizer.scale_grad_factor`).
  MoE experts split one of two ways. Where the experts divide the model
  axis (expert parallelism, `TPSplit.experts`), every model rank of a
  data group routes the same rows to the same capacity buffer; each cuts
  its experts from it (`split_model`: its part forward, the parts'
  gradients all-gathered backward), runs them, and the output buffer is
  all-gathered along the experts (`gather_model`) before the combine: a
  gather, not a sum, so the expert products keep their bits. Where only
  d_ff divides, each expert splits as the dense FFN does (moe_in /
  moe_gate column-parallel, moe_out row-parallel). The router stays
  gathered whole (top-k reads every expert's f32 logit). A recurrent
  block's depthwise conv runs on the rank's channels and its output is
  all-gathered for the linears that contract all of them (`gather_sum`:
  they read it through column-parallel slices, so its backward is a
  reduce-scatter of their partial gradients); its replicated conv_w,
  lam and hn_g are read on the rank's slice through `split_model`.
  Everything else (the sLSTM's cell, whose recurrent mix contracts the
  dh axis the rules split; serving's recurrent blocks and cross layers,
  held whole with their states; a weight that does not divide, no_tp,
  `tp_compute=False`) keeps the gathered path above, so every model rank
  computes it whole.
* Global decisions come out of all-reduces: the loss and metrics (means
  over the data ranks), the gradient norm (each element counted once),
  compression's per-leaf amax, and the sentinel's non-finite and scale
  flags, so every rank takes the same skip or rollback. OBR's Eq. 10 and
  the oscillation fraction are taken on each rank's slices: a leaf's sums
  (Eq. 10's sum of squares and bin moments, each slice's groups at their
  place in the leaf's group tensor; the count of oscillating weights) are
  summed over the mesh axes its spec splits (`leaf_sums`), and each rank
  finishes the value from them and keeps its slice's gradient. No
  quantized weight or EMA is gathered for either.
* Decode. A KV cache whose sequence axis `sharding.cache_pspecs` splits
  over the model axis holds rows [k T/M, (k+1) T/M) on model rank k
  (`SeqSplit`): `models.attention.attend_chunk` runs the decode-attention
  kernel over those rows and merges the ranks' (acc, m, l) triples in rank
  order; a row is written only on the rank that holds it. With a
  tensor-parallel attention, q, k and v leave their column-parallel
  slices through `gather_model` over heads before that attention (the
  cache holds every head of its rows), and each rank passes its own heads
  of the merged output to the row-parallel wo.

The kernels run unchanged, on gathered weights or on this rank's slices.
Tensor parallelism sums row-parallel partials and column-parallel input
gradients over the model ranks, so it is not bit-equal to one process
(the gathered runtime is, up to the data ranks' sums). One process is a
world of one: it holds every tensor whole, so nothing is gathered, cut or
reduced, and its arithmetic is the single-process arithmetic exactly.
`WHOLE` is its runtime, the default of every function that takes an
`spmd`.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.core.obr import Place
from repro_torch.dist import sharding as shard
from repro_torch.launch import cost
from repro_torch.launch.mesh import HostMesh
from repro_torch.optim.adamw import global_norm


# ---------------------------------------------------------------------------
# collectives (a gloo group moves a CUDA payload through a host copy)
# ---------------------------------------------------------------------------

# the newer names where this torch has them (the older ones warn there)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


# bytes each kind of collective delivered to this rank since the last
# reset (the outputs' bytes, `launch.cost`'s accounting), the same bytes
# of the collectives launched under a use (`counted_as`), and the host
# seconds spent inside `collect` (staging, the wire and the wait)
_MOVED: dict = {}
_BY_USE: dict = {}
_USE: list = [None]
_SECONDS = [0.0]


def moved_bytes() -> dict:
    return dict(_MOVED)


def moved_bytes_by_use() -> dict:
    """The bytes of `moved_bytes` that collectives launched under each use
    (`counted_as`) delivered; the rest were launched under none."""
    return dict(_BY_USE)


@contextlib.contextmanager
def counted_as(use: str):
    """Count the collectives launched inside (and in the backward of the
    model-axis operators applied inside: `TPSplit`) under `use` too."""
    prev = _USE[0]
    _USE[0] = use
    try:
        yield
    finally:
        _USE[0] = prev


def collect_seconds() -> float:
    return _SECONDS[0]


def reset_moved_bytes() -> None:
    _MOVED.clear()
    _BY_USE.clear()
    _SECONDS[0] = 0.0


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def collect(jobs: list) -> list:
    """Run collectives together and return their results in order. A job
    is (kind, tensor, group, dim): "gather" concatenates the group's
    tensors along dim in group rank order, "scatter" sums them and keeps
    this rank's 1/n along dim, "sum" / "max" all-reduce. Every job is
    launched before any is waited on, so gloo's threads move several at
    once (about twice the rate of one at a time on 4 CPU ranks); a job
    without a group returns its tensor. Its host seconds add up in
    `collect_seconds`."""
    t0 = time.perf_counter()
    try:
        return _collect(jobs)
    finally:
        _SECONDS[0] += time.perf_counter() - t0


def _collect(jobs: list) -> list:
    pend = []
    for kind, t, group, dim in jobs:
        if group is None:
            pend.append((None, t, kind, dim, t.device))
            continue
        x = t.detach()
        if kind in ("gather", "scatter"):
            x = x.movedim(dim, 0)
        if _staged(group, t):
            x = x.contiguous().to("cpu")
        elif kind in _REDUCE_OPS:  # reduced in place: never the caller's tensor
            x = x.clone(memory_format=torch.contiguous_format)
        else:
            x = x.contiguous()
        n = dist.get_world_size(group)
        if kind == "gather":
            out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            work = _ALL_GATHER(out, x, group=group, async_op=True)
        elif kind == "scatter":
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            work = _REDUCE_SCATTER(out, x, group=group, async_op=True)
        else:
            out = x
            work = dist.all_reduce(out, op=_REDUCE_OPS[kind], group=group,
                                   async_op=True)
        cost.record_collective(kind, out)
        nbytes = out.numel() * out.element_size()
        _MOVED[kind] = _MOVED.get(kind, 0) + nbytes
        if _USE[0] is not None:
            _BY_USE[_USE[0]] = _BY_USE.get(_USE[0], 0) + nbytes
        pend.append((work, out, kind, dim, t.device))
    results = []
    for work, out, kind, dim, device in pend:
        if work is not None:
            work.wait()
            out = out.to(device)
            if kind in ("gather", "scatter"):
                out = out.movedim(0, dim)  # a view: callers make it contiguous
        results.append(out)
    return results


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A new tensor: t reduced over `group` (t itself for no group)."""
    return collect([(op, t, group, None)])[0]


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group rank order."""
    return collect([("gather", t, group, dim)])[0].contiguous()


def gather_many(leaves: list, specs: list, mesh) -> list:
    """The full tensors of this rank's slices: all-gathers over the axes
    each spec splits, the leaves' collectives launched together."""
    outs = list(leaves)
    plans = [shard.split_dims(spec, mesh) for spec in specs]
    for step in range(max((len(p) for p in plans), default=0)):
        todo = [(j, p[step]) for j, p in enumerate(plans) if step < len(p)]
        for _, (_, axes, _) in todo:
            if tuple(axes) != mesh.axes(axes):
                raise ValueError(f"spec entry {axes} is not in mesh order")
        done = collect([("gather", outs[j], mesh.group(axes), dim)
                        for j, (dim, axes, _) in todo])
        for (j, _), out in zip(todo, done):
            outs[j] = out
    return [o.contiguous() for o in outs]


def gather(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The full tensor from this rank's slice `t`."""
    return gather_many([t], [spec], mesh)[0]


def reduce_many(grads: list, specs: list, mesh, data_axes: tuple) -> list:
    """Full gradients of a local loss -> this rank's slices of the
    data-mean gradients (see the module docstring), the leaves'
    collectives launched together."""
    outs, scatters = [], []
    for g, spec in zip(grads, specs):
        scatter = []
        for dim, axes, parts in shard.split_dims(spec, mesh):
            if any(a in data_axes for a in axes):
                if not all(a in data_axes for a in axes):
                    raise ValueError(f"spec entry {axes} mixes data and model axes")
                scatter.append((dim, axes))
            else:  # the same gradient on every rank of these axes: a slice
                n = g.shape[dim] // parts
                g = g.narrow(dim, shard.axes_index(axes, mesh, mesh.coords) * n, n)
        outs.append(g)
        scatters.append(scatter)
    for step in range(max((len(sc) for sc in scatters), default=0)):
        todo = [(j, sc[step]) for j, sc in enumerate(scatters) if step < len(sc)]
        done = collect([("scatter", outs[j], mesh.group(axes), dim)
                        for j, (dim, axes) in todo])
        for (j, _), out in zip(todo, done):
            outs[j] = out
    rest = [mesh.group([a for a in data_axes
                        if not any(a in ax for _, ax in sc)]) for sc in scatters]
    outs = collect([("sum", g, group, None) for g, group in zip(outs, rest)])
    n = mesh.size(data_axes)
    return [(g * (1.0 / n) if n > 1 else g).contiguous() for g in outs]


class _GatherMany(torch.autograd.Function):
    """Full leaves from this rank's slices; the backward turns their full
    gradients back into this rank's slices (`reduce_many`)."""

    @staticmethod
    def forward(ctx, mesh, data_axes, specs, *leaves):
        ctx.mesh, ctx.data_axes, ctx.specs = mesh, data_axes, specs
        ctx.set_materialize_grads(False)
        outs = gather_many(list(leaves), specs, mesh)
        return tuple(o.view_as(o) if o is t else o for o, t in zip(outs, leaves))

    @staticmethod
    def backward(ctx, *grads):
        live = [j for j, g in enumerate(grads) if g is not None]
        red = reduce_many([grads[j] for j in live], [ctx.specs[j] for j in live],
                          ctx.mesh, ctx.data_axes)
        out = [None] * len(grads)
        for j, r in zip(live, red):
            out[j] = r
        return (None, None, None, *out)


# ---------------------------------------------------------------------------
# tensor-parallel operators over the model group
# ---------------------------------------------------------------------------

class _ToModel(torch.autograd.Function):
    """Identity forward; the backward sums the model ranks' partial
    gradients (in f32, cast back to the gradient's dtype)."""

    @staticmethod
    def forward(ctx, group, x):
        ctx.group, ctx.use = group, _USE[0]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with counted_as(ctx.use):
            return None, all_reduce(g.to(torch.float32), ctx.group).to(g.dtype)


class _FromModel(torch.autograd.Function):
    """Sum over the model ranks forward; identity backward. ordered: the
    ranks' partials gathered and added in rank order (M x an all-reduce's
    bytes), so a row's bits do not depend on the rows that share the call;
    otherwise an all-reduce, whose order follows the backend's chunking of
    the whole buffer."""

    @staticmethod
    def forward(ctx, group, ordered, x):
        if not ordered:
            return all_reduce(x, group)
        parts = all_gather(x[None], group, 0)
        out = parts[0]
        for part in parts[1:]:
            out = out + part
        return out

    @staticmethod
    def backward(ctx, g):
        return None, None, g


class _GatherModel(torch.autograd.Function):
    """All-gather along `dim` in rank order; the backward returns this
    rank's slice of the gradient, unsummed: every model rank holds the
    same loss, so each holds the whole gradient already."""

    @staticmethod
    def forward(ctx, group, index, dim, x):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n)


class _GatherModelSum(torch.autograd.Function):
    """All-gather along `dim` in rank order; the backward sums the model
    ranks' partial gradients of the whole tensor (in f32, cast back to the
    gradient's dtype) and keeps this rank's part: a reduce-scatter. For a
    tensor every rank then reads only through its own column-parallel
    slices, so each holds a partial gradient of it."""

    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim, ctx.use = group, dim, _USE[0]
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        with counted_as(ctx.use):
            out = collect([("scatter", g.to(torch.float32), ctx.group, ctx.dim)])[0]
        return None, None, out.contiguous().to(g.dtype)


class _SplitModel(torch.autograd.Function):
    """This rank's part along `dim` forward; the backward all-gathers the
    parts' gradients in rank order (every model rank holds the same whole
    tensor and needs its whole gradient): `_GatherModel`'s dual."""

    @staticmethod
    def forward(ctx, group, index, parts, dim, x):
        ctx.group, ctx.dim, ctx.use = group, dim, _USE[0]
        n = x.shape[dim] // parts
        return x.narrow(dim, index * n, n)

    @staticmethod
    def backward(ctx, g):
        with counted_as(ctx.use):
            return None, None, None, None, all_gather(g, ctx.group, ctx.dim)


class TPSplit(NamedTuple):
    """A sublayer's weights split over the `parts` model ranks of `group`;
    this rank holds part `index`. ordered: `from_model` sums in rank order
    (the serving runtime asks for it: its engine's streams then equal
    `greedy_generate`'s whatever rows a call batches). `dim`: the weight
    axis a linear's slice is cut along (set by `models.common` per
    linear). experts: an MoE FFN split on its expert axis (expert
    parallelism); otherwise its experts split on d_ff. summed: a
    column-parallel linear's input already went through a model-axis
    operator whose backward sums the ranks' partial gradients (one
    `to_model` shared by several linears, or `gather_sum`), so `qlinear`
    applies none of its own."""
    group: Any
    index: int
    parts: int
    ordered: bool = False
    dim: Optional[int] = None
    experts: bool = False
    summed: bool = False

    def to_model(self, x: torch.Tensor) -> torch.Tensor:
        return _ToModel.apply(self.group, x)

    def from_model(self, x: torch.Tensor) -> torch.Tensor:
        return _FromModel.apply(self.group, self.ordered, x)

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _GatherModel.apply(self.group, self.index, dim % x.dim(), x)

    def gather_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The model ranks' parts of a tensor concatenated along `dim`, for
        column-parallel linears only (they take it with `summed`): the
        backward reduce-scatters their partial gradients."""
        return _GatherModelSum.apply(self.group, dim % x.dim(), x)

    def split_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of a whole tensor that every model rank holds,
        along `dim`; its gradient is the parts' gradients all-gathered
        (`local` gives the same through `to_model`'s all-reduce of
        zero-padded parts, M x the bytes)."""
        return _SplitModel.apply(self.group, self.index, self.parts, dim % x.dim(), x)

    def max_model(self, x: torch.Tensor) -> torch.Tensor:
        """x's elementwise max over the model ranks; no gradient."""
        return all_reduce(x.detach(), self.group, "max")

    def local(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of a whole tensor along `dim`."""
        n = x.shape[dim] // self.parts
        return x.narrow(dim, self.index * n, n)


class DPSplit(NamedTuple):
    """A batch's rows split over the `parts` data ranks of `group`: this
    rank holds share `index` of each (micro)batch's rows, the shares in
    global row order (`Spmd.dp`)."""
    group: Any
    index: int
    parts: int


def _strip_model(spec: tuple) -> tuple:
    """`spec` without the model axis: the leaf gathered over the data axes
    only."""
    out = []
    for entry in spec:
        axes = tuple(a for a in shard.spec_axes(entry) if a != "model")
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def _weight_spec(sub: Any) -> Optional[tuple]:
    """The spec of a linear's weight (w, codes or codes4) in its spec
    subtree; None where it has none."""
    if not isinstance(sub, dict):
        return None
    for key in ("w", "codes", "codes4"):
        if key in sub:
            return sub[key]
    return None


def spec_at(specs: Any, path: tuple) -> Any:
    for key in path:
        specs = specs[key]
    return specs


class SeqSplit(NamedTuple):
    """A KV cache's sequence axis split over `parts` model ranks; this rank
    holds rows [index * T_local, (index + 1) * T_local)."""
    group: Any
    index: int
    parts: int

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(t, self.group, dim)


def _owner(spec: tuple, mesh) -> bool:
    """True on the one rank of each replica set of a leaf: coordinate 0 on
    every mesh axis its spec does not split."""
    split = {a for _, axes, _ in shard.split_dims(spec, mesh) for a in axes}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in split)


class Spmd:
    """The sharded step's view of the mesh: the params' spec tree, the axes
    the batch rows split over, and (serving) each layer's cache split.
    `make_train_step(spmd=...)`, `forward(spmd=...)`, `init_cache(spmd=...)`
    and `prefill_step(spmd=...)` call into it. On a world of one (`whole`)
    every tensor is whole: its methods return their inputs, and `pspecs`
    may be None."""

    def __init__(self, mesh, pspecs: Any = None, *, osc_specs: tuple = (),
                 no_tp: bool = False, tp_compute: bool = True,
                 ordered_sums: bool = False):
        self.mesh = mesh
        self.whole = mesh.world == 1
        self.pspecs = pspecs
        self.osc_specs = osc_specs
        # no_tp: the model axis is more data parallelism (the specs were
        # made with no_tp, so no weight splits over it)
        self.no_tp = no_tp
        self.data_axes = tuple(shard.batch_axes(mesh)) + (("model",) if no_tp else ())
        # the data axes the batch's rows split over: all of them, unless
        # `batch_specs` found a batch that splits over fewer
        self.row_axes = self.data_axes
        self.seq_parts: Optional[list] = None  # set by local_cache
        self._owners = None  # per leaf of pspecs: counted in the norm here
        # tp_compute: model-split sublayers run on this rank's slices;
        # False gathers every leaf whole (the gathered runtime).
        # ordered_sums: `TPSplit.ordered`
        self._split = None
        if (tp_compute and not no_tp and not self.whole and pspecs is not None
                and mesh.shape.get("model", 1) > 1):
            self._split = TPSplit(mesh.group(("model",)), mesh.coords["model"],
                                  mesh.shape["model"], ordered_sums)
        self._tp: dict = {}

    # -- tensor parallelism ----------------------------------------------------
    def _model_split(self, spec: Optional[tuple]) -> bool:
        return spec is not None and any(
            "model" in shard.spec_axes(e) for e in spec)

    def tp(self, path: tuple, names: tuple = ()) -> Optional[TPSplit]:
        """This rank's split where tensor-parallel compute is on and the
        weight of every linear `names` under `path` (of the linear at
        `path` itself, names empty) splits over the model axis; else None
        (the caller runs the sublayer whole, on gathered leaves). Which
        sublayers may run so is the model's decision (`models.model.
        layer_tp`: attention, the FFNs, the mLSTM, the RG-LRU, the sLSTM's
        FFN, cross-attention; a path into the layer, ("layers", i, "rg"),
        for the RG-LRU's linears)."""
        if self._split is None:
            return None
        key = (path, names)
        if key not in self._tp:
            sub = spec_at(self.pspecs, path)
            self._tp[key] = self._split if all(
                self._model_split(_weight_spec(sub[n] if names else sub))
                for n in names or (None,)) else None
        return self._tp[key]

    def experts(self, path: tuple) -> bool:
        """The rules split the leading (expert) axis of the linear at `path`
        over the model axis: expert parallelism."""
        spec = _weight_spec(spec_at(self.pspecs, path))
        return bool(spec) and "model" in shard.spec_axes(spec[0])

    # -- batch ---------------------------------------------------------------
    def batch_specs(self, batch: dict) -> dict:
        """`sharding.batch_pspecs` of a global batch (every entry's leading
        axis the rows); the data axes they split the rows over become
        `row_axes`."""
        specs = shard.batch_pspecs(batch, self.mesh, extra_model_dp=self.no_tp)
        axes = {shard.spec_axes(sp[0]) if sp else () for sp in specs.values()}
        if len(axes) > 1:
            raise ValueError(f"the batch's entries split their rows over {axes}")
        if axes:
            self.row_axes = axes.pop()
        return specs

    @property
    def dp(self) -> Optional[DPSplit]:
        """The batch's rows split over data ranks (`models.moe.moe_ffn`
        routes the global batch over them), None where one rank holds them
        all."""
        parts = self.mesh.size(self.row_axes)
        if self.whole or parts == 1:
            return None
        if tuple(self.row_axes) != self.mesh.axes(self.row_axes):
            raise ValueError(f"row axes {self.row_axes} are not in mesh order")
        return DPSplit(self.mesh.group(self.row_axes),
                       shard.axes_index(self.row_axes, self.mesh, self.mesh.coords),
                       parts)

    def rows(self, batch: dict, accum: int = 1) -> dict:
        """This rank's rows of a global numpy batch (every entry's leading
        axis must split over the data axes). accum > 1: its share of each
        of the batch's `accum` microbatches of consecutive rows, in order,
        so that where the step cuts its rows into `accum` microbatches,
        microbatch i over the data ranks is the global batch's microbatch
        i (each microbatch's rows must split over the data axes)."""
        if self.whole:
            return batch
        specs = self.batch_specs(batch)
        parts = self.mesh.size(self.row_axes)
        out = {}
        for k, v in batch.items():
            split = shard.split_dims(specs[k], self.mesh)
            if self.mesh.size(self.data_axes) > 1 and not split:
                raise ValueError(f"batch entry {k} {v.shape} does not split "
                                 f"over {self.data_axes}")
            v = np.ascontiguousarray(v)
            if accum > 1 and parts > 1:  # (accum, rows of a microbatch, ...)
                n = v.shape[0]
                if n % accum or (n // accum) % parts:
                    raise ValueError(f"batch entry {k} {v.shape}: {accum} microbatches "
                                     f"do not split over {self.row_axes}")
                local = shard.local_shard(
                    torch.from_numpy(v.reshape((accum, n // accum) + v.shape[1:])),
                    (None,) + tuple(specs[k]), self.mesh, self.mesh.coords).numpy()
                local = local.reshape((-1,) + local.shape[2:])
            else:
                local = shard.local_shard(torch.from_numpy(v), specs[k], self.mesh,
                                          self.mesh.coords).numpy()
            out[k] = np.ascontiguousarray(local)
        return out

    # -- params --------------------------------------------------------------
    def gather(self, path: tuple, sub: Any, split: tuple = ()) -> Any:
        """The full leaves of the subtree at `path`, gathered together
        (autograd carries the gradients of leaves that need one back to
        their slices); the leaves under the entries of `split` (the
        linears of a tensor-parallel sublayer, `tp`: a key of `sub`, or a
        tuple of keys for a linear deeper down, ("moe", "moe_in")) are
        gathered over the data axes only, and keep their model slices."""
        if self.whole:
            return sub
        keys = [k if isinstance(k, tuple) else (k,) for k in split]
        items = [(leaf, _strip_model(spec) if spec is not None and any(
                      tuple(sub_path[:len(k)]) == k for k in keys) else spec)
                 for sub_path, leaf, spec
                 in shard.with_specs(sub, spec_at(self.pspecs, path))]
        reduce = self.mesh.size(self.data_axes) > 1
        todo = [j for j, (leaf, spec) in enumerate(items) if leaf is not None and (
            shard.split_dims(spec, self.mesh) or (reduce and leaf.requires_grad))]
        if not todo:
            return sub
        leaves = [items[j][0] for j in todo]
        specs = [items[j][1] for j in todo]
        if any(t.requires_grad for t in leaves):
            full = _GatherMany.apply(self.mesh, self.data_axes, specs, *leaves)
        else:
            full = gather_many(leaves, specs, self.mesh)
        out = [leaf for leaf, _ in items]
        for j, t in zip(todo, full):
            out[j] = t
        return T.unflatten(sub, out)

    # -- reductions ------------------------------------------------------------
    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """Mean over the data ranks (a loss or metric of local rows)."""
        n = self.mesh.size(self.data_axes)
        if n == 1:
            return x
        return all_reduce(x.to(torch.float32), self.mesh.group(self.data_axes)) / n

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A 0-d bool true on every rank where it is true on one."""
        if self.whole:
            return flag
        v = all_reduce(flag.to(torch.int32), self.mesh.group(self.mesh.axis_names),
                       "max")
        return v > 0

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        if self.whole:
            return x
        return all_reduce(x, self.mesh.group(self.mesh.axis_names), "max")

    def norm(self, grads: Any) -> torch.Tensor:
        """The global norm of a sharded gradient tree, each element counted
        once (the slice of one rank per replica set), leaves in walk order."""
        if self.whole:
            return global_norm(grads)
        if self._owners is None:
            self._owners = [_owner(spec, self.mesh) for _, _, spec
                            in shard.with_specs(grads, self.pspecs)]
        leaves = T.leaves(grads)
        sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for g, owner in zip(leaves, self._owners):
            if owner:
                sq = sq + torch.sum(torch.square(g.to(torch.float32)))
        return torch.sqrt(all_reduce(sq, self.mesh.group(self.mesh.axis_names)))

    # -- OBR and the oscillation fraction on slices ----------------------------
    def _split_axes(self, spec: tuple) -> tuple:
        return self.mesh.axes({a for _, axes, _ in shard.split_dims(spec, self.mesh)
                               for a in axes})

    def leaf_sums(self, items: list) -> list:
        """[(t, spec)] -> each t summed over the mesh axes its leaf's spec
        splits: the slices' partial sums add up, slices' disjoint groups
        (at their places, zeros elsewhere) fill the whole, and the replicas
        along the axes the spec does not split already hold the same sums.
        The tensors of one axis set go into one flat buffer (one dtype),
        so a call launches one all-reduce per distinct axis set, all of
        them together."""
        if self.whole:
            return [t for t, _ in items]
        sets: dict = {}
        for j, (_, spec) in enumerate(items):
            axes = self._split_axes(spec)
            if axes:
                sets.setdefault(axes, []).append(j)
        out = [t for t, _ in items]
        bufs = collect([("sum", torch.cat([items[j][0].reshape(-1) for j in js]),
                         self.mesh.group(axes), None) for axes, js in sets.items()])
        for js, buf in zip(sets.values(), bufs):
            at = 0
            for j in js:
                n = items[j][0].numel()
                out[j] = buf[at:at + n].view(items[j][0].shape)
                at += n
        return out

    def obr_place(self, path: tuple, w: torch.Tensor, s: torch.Tensor):
        """Where this rank's scale groups of the leaf at `path` sit in the
        whole leaf's (`core.obr.Place`), None where its scale is whole."""
        if self.whole:
            return None
        sp = spec_at(self.pspecs, path)
        if not all(w.shape) or not all(s.shape):
            raise ValueError(f"an empty slice {tuple(w.shape)} of {path} (spec {sp['w']})")
        dims = shard.split_dims(sp["w_scale"], self.mesh)
        if not dims:
            return None
        offsets = [0] * s.dim()
        for dim, axes, _ in dims:
            offsets[dim] = shard.axes_index(axes, self.mesh, self.mesh.coords) * s.shape[dim]
        return Place(self._whole_shape(s, sp["w_scale"]), tuple(offsets))

    def _whole_shape(self, t: torch.Tensor, spec: tuple) -> tuple:
        """The shape of the whole leaf of which `t` is this rank's slice by
        `spec`."""
        shape = list(t.shape)
        if not self.whole:
            for dim, _, parts in shard.split_dims(spec, self.mesh):
                shape[dim] *= parts
        return tuple(shape)

    def numel(self, t: torch.Tensor, spec: tuple) -> int:
        return math.prod(self._whole_shape(t, spec))

    def _refine(self, t: torch.Tensor, have: tuple, want: tuple) -> torch.Tensor:
        """This rank's slice by spec `want` of the tensor whose slice by
        `have` is `t`; each entry of `want` must extend `have`'s (its axes
        first, more after them)."""
        for dim in range(t.dim()):
            h = shard.spec_axes(have[dim] if dim < len(have) else None)
            w = shard.spec_axes(want[dim] if dim < len(want) else None)
            if w[:len(h)] != h:
                raise ValueError(f"spec {want} does not refine {have}")
            extra = w[len(h):]
            parts = self.mesh.size(extra)
            if parts > 1:
                n = t.shape[dim] // parts
                if not n or t.shape[dim] % parts:
                    raise ValueError(f"axis {dim} of {tuple(t.shape)} does not split "
                                     f"in {parts}")
                t = t.narrow(dim, shard.axes_index(extra, self.mesh, self.mesh.coords)
                             * n, n)
        return t

    def osc_view(self, index: int, path: tuple, w: torch.Tensor,
                 s: torch.Tensor):
        """(w, s) sliced as oscillation state `index` is: the rules give an
        embedding's state an FSDP split its weight does not have, so its
        slice is cut from this rank's weight slice (nothing gathered)."""
        if self.whole:
            return w, s
        sp = spec_at(self.pspecs, path)
        wspec, ospec = sp["w"], self.osc_specs[index].prev_int
        if ospec == wspec:
            return w, s
        return (self._refine(w, wspec, ospec),
                self._refine(s, sp["w_scale"], shard._scale_pspec(
                    self._whole_shape(s, sp["w_scale"]),
                    self._whole_shape(w, wspec), ospec)))

    # -- decode ----------------------------------------------------------------
    def local_cache(self, cache: dict, *, shard_batch: bool = False) -> dict:
        """This rank's slice of a full decode cache by `cache_pspecs`; the
        layers' sequence splits are kept for `seq` (every cache of a run
        has the same lengths, so the same splits)."""
        if self.whole:
            return cache
        specs = shard.cache_pspecs(cache, self.mesh, shard_batch=shard_batch)
        self.seq_parts = seq_parts_of(specs, self.mesh)
        return shard.shard_tree(cache, specs, self.mesh, self.mesh.coords)

    def seq(self, layer: int) -> Optional[SeqSplit]:
        """Layer `layer`'s KV sequence split, None where it is not split."""
        if not self.seq_parts or self.seq_parts[layer] == 1:
            return None
        return SeqSplit(self.mesh.group(("model",)), self.mesh.coords["model"],
                        self.seq_parts[layer])


WHOLE = Spmd(HostMesh(("data", "model"), (1, 1), None, None))


# ---------------------------------------------------------------------------
# state placement
# ---------------------------------------------------------------------------

def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf gathered to its full shape (on every rank)."""
    items = list(shard.with_specs(tree, specs))
    todo = [j for j, (_, t, _) in enumerate(items) if t is not None]
    full = gather_many([items[j][1] for j in todo], [items[j][2] for j in todo], mesh)
    out = [t for _, t, _ in items]
    for j, t in zip(todo, full):
        out[j] = t
    return T.unflatten(tree, out)


def state_specs(cfg, qcfg, tcfg, mesh, no_tp: bool = False) -> dict:
    """`sharding.state_pspecs` of the full-width state, from a shape-only
    (meta device) state: no memory."""
    from repro_torch.train.state import init_state
    like = init_state(cfg, qcfg, tcfg, torch.Generator(), "meta")
    return shard.state_pspecs(like, mesh, qcfg, no_tp)


def init_sharded_state(cfg, qcfg, tcfg, generator: torch.Generator, mesh,
                       specs: dict) -> dict:
    """This rank's slice of `train.state.init_state` with the same draws:
    the full params are built on the device and cut to this rank's slices
    (the oscillation state, made from the full weights, by its own specs);
    the moments and error tree are made from the slices."""
    from repro_torch.core.oscillation import init_osc_state
    from repro_torch.models.model import init_params, quant_leaves
    from repro_torch.train.state import state_from_params
    full = init_params(cfg, qcfg, generator, mesh.device)
    osc = ()
    if qcfg.track_oscillation:
        osc = shard.shard_tree(tuple(init_osc_state(w, s, sp) for w, s, sp
                                     in quant_leaves(full, qcfg)),
                               specs["osc"], mesh, mesh.coords)
    params = shard.shard_tree(full, specs["params"], mesh, mesh.coords)
    del full
    return state_from_params(params, qcfg, tcfg, osc=osc)


def tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree)
               if isinstance(t, torch.Tensor))


def seq_parts_of(cache_specs: dict, mesh) -> list:
    """Per layer, the parts its KV cache's sequence axis is split in."""
    out = []
    for lay in cache_specs["layers"]:
        kv = lay.get("kv") if isinstance(lay, dict) else None
        parts = 1
        if kv is not None:
            entry = kv.k[1] if len(kv.k) > 1 else None
            parts = mesh.size(shard.spec_axes(entry)) if entry else 1
        out.append(parts)
    return out
