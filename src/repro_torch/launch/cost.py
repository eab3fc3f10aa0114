"""Cost counter: the FLOPs, bytes and collectives of an eager program.

    with CostMode() as cm:
        step(state, batch)
    cm.result()  # flops, bytes, collective bytes / counts, per-op table

PyTorch counterpart of `repro.launch.hlo_cost`. The reference parses the
compiled HLO text and multiplies each while-loop body by its trip count;
eager PyTorch runs every loop iteration, so a `TorchDispatchMode` that sees
each aten op as it runs is loop-aware by construction. It runs on any
device: on the meta device (shapes only) it counts a program nothing
computes, which is what `launch.dryrun` does.

Accounting policy (the reference's):
  * FLOPs: dots and convolutions only, 2 x output elements x contracted
    elements (`mm`, `bmm`, `addmm`, `baddbmm`, `mv`, `dot`, `convolution`
    and its backward; `matmul`, `einsum` and `linear` reach these).
    Elementwise FLOPs are ignored: they never bind the compute term.
  * Bytes: each aten op's tensor inputs read once and outputs written once
    (`boundary_bytes`); views move none. Eager PyTorch fuses nothing, so
    this reads higher than XLA's count of the same program.
  * Hand-written kernels count as one op each. Every kernel wrapper
    (`kernels/quant_matmul.py`, `decode_attention.py`, `fake_quant.py`,
    `bin_stats.py`) is wrapped by `counted`, which records the call's
    boundary bytes and the operations the wrapper reports from its
    arguments' shapes; no aten op inside the call is counted, neither the
    CUDA path's operand preparation nor the plain version's arithmetic. So
    a kernel costs the same on the card, on the CPU and on meta.
  * Collectives: each collective that `dist.spmd.collect` launches records
    its output bytes by op kind ("all-gather", "reduce-scatter",
    "all-reduce"), the reference's accounting of post-SPMD HLO
    (`roofline.py`: output bytes, a <= 2x proxy of the on-wire volume).

With `track_live`, the mode also keeps the peak of the bytes that the ops
it saw allocated and still hold (each new output storage adds its bytes;
the last tensor referencing it going away subtracts them), plus each
kernel's scratch during its call: the temp memory of the dry run.

`ByteCounter` is the plainer counter the kernel benchmark uses: every aten
op's bytes, kernels' insides included.
"""
from __future__ import annotations

import functools
import weakref
from collections import defaultdict
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS

aten = torch.ops.aten

# dist.spmd.collect's job kinds -> the reference's collective op names
COLLECTIVE_OF = {"gather": "all-gather", "scatter": "reduce-scatter",
                 "sum": "all-reduce", "max": "all-reduce"}

# the innermost active CostMode (kernel wrappers and collectives report to it)
_ACTIVE: list = []


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes a tensor's elements occupy; a broadcast (stride-0) axis holds
    one element."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(node, out: list) -> list:
    """The tensors of an aten op's arguments or results (lists, tuples and
    dicts of them), in order, appended to `out`."""
    if isinstance(node, torch.Tensor):
        out.append(node)
    elif isinstance(node, (list, tuple)):
        for x in node:
            _tensors(x, out)
    elif isinstance(node, dict):
        for x in node.values():
            _tensors(x, out)
    return out


def boundary_bytes(*trees) -> int:
    """Every tensor in the inputs / outputs given, read or written once."""
    return sum(map(tensor_bytes, _tensors(trees, [])))


# ops that return a view of their input without saying so in their schema
_UNANNOTATED_VIEWS = ("aten::_unsafe_view",)


_VIEWS: dict = {}


def is_view(func) -> bool:
    """Whether an aten op returns a view of an input (cached per op)."""
    v = _VIEWS.get(func)
    if v is None:
        v = _VIEWS[func] = (
            func._schema.name in _UNANNOTATED_VIEWS
            or any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns))
    return v


class ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every aten op's tensor inputs and outputs that
    runs under it (forward and backward); view ops move nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not is_view(func):
            self.ops += 1
            self.bytes += boundary_bytes(args, kwargs or {}, out)
        return out


def counted_bytes(fn) -> int:
    with ByteCounter() as bc:
        fn()
    return bc.bytes


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

_MATMULS = (aten.mm, aten.bmm, aten.mv)
_ADD_MATMULS = (aten.addmm, aten.baddbmm, aten.addmv)


def _conv_flops(weight: torch.Tensor, out: torch.Tensor, transposed: bool,
                inp: torch.Tensor) -> float:
    """2 x output elements x contracted elements of one convolution (for a
    transposed one, the forward convolution it is the gradient of)."""
    per = 1
    for d in weight.shape[1:]:
        per *= d
    return 2.0 * (inp.numel() if transposed else out.numel()) * per


def dot_flops(func, args, out) -> float:
    """The reference's FLOPs policy for one aten op: dots and convolutions
    only (0 for anything else)."""
    packet = func.overloadpacket
    if packet in _MATMULS:
        return 2.0 * out.numel() * args[0].shape[-1]
    if packet in _ADD_MATMULS:
        return 2.0 * out.numel() * args[1].shape[-1]
    if packet is aten.addbmm:
        b1 = args[1]
        return 2.0 * out.numel() * b1.shape[0] * b1.shape[-1]
    if packet in (aten.dot, aten.vdot):
        return 2.0 * args[0].numel()
    if packet in (aten.convolution, aten._convolution):
        return _conv_flops(args[1], out, bool(args[6]), args[0])
    if packet is aten.convolution_backward:
        grad_out, inp, weight = args[0], args[1], args[2]
        transposed, mask = bool(args[7]), args[10]
        one = _conv_flops(weight, grad_out, transposed, inp)
        return one * (int(bool(mask[0])) + int(bool(mask[1])))
    return 0.0


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class CostMode(TorchDispatchMode):
    """Counts the aten ops, kernel calls and collectives run under it (see
    the module docstring); `result()` gives the totals."""

    def __init__(self, track_live: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op = defaultdict(lambda: {"count": 0, "flops": 0.0, "bytes": 0.0})
        self.kernels = defaultdict(lambda: {"calls": 0, "flops": 0.0, "bytes": 0.0,
                                            "ops": 0.0, "bound_s": 0.0})
        self.coll_bytes = defaultdict(float)
        self.coll_count = defaultdict(float)
        self._in_kernel = 0
        self.track_live = track_live
        self.live = 0
        self.peak = 0
        self._held: dict = {}  # storage key -> [tensors referencing it, bytes]

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- aten ops ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._in_kernel:
            return out
        ins = _tensors(kwargs, _tensors(args, []))
        outs = _tensors(out, [])
        if not is_view(func):
            f = dot_flops(func, args, out)
            b = sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
            self.flops += f
            self.bytes += b
            rec = self.by_op[func._schema.name]
            rec["count"] += 1
            rec["flops"] += f
            rec["bytes"] += b
        if self.track_live:
            self._track(ins, outs, storage_bytes=True)
        return out

    # -- live bytes ------------------------------------------------------------
    def _release(self, key: int) -> None:
        held = self._held.get(key)
        if held is None:
            return
        held[0] -= 1
        if held[0] == 0:
            self.live -= held[1]
            del self._held[key]

    def _hold(self, t: torch.Tensor, key: int) -> None:
        self._held[key][0] += 1
        weakref.finalize(t, self._release, key)

    def _track(self, ins: list, outs: list, *, storage_bytes: bool,
               extra: int = 0) -> None:
        """Output storages not among the inputs' are new: add their bytes
        (the storage's for an aten op, the tensor's own for a kernel's
        declared output) and drop them when no tensor references them; an
        output sharing a counted storage (a view, an in-place result) holds
        it too."""
        seen = None
        for t in outs:
            key = _storage_key(t)
            if key in self._held:
                self._hold(t, key)
            else:
                if seen is None:
                    seen = {_storage_key(a) for a in ins}
                if key in seen:
                    continue
                n = t.untyped_storage().nbytes() if storage_bytes else tensor_bytes(t)
                self._held[key] = [0, n]
                self._hold(t, key)
                self.live += n
        self.peak = max(self.peak, self.live + extra)

    # -- kernels and collectives ------------------------------------------------
    def add_kernel(self, name: str, figures: dict, args, kwargs, out) -> None:
        ins, outs = _tensors(kwargs, _tensors(args, [])), _tensors(out, [])
        b = sum(map(tensor_bytes, ins)) + sum(map(tensor_bytes, outs))
        f = float(figures.get("flops", 0.0))
        ops = float(figures.get("ops", f))
        rate = F32_FLOPS if figures.get("f32") else PEAK_FLOPS
        self.flops += f
        self.bytes += b
        rec = self.kernels[name]
        rec["calls"] += 1
        rec["flops"] += f
        rec["bytes"] += b
        rec["ops"] += ops
        rec["bound_s"] += max(b / HBM_BW, ops / rate)
        op = self.by_op[f"kernel::{name}"]
        op["count"] += 1
        op["flops"] += f
        op["bytes"] += b
        if self.track_live:
            self._track(ins, outs, storage_bytes=False,
                        extra=int(figures.get("scratch", 0)))

    def add_collective(self, kind: str, out: torch.Tensor) -> None:
        op = COLLECTIVE_OF[kind]
        self.coll_bytes[op] += tensor_bytes(out)
        self.coll_count[op] += 1

    # -- results ---------------------------------------------------------------
    def result(self) -> dict:
        """The reference's `analyze()` keys, the per-op table (the
        counterpart of `analyze_by_opcode`, heaviest bytes first) and the
        per-kernel records."""
        by_op = dict(sorted(((k, dict(v)) for k, v in self.by_op.items()),
                            key=lambda kv: -kv[1]["bytes"]))
        out = {"flops": self.flops, "bytes": self.bytes,
               "collective_bytes_by_op": dict(self.coll_bytes),
               "collective_count_by_op": dict(self.coll_count),
               "collective_bytes": sum(self.coll_bytes.values()),
               "collective_count": sum(self.coll_count.values()),
               "by_op": by_op,
               "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())}}
        if self.track_live:
            out["peak_live_bytes"] = self.peak
        return out


def active() -> Optional[CostMode]:
    return _ACTIVE[-1] if _ACTIVE else None


def counted(name: str, figures: Callable) -> Callable:
    """Decorator of a kernel wrapper: under a CostMode the call counts as
    one op `name` with `figures(*args, **kwargs)` -> {"flops": dot FLOPs,
    "ops": the operations that bound it (default flops), "f32": True where
    they run outside the tensor cores, "scratch": bytes the call holds
    besides its outputs}, and its boundary bytes; nothing inside the call
    is counted. Without a CostMode the wrapper runs as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            mode = active()
            if mode is None or mode._in_kernel:
                return fn(*args, **kwargs)
            mode._in_kernel += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                mode._in_kernel -= 1
            mode.add_kernel(name, figures(*args, **kwargs), args, kwargs, out)
            return out
        return wrapper
    return deco


def record_collective(kind: str, out: torch.Tensor) -> None:
    """Called by `dist.spmd.collect` for each collective it launches."""
    mode = active()
    if mode is not None:
        mode.add_collective(kind, out)
