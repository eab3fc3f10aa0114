"""Gradient compression with error feedback, over the port's trees.

PyTorch counterpart of `repro.optim.grad_compress`: int8 symmetric
quantization of each gradient leaf with a per-tensor scale, and an
error-feedback accumulator that adds the quantization residual back into
the next step's gradient, so the compression bias vanishes over time
(Karimireddy et al., 2019). The train step compresses after OBR and before
the sentinel's verdict (`train_step.make_train_step`, `TrainConfig.
compress_grads`); a fatal step keeps the old error tree.

Plain f32 torch ops in the reference's order: max |g|, max(amax / 127,
1e-12), an IEEE division, round half to even (as `jnp.round`), clip, int8.
On equal inputs the results are bit-equal to the reference's.
`compressed_psum` puts int8 codes on the wire for a mean over a process
group: a max all-reduce of amax, the shared scale, an int32 sum of the
codes.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T

INT8_MAX = 127.0


def _whole(amax: torch.Tensor) -> torch.Tensor:
    """A whole leaf's max |g| is its own."""
    return amax


def _quant(g: torch.Tensor, amax=_whole):
    amax = amax(torch.max(torch.abs(g)))
    scale = torch.clamp(amax / INT8_MAX, min=1e-12)
    codes = torch.clamp(torch.round(g / scale), -INT8_MAX, INT8_MAX).to(torch.int8)
    return codes, scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor, amax=_whole):
    """Returns (decompressed gradient, new error feedback), both f32.
    amax: this slice's max |g| -> the leaf's (`dist.spmd.Spmd.amax`, an
    all-reduce over the ranks holding its slices)."""
    gf = g.to(torch.float32) + err
    codes, scale = _quant(gf, amax)
    deq = codes.to(torch.float32) * scale
    return deq, gf - deq


def compress_tree(grads, err_tree, amax=_whole):
    """(decompressed gradient tree, new error tree), leaf by leaf."""
    out = [compress_leaf(g, e, amax)
           for g, e in zip(T.leaves(grads), T.leaves(err_tree))]
    return (T.unflatten(grads, [d for d, _ in out]),
            T.unflatten(grads, [e for _, e in out]))


def init_error_tree(params):
    """f32 zeros shaped like every leaf of params, on its device."""
    return T.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def compressed_psum(g: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire mean of `g` over the ranks of `group` (None: the
    default group). Each rank quantizes its own g with the shared max
    scale, the codes are summed as int32, and the mean is sum * scale / n,
    in the reference's order (`repro.optim.grad_compress.compressed_psum`)."""
    from repro_torch.dist.spmd import all_reduce
    if group is None:
        group = torch.distributed.group.WORLD
    n = torch.distributed.get_world_size(group)
    g32 = g.to(torch.float32)
    amax = all_reduce(torch.max(torch.abs(g32)), group, "max")
    scale = torch.clamp(amax / INT8_MAX, min=1e-12)
    codes = torch.clamp(torch.round(g32 / scale), -INT8_MAX, INT8_MAX).to(torch.int32)
    total = all_reduce(codes, group)
    return total.to(torch.float32) * scale / n
