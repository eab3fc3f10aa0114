"""Meshes: the production sizes for the sharding rules, and a (data, model)
mesh over the process group for real runs.

PyTorch counterpart of `repro.launch.mesh`. Axes:
  pod   — data parallelism across pods; gradient all-reduce only
  data  — data parallelism within a pod
  model — tensor / expert / KV-sequence parallelism

`make_production_mesh` gives sizes only (`sharding.AxisSizes`): what the
rules need, with no device behind it. `make_host_mesh(model)` gives a
`HostMesh` of (world // model, model) over the process group: ranks are laid
out row-major (the model axis fastest), as `jax.make_mesh` lays out devices.
The group is initialised from torchrun's environment (WORLD_SIZE, RANK,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) when WORLD_SIZE is set and no group
exists yet; without it the world is one process, which holds every tensor
whole, and every collective is the identity (`dist.spmd.WHOLE` is such a
mesh's runtime). The backend follows the device: NCCL for CUDA ranks with a card
each, gloo for CPU ranks, and gloo where ranks share a card (NCCL refuses
two ranks on one device); gloo moves a CUDA tensor's payload through a host
copy (`HostMesh.staged`). Compute stays on the rank's device.
"""
from __future__ import annotations

import itertools
import math
import os
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import AxisSizes
from repro_torch.kernels.ops import resolve_device


def make_production_mesh(*, multi_pod: bool = False) -> AxisSizes:
    if multi_pod:
        return AxisSizes(("pod", "data", "model"), (2, 16, 16))
    return AxisSizes(("data", "model"), (16, 16))


class HostMesh:
    """A mesh over the process group: axis sizes, this rank's coordinates,
    its device, and one process group per set of axes (the ranks that differ
    only along those axes), made at construction by every rank in the same
    order. `group(axes)` is None where the axes hold one rank."""

    def __init__(self, axis_names: tuple, sizes: tuple,
                 device: Optional[torch.device], backend: Optional[str]):
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(sizes)
        self.shape = dict(zip(self.axis_names, self.sizes))
        self.world = math.prod(self.sizes)
        self.rank = dist.get_rank() if self.world > 1 else 0
        self.device = device
        self.backend = backend
        # gloo moves CUDA payloads through a host copy
        self.staged = (backend == "gloo" and device is not None
                       and device.type == "cuda")
        self.coords = {}
        rest = self.rank
        for name, n in reversed(list(zip(self.axis_names, self.sizes))):
            self.coords[name] = rest % n
            rest //= n
        self._groups: dict = {}
        if self.world > 1:
            self._make_groups()

    def _rank_of(self, coords: dict) -> int:
        r = 0
        for name, n in zip(self.axis_names, self.sizes):
            r = r * n + coords[name]
        return r

    def _make_groups(self) -> None:
        names = self.axis_names
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                if math.prod(self.shape[a] for a in axes) == 1:
                    continue
                others = [a for a in names if a not in axes]
                for fixed in itertools.product(*(range(self.shape[a]) for a in others)):
                    base = dict(zip(others, fixed))
                    ranks = sorted(self._rank_of({**base, **dict(zip(axes, c))})
                                   for c in itertools.product(
                                       *(range(self.shape[a]) for a in axes)))
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[axes] = g

    def axes(self, axes) -> tuple:
        """`axes` in mesh order (the order ranks sit in a group)."""
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes):
        return self._groups.get(self.axes(axes))

    def describe(self) -> str:
        return (f"rank {self.rank}/{self.world} mesh "
                f"{dict(zip(self.axis_names, self.sizes))} coords {self.coords} "
                f"device {self.device} backend {self.backend or 'none (one process)'}"
                f"{' (CUDA payloads staged through host memory)' if self.staged else ''}")


def _init_from_env(device: torch.device) -> Optional[str]:
    """Initialise the default group from torchrun's variables; returns the
    backend taken (None for a world of one with no group)."""
    if dist.is_initialized():
        return dist.get_backend()
    if "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ.get("RANK", "0"))
    if device.type == "cuda":
        shared = world > torch.cuda.device_count()
        backend = "gloo" if shared else "nccl"
    else:
        backend = "gloo"
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ.setdefault("MASTER_PORT", "29500")
    # env:// joins torchrun's own store where it runs under torchrun
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=rank)
    return backend


def make_host_mesh(model: int = 1, device=None) -> HostMesh:
    """(world // model, model) mesh over the process group (see the module
    docstring); `device` is CUDA unless the caller asks for the CPU, and a
    CUDA rank takes card LOCAL_RANK modulo the card count."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = _init_from_env(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or world % model:
        raise ValueError(f"--model-parallel {model} does not divide the world "
                         f"size {world}")
    mesh = HostMesh(("data", "model"), (world // model, model), device, backend)
    if backend is not None:
        print(mesh.describe(), flush=True)
    return mesh
