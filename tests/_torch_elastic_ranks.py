"""Subprocess helper for tests/test_torch_checkpoint_ft.py: the elastic
checkpoint round trip on 4 gloo ranks of the CPU, a (2, 2) (data, model)
mesh.

    PYTHONPATH=src python tests/_torch_elastic_ranks.py DIR

Each rank builds the same full state from one seed (reduced 2-layer
qwen1.5-0.5b, 4-bit MDQ, oscillation tracked, gradient compression's error
tree, the sentinel's scalars), then (1) restores DIR/single, a checkpoint
one process saved at step 1, as its slices by `state_pspecs` and checks
each slice bit for bit against its cut of the full state; (2) saves its
slices through `CheckpointManager(layout=...)` at step 2 into DIR/mesh
(gathered, written by rank 0 alone). Each rank writes DIR/rank{R}.json.
Not a test module.
"""
from __future__ import annotations

import json
import os
import socket
import sys

import torch

RANKS, MODEL = 4, 2


def setup():
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import QuantConfig
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig
    cfg = reduced_config(get_config("qwen1.5-0.5b")).replace(n_layers=2)
    qcfg = QuantConfig(w_bits=4, a_bits=4, mode="mdq", track_oscillation=True)
    tcfg = TrainConfig(total_steps=10, compress_grads=True, sentinel=SentinelConfig())
    return cfg, qcfg, tcfg


def full_state():
    """The full state every rank and the test process build alike: a fresh
    state with every leaf filled with distinct values."""
    from repro_torch import tree as T
    from repro_torch.train.state import init_state
    cfg, qcfg, tcfg = setup()
    state = init_state(cfg, qcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    leaves = []
    for leaf in T.leaves(state):
        if torch.is_floating_point(leaf):
            leaf = torch.randn(leaf.shape, generator=gen).to(leaf.dtype)
        elif leaf.dtype == torch.int8:
            leaf = torch.randint(-8, 8, leaf.shape, generator=gen, dtype=torch.int8)
        leaves.append(leaf)
    return T.unflatten(state, leaves)


def rank_main(rank: int, port: int, root: str) -> None:
    os.environ.update(WORLD_SIZE=str(RANKS), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import CheckpointManager
    cfg, qcfg, tcfg = setup()
    mesh = make_host_mesh(MODEL, "cpu")
    full = full_state()
    specs = sharding.state_pspecs(full, mesh, qcfg)
    mine = sharding.shard_tree(full, specs, mesh, mesh.coords)
    layout = sharding.Layout(mesh, specs)
    # one process's checkpoint -> this rank's slices
    got = ckpt.restore(os.path.join(root, "single"), mine, step=1, shardings=layout)
    same = all(torch.equal(a, b) and a.dtype == b.dtype for (_, a, _), (_, b, _) in zip(
        sharding.with_specs(got, specs), sharding.with_specs(mine, specs)))
    split = sum(1 for _, _, s in sharding.with_specs(mine, specs)
                if sharding.split_dims(s, mesh))
    # this rank's slices -> one checkpoint of full arrays
    mgr = CheckpointManager(os.path.join(root, "mesh"), save_every=2,
                            async_io=False, layout=layout)
    mgr.maybe_save(mine, 2)
    dist.barrier()
    with open(os.path.join(root, f"rank{rank}.json"), "w") as f:
        json.dump({"restored_bit_equal": same, "split_leaves": split,
                   "coords": mesh.coords}, f)
    dist.destroy_process_group()


def main(root: str) -> None:
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(rank_main, args=(port, root), nprocs=RANKS, join=True)


if __name__ == "__main__":
    main(sys.argv[1])
