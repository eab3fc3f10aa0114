"""Subprocess harness for tests/test_torch_spmd.py: the port's sharded
runtime on 8 gloo ranks of the CPU, on a (2, 4) (data, model) mesh.

    PYTHONPATH=src python tests/_torch_spmd_harness.py SRC_CKPT OUT_JSON
    PYTHONPATH=src python tests/_torch_spmd_harness.py --moe OUT_JSON
    PYTHONPATH=src python tests/_torch_spmd_harness.py --no-tp OUT_JSON

SRC_CKPT holds a step-0 checkpoint of the train state (the reference's
init_state, bridged, saved by one process). Each rank restores its slices
from it (elastic restore), runs 8 steps of `run_training` with
--model-parallel 4 (the last step saved as full arrays by rank 0, then read
back as each rank's slices), runs `compressed_psum` over the data axis on
its row of a (2, 64) input, and decodes (a 6-token prefill chunk, then 4
teacher-forced decode steps) with a sequence-sharded cache (batch over the
data axis, the 16 cache rows over the 4 model ranks: 4 rows a rank)
beside the unsharded decode of the gathered params, on the
kernel route (the plain flash-decode triple on the CPU, merged across
ranks) and the unfused one. Rank 0 writes one JSON object to OUT_JSON.

--moe: 4 ranks on a (1, 4) mesh (every rank holds the same rows, so the
sharded run must equal one process bit for bit): the reduced
granite-moe-1b-a400m at w3a3 (OBR, oscillation tracked, expert-parallel
expert weights), gradient compression and the sentinel on, 3 steps of
`run_training`; rank 0 writes its losses and metrics.

--no-tp: 4 ranks on a (1, 4) mesh whose model axis is more data
parallelism (`state_specs(no_tp=True)`, `Spmd(no_tp=True)`): the weights
replicated, each rank taking 2 of the 8 rows of a batch, 4 steps of
`make_train_step(spmd=...)` on the setup above; rank 0 writes its losses.
Every run here pins `tp_compute=False`, the gathered runtime (every layer
gathered whole, so each model rank computes every linear whole): the
bars of tests/test_torch_spmd.py (step 0 within 1e-6 of one process, MoE
bit-equal) are properties of that runtime. Tensor-parallel compute, the
default, has its own harness and bars (tests/_torch_tp_harness.py).
Not a test module.
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import sys
import time

import numpy as np
import torch

N_RANKS, MODEL = 8, 4


def setup():
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import QuantConfig
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import TrainConfig
    cfg = reduced_config(get_config("granite-8b")).replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96)
    qcfg = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    tcfg = TrainConfig(total_steps=20, warmup_steps=2,
                       adamw=AdamWConfig(lr_peak=3e-3))
    return cfg, qcfg, tcfg, DataConfig(p_noise=0.05)


def psum_input() -> np.ndarray:
    return np.random.default_rng(1).standard_normal((2, 64)).astype(np.float32)


def decode_run(params, cache, tokens, cfg, qcfg, prompt: int = 6, **kw):
    """A `prompt`-token prefill chunk, then one decode step for each of the
    remaining tokens (teacher-forced, so both runs see the same inputs);
    returns the logits of every step (f32 numpy). kw: prefill_step's
    (`spmd`)."""
    from repro_torch.models import model as M
    b = tokens.shape[0]
    pos = torch.arange(prompt, dtype=torch.int32)[None].expand(b, prompt)
    logits, cache = M.prefill_step(params, cache, {"tokens": tokens[:, :prompt],
                                                   "pos": pos}, cfg, qcfg, **kw)
    outs = [logits[:, -1].float()]
    for i in range(prompt, tokens.shape[1]):
        p = torch.full((b,), i, dtype=torch.int32)
        logits, cache = M.decode_step(params, cache, {"tokens": tokens[:, i:i + 1],
                                                      "pos": p}, cfg, qcfg, **kw)
        outs.append(logits[:, 0].float())
    return torch.stack(outs).numpy()


def rank_main(rank: int, port: int, run_dir: str, out: str) -> None:
    os.environ.update(WORLD_SIZE=str(N_RANKS), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.data.synthetic import sample_batch
    from repro_torch.dist import sharding, spmd
    from repro_torch.launch.train import run_training
    from repro_torch.models import model as M
    from repro_torch.optim.grad_compress import compressed_psum
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import CheckpointManager

    cfg, qcfg, tcfg, dcfg = setup()
    t0 = time.perf_counter()
    mgr = CheckpointManager(run_dir, save_every=7, async_io=False)
    rep = run_training(cfg, qcfg, tcfg, dcfg, steps=8, batch_size=8, seq_len=16,
                       ckpt_dir=run_dir, mgr=mgr, log_every=0, device="cpu",
                       model_parallel=MODEL, tp_compute=False)
    mesh = rep.mesh
    train_s = time.perf_counter() - t0
    dist.barrier()

    # the step-7 checkpoint (full arrays, written by rank 0) read back as
    # this rank's slices
    specs = spmd.state_specs(cfg, qcfg, tcfg, mesh)
    like = spmd.init_sharded_state(cfg, qcfg, tcfg, torch.Generator(), mesh, specs)
    state = ckpt.restore(run_dir, like, step=7,
                         shardings=sharding.Layout(mesh, specs))
    params = state["params"]

    # compressed psum over the data axis: data rank d holds row d
    x = torch.from_numpy(psum_input()[mesh.coords["data"]][None])
    got = compressed_psum(x, mesh.group(("data",)))

    # decode with a sequence-sharded cache, both attention routes
    sp = spmd.Spmd(mesh, specs["params"], tp_compute=False)
    full = spmd.gather_tree(params, specs["params"], mesh)
    prompts = torch.from_numpy(sample_batch(cfg, dcfg, 99, 8, 10)["tokens"])
    lo = mesh.coords["data"] * 4
    decode = {}
    for route in ("auto", "off"):
        q = qcfg.replace(fused_attention=route)
        cache = M.init_cache(cfg, q, 8, 16, "cpu", spmd=sp, shard_batch=True)
        kv = cache["layers"][0]["kv"]
        sharded = decode_run(params, cache, prompts[lo:lo + 4], cfg, q, spmd=sp)
        whole = decode_run(full, M.init_cache(cfg, q, 8, 16, "cpu"), prompts,
                           cfg, q)[:, lo:lo + 4]
        diff = float(np.abs(sharded - whole).max())
        stats = torch.tensor([diff, float(np.isfinite(sharded).all()),
                              float((sharded == whole).all())], dtype=torch.float64)
        lo_stats = stats.clone()
        dist.all_reduce(stats, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo_stats, op=dist.ReduceOp.MIN)
        decode[route] = {"max_abs_diff": float(stats[0]),
                         "finite": bool(lo_stats[1] > 0),
                         "bit_equal": bool(lo_stats[2] > 0),
                         "cache_rows_per_rank": int(kv.k.shape[1]),
                         "batch_rows_per_rank": int(kv.k.shape[0])}

    if rank == 0:
        res = {"n_ranks": mesh.world, "mesh": mesh.shape,
               "backend": mesh.backend, "losses": rep.losses,
               "grad_norms": rep.grad_norms,
               "finite": bool(np.isfinite(rep.losses).all()),
               "state_bytes": rep.state_bytes, "psum": got[0].tolist(),
               "decode": decode, "train_s": train_s}
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def moe_setup():
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import get_preset
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig
    cfg = reduced_config(get_config("granite-moe-1b-a400m"))
    qcfg = get_preset("w3a3").replace(track_oscillation=True)
    tcfg = TrainConfig(total_steps=3, warmup_steps=2, compress_grads=True,
                       sentinel=SentinelConfig())
    return cfg, qcfg, tcfg, DataConfig()


def moe_run(ckpt_dir: str, model_parallel=None):
    """3 steps of the MoE run; a mesh of `model_parallel` model ranks, or
    one process (None)."""
    from repro_torch.launch.train import run_training
    from repro_torch.train.fault_tolerance import CheckpointManager
    cfg, qcfg, tcfg, dcfg = moe_setup()
    kw = ({} if model_parallel is None
          else {"model_parallel": model_parallel, "tp_compute": False})
    return run_training(cfg, qcfg, tcfg, dcfg, steps=3, batch_size=8, seq_len=16,
                        ckpt_dir=ckpt_dir, log_every=0, device="cpu",
                        mgr=CheckpointManager(ckpt_dir, save_every=10 ** 6,
                                              async_io=False), **kw)


def moe_rank(rank: int, port: int, run_dir: str, out: str) -> None:
    os.environ.update(WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    rep = moe_run(run_dir, model_parallel=4)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"mesh": rep.mesh.shape, "losses": rep.losses,
                       "metrics": rep.metrics, "healths": rep.healths}, f)
    dist.barrier()
    dist.destroy_process_group()


def no_tp_losses(spmd_of=None, steps: int = 4) -> tuple:
    """(losses, rows a step, state bytes) of `steps` steps from the seed-0
    state; spmd_of(cfg, qcfg, tcfg) -> (Spmd, state) shards them."""
    from repro_torch.data.synthetic import sample_batch
    from repro_torch.dist.spmd import WHOLE, tree_bytes
    from repro_torch.train.state import init_state
    from repro_torch.train.train_step import make_train_step
    cfg, qcfg, tcfg, dcfg = setup()
    if spmd_of is None:
        sp, state = WHOLE, init_state(cfg, qcfg, tcfg, torch.Generator().manual_seed(0),
                                      "cpu")
    else:
        sp, state = spmd_of(cfg, qcfg, tcfg)
    step = make_train_step(cfg, qcfg, tcfg, spmd=sp)
    losses = []
    for i in range(steps):
        batch = sp.rows(sample_batch(cfg, dcfg, i, 8, 16))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
    return losses, len(batch["tokens"]), tree_bytes(state)


def no_tp_rank(rank: int, port: int, out: str) -> None:
    os.environ.update(WORLD_SIZE="4", RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.dist import spmd
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(4, "cpu")

    def spmd_of(cfg, qcfg, tcfg):
        specs = spmd.state_specs(cfg, qcfg, tcfg, mesh, no_tp=True)
        state = spmd.init_sharded_state(cfg, qcfg, tcfg, torch.Generator().manual_seed(0),
                                        mesh, specs)
        return spmd.Spmd(mesh, specs["params"], no_tp=True), state

    losses, rows, nbytes = no_tp_losses(spmd_of)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"mesh": mesh.shape, "losses": losses, "rows": rows,
                       "state_bytes": nbytes}, f)
    dist.barrier()
    dist.destroy_process_group()


SERVE_ARGV = ["--device", "cpu", "--smoke", "--quant", "w4a4", "--batch", "3",
              "--slots", "2", "--prompt-len", "8", "--new-tokens", "4", "--chunk", "4"]


def serve_rank(rank: int, port: int, out: str) -> None:
    """The serving CLI on a (1, 2) mesh: each rank's KV rows and streams."""
    os.environ.update(WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch import serve
    run = serve.main(SERVE_ARGV + ["--model-parallel", "2"], tp_compute=False)
    res = {"kv_rows": int(run.engine.executor.pool["layers"][0]["kv"].k.shape[1]),
           "streams": {k: v.tokens for k, v in run.engine.results.items()}}
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(src: str, out: str) -> None:
    import torch.multiprocessing as mp
    run_dir = os.path.join(os.path.dirname(os.path.abspath(out)), "run")
    shutil.rmtree(run_dir, ignore_errors=True)
    shutil.copytree(src, run_dir)
    mp.spawn(rank_main, args=(free_port(), run_dir, out), nprocs=N_RANKS,
             join=True)


if __name__ == "__main__":
    if sys.argv[1] == "--moe":
        import torch.multiprocessing as mp
        mp.spawn(moe_rank, args=(free_port(), sys.argv[2] + ".ckpt", sys.argv[2]),
                 nprocs=4, join=True)
    elif sys.argv[1] == "--serve":
        import torch.multiprocessing as mp
        mp.spawn(serve_rank, args=(free_port(), sys.argv[2]), nprocs=2, join=True)
    elif sys.argv[1] == "--no-tp":
        import torch.multiprocessing as mp
        mp.spawn(no_tp_rank, args=(free_port(), sys.argv[2]), nprocs=4, join=True)
    else:
        main(sys.argv[1], sys.argv[2])
