"""Multi-pod dry run: one rank's program for every (arch x shape x mesh) cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \
        --shape train_4k --mesh single --out build/dr.jsonl

PyTorch counterpart of `repro.launch.dryrun`, with the same flags, JSON-lines
records and restartable `run()` loop. For each cell it shows, without a
card:
  * that the sharding rules hold for it (every leaf of the state, batch
    and cache cut to this rank's slice by its spec, every collective of
    the step launched on those slices),
  * what one rank holds and its peak (`memory`, `per_device_bytes`,
    `fits_80g` against the H100's 80 GB),
  * and its roofline terms (`launch.cost` + `launch.roofline`).

Where the reference lowers and compiles one jit over 256 (512) host devices,
this runs rank 0's own program: torch's fake process group at the mesh's
world (every collective returns at once, shapes only), `launch.mesh.
HostMesh` over it, the train state (or the serving params and cache) as
rank 0's slices on the meta device, and one train step, prefill or decode
step through `dist.spmd` under `launch.cost.CostMode`. Every kernel wrapper
takes its plain version there, which computes nothing on meta, and counts
as one op with its own figures. A world of one (the `mesh_sizes=(1, 1)`
test seam) builds no process group.

The step is the tensor-parallel one (`dist.spmd.Spmd(tp_compute=True)`,
the default of the launchers), as the reference's GSPMD step partitions
its einsums over `model`: rank 0 counts the dots of its own weight slices
wherever the rules split a sublayer's weights over the model axis (the
attention on heads, the dense FFN on d_ff, the embedding and the head on
vocab), plus the all-reduces of row-parallel outputs and of
column-parallel input gradients, and the logits' all-gather where
serving takes them whole (the training loss reads the rank's columns:
its row max and sums are all-reduces, `collectives.bytes_by_use`'s
"loss"); a
sublayer whose weights do not split (MoE experts, recurrent blocks,
cross-attention, a weight that does not divide) is gathered whole and
counted whole on every rank, as is a serving chunk's attention over its
own keys (the cache's rows split over the model axis, its heads do not).
A training MoE FFN routes the global microbatch over the data ranks
(`models.moe`): each layer's forward all-gathers the ranks' per-group,
per-expert counts (int32, counted under "experts"); meta tensors hold no
counts, so where a group spans ranks the rank's capacity buffer is the
group's capacity over its ranks, rounded up to 8 (the balanced load).
The record's "moe" says so: the dispatch groups, the data ranks, the
buffers' rows ({rows: calls}) and the count gathers' bytes.

Memory, per rank: `argument_size_in_bytes` is this rank's state (params,
moments, telemetry) or serving params and cache, plus its batch rows, from
the rules; `temp_size_in_bytes` is the CostMode's live-bytes peak (new
output storages held at once, each kernel's scratch during its call);
`alias_size_in_bytes` is 0 (the step updates the state and the cache in
place, so no output needs room beside its input); `per_device_bytes` =
temp + argument - alias, as in the reference.

Prefill and decode write the cache rows that a `nonzero` finds; meta tensors
hold no data, so the run sets torch's `meta_nonzero_assume_all_nonzero`
(every row live, the dry run's assumption) and restores it afterward. The
prefill cell runs `models.model.prefill_step` over the whole prompt as one
chunk into a fresh cache of seq_len rows (the port's serving prefill; the
reference runs `forward(collect_cache=True)`).

`trace_s` is the seconds of the meta run (the reference's `compile_s`).
Some cells take minutes on a CPU: xlstm-350m's sLSTM runs its time loop
once a token (`models/recurrent.py`), so train_4k runs it 4,096 times a
layer and microbatch.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs import shapes as shp
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core.policy import QuantConfig, get_preset
from repro_torch.dist import sharding as shard
from repro_torch.dist import spmd as S
from repro_torch.launch import cost
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HostMesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import moe
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.state import TrainConfig
from repro_torch.train.train_step import make_train_step

def _quant_for(shape_kind: str, preset: str, serve_kv_bits: int) -> QuantConfig:
    q = get_preset(preset)
    if shape_kind in ("decode", "prefill"):
        q = q.replace(kv_cache_bits=serve_kv_bits)
    return q


def _train_cfg(cfg: ArchConfig, shape: shp.ShapeSpec, grad_accum: int,
               bf16_moments: bool = False) -> TrainConfig:
    # microbatch must stay shardable over dp
    while grad_accum > 1 and (shape.global_batch % grad_accum
                              or (shape.global_batch // grad_accum) % 8):
        grad_accum //= 2
    adamw = AdamWConfig(moments_dtype="bfloat16" if bf16_moments else "float32")
    return TrainConfig(total_steps=150_000, warmup_steps=750,
                       grad_accum=max(1, grad_accum), kd="mckd", kd_topk=16,
                       adamw=adamw)


# ---------------------------------------------------------------------------
# set-up and tear-down
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world: int):
    """Torch's fake process group at `world` ranks, this process rank 0;
    destroyed on exit. A world of one needs none."""
    if world == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("a process group exists already: the dry run makes "
                           "its own fake one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def rows_all_live():
    """`nonzero` on meta as if every element were nonzero; restored after."""
    from torch.fx.experimental import _config
    saved = _config.meta_nonzero_assume_all_nonzero
    _config.meta_nonzero_assume_all_nonzero = True
    try:
        yield
    finally:
        _config.meta_nonzero_assume_all_nonzero = saved


@contextlib.contextmanager
def rank0_mesh(names: tuple, sizes: tuple, device):
    """Rank 0's `HostMesh` of the given axes over a fake world of their
    product (none for a world of one)."""
    world = 1
    for n in sizes:
        world *= n
    with fake_world(world):
        yield HostMesh(tuple(names), tuple(sizes), torch.device(device),
                       "fake" if world > 1 else None)


def _local(batch: dict, mesh, extra_model_dp: bool = False) -> dict:
    """This rank's rows of a global batch of meta tensors."""
    specs = shard.batch_pspecs(batch, mesh, extra_model_dp)
    return {k: torch.empty(shard.local_shape(v.shape, specs[k], mesh), dtype=v.dtype,
                           device=v.device) for k, v in batch.items()}


def real_batch(cfg: ArchConfig, shape: shp.ShapeSpec, kd_topk: int, device) -> dict:
    """Training inputs of `token_specs`' shapes and dtypes from the synthetic
    stream (step 0, seed 0), on a device that computes."""
    from repro_torch.data.mckd_store import synthetic_kd_labels
    from repro_torch.data.synthetic import DataConfig, sample_batch
    batch = sample_batch(cfg, DataConfig(), 0, shape.global_batch, shape.seq_len)
    if kd_topk:
        idx, p = synthetic_kd_labels(batch["labels"], cfg.vocab_size, kd_topk, seed=0)
        batch.update(kd_idx=idx, kd_p=p)
    specs = shp.token_specs(cfg, shape, kd_topk=kd_topk)
    out = {k: torch.from_numpy(batch[k]).to(device=device, dtype=v.dtype)
           for k, v in specs.items()}
    return out


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _run_counted(fn, *args) -> tuple[dict, float]:
    """fn(*args) under a live-tracking CostMode: (its result(), seconds).
    On the card the result also holds the step's measured peak
    (`device_peak_bytes`: torch.cuda.max_memory_allocated, reset first)."""
    dev = next(t.device for t in T.leaves(args) if isinstance(t, torch.Tensor))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    before = S.moved_bytes_by_use()
    with cost.CostMode(track_live=True) as cm:
        out = fn(*args)
        del out
    res = cm.result()
    res["collective_bytes_by_use"] = {
        k: v - before.get(k, 0) for k, v in S.moved_bytes_by_use().items()
        if v != before.get(k, 0)}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        res["device_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return res, time.monotonic() - t0


def train_inputs(cfg, shape, tcfg, qcfg, mesh, extra_dp: bool, gen) -> tuple:
    """(state, batch, specs): this rank's slices of the train state and its
    batch rows on the mesh's device (meta: shapes only; a device that
    computes: one rank, inputs from the synthetic stream)."""
    specs = S.state_specs(cfg, qcfg, tcfg, mesh, no_tp=extra_dp)
    state = S.init_sharded_state(cfg, qcfg, tcfg, gen, mesh, specs)
    if mesh.device.type == "meta":
        batch = _local(shp.token_specs(cfg, shape, kd_topk=tcfg.kd_topk), mesh, extra_dp)
    else:
        if mesh.world != 1:
            raise ValueError("a dry run on a device that computes takes one rank")
        batch = real_batch(cfg, shape, tcfg.kd_topk, mesh.device)
    return state, batch, specs


def _train_cell(cfg, shape, tcfg, qcfg, mesh, extra_dp, device, gen):
    state, batch, specs = train_inputs(cfg, shape, tcfg, qcfg, mesh, extra_dp, gen)
    sp = S.Spmd(mesh, specs["params"], osc_specs=specs["osc"], no_tp=extra_dp)
    sp.batch_specs(shp.token_specs(cfg, shape, kd_topk=tcfg.kd_topk))  # its row axes
    step = make_train_step(cfg, qcfg, tcfg, spmd=sp)
    moe.reset_buffer_rows()
    res, secs = _run_counted(step, state, batch)
    if cfg.n_experts:
        dp = sp.dp
        res["moe"] = {
            "dispatch_groups": cfg.moe_dispatch_groups,
            "data_ranks": 1 if dp is None else dp.parts,
            "buffer_rows": moe.buffer_rows(),
            "count_gather_bytes": moe.count_gather_bytes(),
            "local_capacity": ("where a group spans ranks, its capacity over its "
                               "ranks, rounded up to 8 (meta tensors hold no counts)"
                               if dp is not None else "the group's capacity")}
    return res, secs, {"state": S.tree_bytes(state), "batch": S.tree_bytes(batch)}


def _serve_params(cfg, qcfg, mesh, device, gen):
    params = M.init_serving_params(cfg, qcfg, gen, device)
    pspecs = shard.param_pspecs(params, mesh)
    if mesh.world != 1:
        params = shard.shard_tree(params, pspecs, mesh, mesh.coords)
    return params, S.Spmd(mesh, pspecs)


def _prefill_cell(cfg, shape, qcfg, mesh, device, gen):
    if device.type != "meta":
        raise ValueError("the prefill cell runs on the meta device only")
    params, sp = _serve_params(cfg, qcfg, mesh, device, gen)
    cache = M.init_cache(cfg, qcfg, shape.global_batch, shape.seq_len, device,
                         spmd=sp, shard_batch=True)
    batch = shp.token_specs(cfg, shape)
    batch.pop("labels")
    batch["pos"] = torch.empty((shape.global_batch, shape.seq_len), dtype=torch.int32,
                               device="meta")
    batch = _local(batch, mesh)

    def prefill(params, cache, batch):
        logits, cache = M.prefill_step(params, cache, batch, cfg, qcfg, spmd=sp)
        return logits[:, -1], cache

    with rows_all_live():
        res, secs = _run_counted(prefill, params, cache, batch)
    return res, secs, {"params": S.tree_bytes(params), "cache": S.tree_bytes(cache),
                       "batch": S.tree_bytes(batch)}


def _decode_cell(cfg, shape, qcfg, mesh, device, gen):
    params, sp = _serve_params(cfg, qcfg, mesh, device, gen)
    cache = M.init_cache(cfg, qcfg, shape.global_batch, shape.seq_len, device,
                         spmd=sp, shard_batch=True)
    if device.type == "meta":
        batch = _local(shp.decode_token_specs(cfg, shape), mesh)
    else:
        if mesh.world != 1 or cfg.frontend != "none":
            raise ValueError("a decode dry run on a device that computes takes one "
                             "rank and token inputs")
        b = shape.global_batch
        batch = {"tokens": torch.randint(1, cfg.vocab_size, (b, 1), generator=gen,
                                         device=device, dtype=torch.int64
                                         ).to(torch.int32),
                 "pos": torch.full((b,), shape.seq_len - 1, dtype=torch.int32,
                                   device=device)}

    def decode(params, cache, batch):
        return M.decode_step(params, cache, batch, cfg, qcfg, spmd=sp)

    with rows_all_live():
        res, secs = _run_counted(decode, params, cache, batch)
    return res, secs, {"params": S.tree_bytes(params), "cache": S.tree_bytes(cache),
                       "batch": S.tree_bytes(batch)}


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool, preset: str,
               grad_accum: int, serve_kv_bits: int, extra_dp: bool = False,
               moe_groups: int = 1, bf16_moments: bool = False,
               mesh_sizes: Optional[tuple] = None,
               shape: Optional[shp.ShapeSpec] = None,
               cfg: Optional[ArchConfig] = None, qcfg: Optional[QuantConfig] = None,
               device="meta") -> dict:
    """One cell's record (see the module docstring). The CLI's cells run on
    the production mesh at the assigned shape; `mesh_sizes` ((data, model),
    or (pod, data, model)), `shape`, `cfg` and `qcfg` replace those (tests
    and chip_smoke.py run one rank at a cell's own batch and quantizer),
    and `device` runs the same counted step on a device that computes (one
    rank, train and decode cells: the inputs then come from the synthetic
    stream)."""
    cfg = cfg or get_config(arch)
    if cfg.n_experts and moe_groups != 1:
        dp = 32 if multi_pod else 16
        cfg = cfg.replace(moe_dispatch_groups=dp if moe_groups == 0 else moe_groups)
    shape = shape or shp.get_shape(shape_name)
    ok, reason = shp.shape_applicable(cfg, shape)
    if not ok:
        return {"status": "skipped", "reason": reason}
    if mesh_sizes is None:
        prod = make_production_mesh(multi_pod=multi_pod)
        names, sizes = prod.axis_names, prod.sizes
    else:
        names = ("pod", "data", "model")[-len(mesh_sizes):]
        sizes = tuple(mesh_sizes)
    device = torch.device(device)
    gen = torch.Generator(device=device if device.type == "cuda" else "cpu").manual_seed(0)
    with rank0_mesh(names, sizes, device) as mesh:
        chips = mesh.world
        if shape.kind == "train":
            qcfg = qcfg or _quant_for("train", preset, serve_kv_bits)
            tcfg = _train_cfg(cfg, shape, grad_accum, bf16_moments)
            res, secs, arg_parts = _train_cell(cfg, shape, tcfg, qcfg, mesh, extra_dp,
                                               device, gen)
            tokens = shape.global_batch * shape.seq_len
            mf = rl.model_flops_per_step(cfg, tokens, train=True)
        elif shape.kind == "prefill":
            qcfg = qcfg or _quant_for("prefill", preset, serve_kv_bits)
            res, secs, arg_parts = _prefill_cell(cfg, shape, qcfg, mesh, device, gen)
            tokens = shape.global_batch * shape.seq_len
            mf = rl.model_flops_per_step(cfg, tokens, train=False)
        else:  # decode
            qcfg = qcfg or _quant_for("decode", preset, serve_kv_bits)
            res, secs, arg_parts = _decode_cell(cfg, shape, qcfg, mesh, device, gen)
            tokens = shape.global_batch  # one token per sequence
            mf = rl.model_flops_per_step(cfg, tokens, train=False)
    roof = rl.roofline_from_cost(res, chips=chips, model_flops=mf)
    mem = {"temp_size_in_bytes": int(res["peak_live_bytes"]),
           "argument_size_in_bytes": sum(arg_parts.values()),
           "alias_size_in_bytes": 0, "argument_parts": arg_parts}
    if "device_peak_bytes" in res:
        mem["device_peak_bytes"] = res["device_peak_bytes"]
    per_device_bytes = (mem["temp_size_in_bytes"] + mem["argument_size_in_bytes"]
                        - mem["alias_size_in_bytes"])
    return {
        "status": "ok", "trace_s": round(secs, 1), "device": device.type,
        "chips": chips, "tokens_per_step": tokens,
        "memory": mem, "per_device_bytes": per_device_bytes,
        "fits_80g": per_device_bytes < rl.HBM_BYTES,
        "collectives": {"bytes_by_op": res["collective_bytes_by_op"],
                        "count_by_op": res["collective_count_by_op"],
                        "bytes_by_use": res["collective_bytes_by_use"],
                        "total_bytes": res["collective_bytes"],
                        "total_count": res["collective_count"]},
        "roofline": roof,
        "cost": {"flops": res["flops"], "bytes": res["bytes"],
                 "kernels": res["kernels"], "by_op": res["by_op"]},
        "grad_accum": (_train_cfg(cfg, shape, grad_accum, bf16_moments)
                       .grad_accum if shape.kind == "train" else None),
        **({"moe": res["moe"]} if "moe" in res else {}),
    }


def run(args) -> None:
    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shape_names = list(shp.SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    existing = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    if rec.get("status") in ("ok", "skipped"):
                        existing.add((rec["arch"], rec["shape"], rec["multi_pod"],
                                      rec.get("preset", args.quant)))
                except json.JSONDecodeError:
                    pass
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    for arch in archs:
        for shape_name in shape_names:
            for multi_pod in meshes:
                keyt = (arch, shape_name, multi_pod, args.quant)
                if keyt in existing:
                    print(f"[skip-done] {keyt}", flush=True)
                    continue
                rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                       "preset": args.quant}
                print(f"[dryrun] {arch} x {shape_name} x "
                      f"{'2x16x16' if multi_pod else '16x16'} ...", flush=True)
                t0 = time.monotonic()
                try:
                    rec.update(lower_cell(
                        arch, shape_name, multi_pod=multi_pod, preset=args.quant,
                        grad_accum=args.grad_accum, serve_kv_bits=args.kv_bits,
                        extra_dp=arch in args.extra_dp.split(","),
                        moe_groups=args.moe_groups,
                        bf16_moments=args.bf16_moments))
                except Exception as e:  # record the failure, keep sweeping
                    rec.update({"status": "error", "error": repr(e),
                                "traceback": traceback.format_exc()[-4000:]})
                rec["wall_s"] = round(time.monotonic() - t0, 1)
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(f"  -> {rec['status']} ({rec['wall_s']}s)", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", choices=("all", *ARCH_IDS))
    ap.add_argument("--shape", default="all", choices=("all", *shp.SHAPES))
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--quant", default="w4a4")
    ap.add_argument("--kv-bits", type=int, default=8, dest="kv_bits")
    ap.add_argument("--grad-accum", type=int, default=8, dest="grad_accum")
    ap.add_argument("--bf16-moments", action="store_true", dest="bf16_moments",
                    help="store Adam moments in bf16 (update math stays f32)")
    ap.add_argument("--moe-groups", type=int, default=1, dest="moe_groups",
                    help="MoE dispatch locality groups (0 = auto: DP degree)")
    ap.add_argument("--extra-dp", default="", dest="extra_dp",
                    help="comma list of archs to run with model-axis-as-DP")
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--resume", action="store_true", default=True)
    run(ap.parse_args(argv))


if __name__ == "__main__":
    main()
