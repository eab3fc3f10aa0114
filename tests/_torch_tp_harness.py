"""Subprocess harness for tests/test_torch_tp.py: the port's tensor-parallel
compute on gloo ranks of the CPU.

    PYTHONPATH=src python tests/_torch_tp_harness.py --linears OUT_DIR
    PYTHONPATH=src python tests/_torch_tp_harness.py --train SRC_CKPT OUT_DIR
    PYTHONPATH=src python tests/_torch_tp_harness.py --serve OUT_DIR
    PYTHONPATH=src python tests/_torch_tp_harness.py --vocab OUT_DIR
    PYTHONPATH=src python tests/_torch_tp_harness.py --recurrent DIR

--linears: every case of LINEAR_CASES on a (1, 2) and then a (1, 4) mesh:
each rank cuts the case's whole parameters to its slices by the sharding
rules (`dist.sharding.param_pspecs`), runs the linear tensor-parallel
(`qlinear` / `lm_head_apply` / `embed_lookup` with a `TPSplit`) and
saves its output and the gradients of its leaves and input, in f32, to
OUT_DIR/m{M}_rank{R}.pt. The test runs the whole linear on the same numpy
inputs (`run_case` without a split) and holds the slices against it.

--train: 8 ranks on a (2, 4) mesh, the reduced granite-8b of
tests/_torch_spmd_harness.py (2 layers, d_model 64, 4 heads, d_ff 96,
w4a4 MDQ) restored from SRC_CKPT: the step-0 gradient of the
tensor-parallel step (`make_grad_fn`, gathered leaf by leaf), then 8 steps
of `run_training(model_parallel=4)` (tensor-parallel, the default). Rank
0 writes OUT_DIR/train.pt.

--archs: 2 ranks on a (1, 2) mesh: one reduced arch of each block family
(MoE, local / global attention with softcaps, learned positions with
audio frames, mLSTM / sLSTM, RG-LRU with local attention, cross-attention
over vision patches), w4a4: which sublayers run tensor-parallel, a
forward's logits and the step-0 gradient, gathered. Rank 0 writes
OUT_DIR/archs.pt.

--vocab: 4 ranks, on a (2, 2) and then a (1, 4) mesh: `core.kd`'s losses
with the head's split (`tp`) on each rank's columns of seeded logits
(`loss_inputs`: hard CE, MCKD's sparse soft-CE, `mckd_loss` over 2 views,
the soft CE and the teacher soft-CE, with and without a mask), each
loss's value, its gradient on the rank's columns and the bytes launched
under the use "loss"; then a step-0 `make_grad_fn` of the reduced
qwen1.5-0.5b (`VOCAB_STEP`) with kd "mckd" and "none", tensor-parallel,
against one process: loss_main, the tied head's gradient, the "loss"
bytes and every all-gather's shape. Each rank writes
OUT_DIR/vocab{R}.pt.

--recurrent DIR: every case of BLOCK_CASES on a (1, 2) and then a (1, 4)
mesh: the mLSTM, sLSTM and RG-LRU blocks and the cross-attention sublayer
of the reduced xlstm-350m, recurrentgemma-9b and llama-3.2-vision-11b, on
the parameters the test wrote to DIR/blocks.pt (the JAX package's init),
cut to the rank's slices by the sharding rules and run tensor-parallel
(`run_block`); each rank writes the output and the gradients of its
leaves and input to DIR/rec_m{M}_rank{R}.pt. The 2-rank run also serves
the reduced xlstm-350m sharded (a prefill and 3 decode steps, `prefill_step`
on the rank's slices) beside one process on the gathered params: rank 0
writes both logits to DIR/rec_serve.pt.

--serve: 4 ranks on a (1, 4) mesh: the serving CLI (`launch.serve.main`,
reduced granite-8b, w4a4, int8 KV) with heads, d_ff and vocab split four
ways; each rank writes its engine streams and the tensor-parallel
`greedy_generate` of the same prompts, and rank 0 the tensor-parallel
logits of a prefill and 3 teacher-forced decode steps beside those of the
one-process model on the gathered params.

Not a test module.
"""
from __future__ import annotations

import json
import os
import socket
import sys

import numpy as np
import torch

B, S, D, H, HD, F, V, VOCAB = 2, 3, 32, 4, 8, 48, 48, 45

# name -> (linear, mode, fused route); "auto" is the kernel route (its
# plain version on the CPU), "off" the unfused composition
LINEAR_CASES = {
    "wq_mdq": ("wq", "mdq", "auto"),
    "wq_mdq_off": ("wq", "mdq", "off"),
    "wo_mdq": ("wo", "mdq", "auto"),
    "wo_mdq_off": ("wo", "mdq", "off"),
    "w_in_l1": ("w_in", "mdq", "auto"),
    "w_in_lsq": ("w_in", "lsq", "auto"),
    "w_out_l1": ("w_out", "mdq", "auto"),
    "w_out_lsq": ("w_out", "lsq", "auto"),
    "head_untied": ("lm_head", "mdq", "auto"),
    "head_tied": ("tied", "mdq", "auto"),
    "embed": ("embed", "mdq", "auto"),
}
EQS = {"wq": "bsd,dhk->bshk", "wo": "bshk,hkd->bsd", "w_in": "bsd,df->bsf",
       "w_out": "bsf,fd->bsd"}
SHAPES = {"wq": ((D, H, HD), (1,)), "wo": ((H, HD, D), (0,)), "w_in": ((D, F), ()),
          "w_out": ((F, D), ()), "lm_head": ((D, V), ())}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _linear(rng, name: str, qcfg, bias: bool = False) -> dict:
    from repro_torch.core.policy import act_spec, weight_spec
    from repro_torch.core.quantizer import init_scale
    from repro_torch.models.common import kind_of
    shape, groups = SHAPES[name]
    w = _t(rng.standard_normal(shape) * shape[0] ** -0.5)
    spec = weight_spec(qcfg, kind_of(name))
    p = {"w": w, "w_scale": init_scale(w, spec, groups if spec.granularity != "per_tensor"
                                       else ())}
    if bias:
        p["b"] = _t(rng.standard_normal(shape[1:]) * 0.1)
    if act_spec(qcfg, kind_of(name)) is not None:
        p["a_scale"] = _t(np.float32(0.3 + 0.1 * rng.random()))
        p["a_offset"] = _t(np.float32(-0.2 * rng.random()))
    return p


def case_inputs(case: str) -> dict:
    """The case's whole parameters (a tree the sharding rules walk), its
    input and its output cotangent, from a numpy generator."""
    from repro_torch.core.policy import QuantConfig
    from repro_torch.core.quantizer import init_scale
    from repro_torch.core.policy import weight_spec
    name, mode, route = LINEAR_CASES[case]
    qcfg = QuantConfig(w_bits=4, a_bits=4, mode=mode, fused_matmul=route)
    rng = np.random.default_rng(list(LINEAR_CASES).index(case) + 11)
    if name in EQS:
        tree = {name: _linear(rng, name, qcfg, bias=name == "wq")}
        x = _t(rng.standard_normal((B, S, H, HD) if name == "wo" else
                                   (B, S, F) if name == "w_out" else (B, S, D)))
        out = {"wq": (B, S, H, HD), "w_in": (B, S, F)}.get(name, (B, S, D))
    elif name == "lm_head":
        tree = {"lm_head": _linear(rng, "lm_head", qcfg)}
        x, out = _t(rng.standard_normal((B, S, D))), (B, S, V)
    else:  # the tied head and the embedding: the (V, d) table
        w = _t(rng.standard_normal((V, D)) * 0.5)
        tree = {"embed": {"w": w, "w_scale": init_scale(w, weight_spec(qcfg, "embed"))}}
        if name == "tied":
            tree["lm_head"] = {"a_scale": _t(np.float32(0.2)),
                               "a_offset": _t(np.float32(-0.3))}
            x, out = _t(rng.standard_normal((B, S, D))), (B, S, V)
        else:
            x = torch.from_numpy(rng.integers(0, VOCAB, (B, S)))
            out = (B, S, D)
    dy = _t(rng.standard_normal(out))
    return {"name": name, "qcfg": qcfg, "tree": tree, "x": x, "dy": dy}


def _walk(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def run_case(case: str, mesh=None) -> dict:
    """Output and gradients of one case: the whole linear (mesh None), or
    this rank's slices on `mesh` (a `launch.mesh.HostMesh`), tensor-parallel.
    Returns {"y", "grads": {"x" | leaf path: tensor}, "specs"}."""
    from repro_torch.dist import sharding
    from repro_torch.dist.spmd import TPSplit
    from repro_torch.models import common as C
    c = case_inputs(case)
    name, qcfg, tree, x, dy = c["name"], c["qcfg"], c["tree"], c["x"], c["dy"]
    tp, specs = None, None
    if mesh is not None:
        specs = sharding.param_pspecs(tree, mesh)
        tree = sharding.shard_tree(tree, specs, mesh, mesh.coords)
        m = mesh.shape["model"]
        tp = TPSplit(mesh.group(("model",)), mesh.coords["model"], m)
        if name in ("wo", "w_out"):  # row-parallel: this rank's input columns
            x = tp.local(x, 2)
        if name in ("wq", "w_in"):  # column-parallel: this rank's output columns
            dy = tp.local(dy, 2)
    leaves = dict(_walk(tree))
    live = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    p = {}
    for k, v in live.items():
        node = p
        for key in k[:-1]:
            node = node.setdefault(key, {})
        node[k[-1]] = v
    if name != "embed":
        x = x.clone().requires_grad_(True)
    f32 = torch.float32
    if name in EQS:
        y = C.qlinear(p[name], x, name, qcfg, EQS[name], f32, tp)
    elif name == "lm_head":
        y = C.lm_head_apply(p["lm_head"], x, qcfg, VOCAB, V, tp=tp)
    elif name == "tied":
        y = C.lm_head_apply(p["lm_head"], x, qcfg, VOCAB, V, tied_embed=p["embed"], tp=tp)
    else:
        y = C.embed_lookup(p["embed"], x, qcfg, f32, tp)
    loss = torch.sum(y * dy)
    wrt = list(live.values()) + ([x] if name != "embed" else [])
    gs = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = {"/".join(k): g for k, g in zip(live, gs)}
    if name != "embed":
        grads["x"] = gs[-1]
    return {"y": y.detach(), "grads": grads,
            "specs": None if specs is None else {"/".join(k): s for k, s in _walk_specs(specs)}}


def magnitudes(case: str) -> dict:
    """The size of what each gradient sums, from the whole inputs and the
    kernels' plain quantizers (`kernels.ref`): per element of x, the sum
    over the contraction of |dY| x |Wd|; per 0-d scale, g times the sum
    over its terms of |the cotangent of the dequantized operand| x |the
    quantizer's derivative| (Eq. 7: |q - mf u| for a scale, 1 - mf for an
    offset). A reordered or re-rounded sum is off by a fraction of these,
    whatever the terms' signs cancel to."""
    from repro_torch.core.policy import act_spec, weight_spec
    from repro_torch.core.quantizer import scale_grad_factor
    from repro_torch.kernels import ref
    from repro_torch.models import common as C
    c = case_inputs(case)
    name, qcfg, tree, x, dy = c["name"], c["qcfg"], c["tree"], c["x"], c["dy"]
    if name == "embed":
        p = tree["embed"]
        spec = weight_spec(qcfg, "embed")
        g = scale_grad_factor(spec, p["w"], ())
        return {"embed/w_scale": float(g * dy.abs().sum() * spec.q_p)}
    if name in ("lm_head", "tied"):
        kind, n_k = "lm_head", 1
        if name == "tied":
            p = {"w": tree["embed"]["w"].T, "w_scale": tree["embed"]["w_scale"],
                 **tree["lm_head"]}
            wkey, akey = "embed", "lm_head"
            wspec = weight_spec(qcfg, "embed")
        else:
            p, wkey, akey = tree["lm_head"], "lm_head", "lm_head"
            wspec = weight_spec(qcfg, "lm_head")
        dy = torch.where(torch.arange(V) < VOCAB, dy, 0.0)  # the masked pad columns
    else:
        kind, n_k, p = C.kind_of(name), C.FUSED_EQS[EQS[name]], tree[name]
        wkey = akey = name
        wspec = weight_spec(qcfg, kind)
    aspec = act_spec(qcfg, kind)
    w = p["w"]
    k = int(np.prod(w.shape[:n_k]))
    w2, x2 = w.reshape(k, -1), x.reshape(-1, k)
    dy2 = dy.reshape(x2.shape[0], -1).abs()
    side = C._w_scale_side(tuple(p["w_scale"].shape), tuple(w.shape), n_k)
    ws = (C._scale_rows(p["w_scale"], w.shape, n_k)[:, None] if side == "k" else
          C._scale_cols(p["w_scale"], w.shape, n_k)[None])
    ua, qa, xd = ref._act_codes(x2, p["a_scale"], p["a_offset"], aspec.q_n, aspec.q_p)
    uw, qw, wd = ref._weight_codes(w2, ws, wspec.q_n, wspec.q_p)
    mfa, mfw = ref._in_range(ua, aspec.q_n, aspec.q_p), ref._in_range(uw, wspec.q_n,
                                                                        wspec.q_p)
    dxd, dwd = dy2 @ wd.abs().T, xd.abs().T @ dy2
    g_a = float(scale_grad_factor(aspec, w, ()))
    out = {"x": dxd.reshape(x.shape),
           f"{akey}/a_scale": g_a * float((dxd * (qa - mfa * ua).abs()).sum()),
           f"{akey}/a_offset": g_a * float((dxd * (1 - mfa)).sum())}
    if p["w_scale"].dim() == 0:
        g_w = float(scale_grad_factor(wspec, w, ()))
        out[f"{wkey}/w_scale"] = g_w * float((dwd * (qw - mfw * uw).abs()).sum())
    return out


def _walk_specs(specs, prefix=()):
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            yield from _walk_specs(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _env(rank: int, world: int, port: int) -> None:
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)


def linears_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    _env(rank, world, port)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, "cpu")
    res = {case: run_case(case, mesh) for case in LINEAR_CASES}
    torch.save(res, os.path.join(out_dir, f"m{world}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# training: the reduced granite-8b of the sharded harness, tensor-parallel
# ---------------------------------------------------------------------------

TRAIN_RANKS, TRAIN_MODEL, TRAIN_STEPS = 8, 4, 8


def train_batch(cfg, dcfg, step: int) -> dict:
    from repro_torch.data.synthetic import sample_batch
    return sample_batch(cfg, dcfg, step, 8, 16)


def step0_grads(params, cfg, qcfg, tcfg, dcfg, sp) -> tuple:
    """(loss, grads) of step 0's batch on `sp`'s mesh: this rank's rows,
    the gradient of this rank's slices (`make_grad_fn`)."""
    from repro_torch.train.train_step import make_grad_fn
    batch = sp.rows(train_batch(cfg, dcfg, 0))
    loss, _, grads = make_grad_fn(cfg, qcfg, tcfg, spmd=sp)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.zeros((), dtype=torch.int32))
    return sp.mean(loss), grads


def train_rank(rank: int, port: int, src: str, out_dir: str) -> None:
    _env(rank, TRAIN_RANKS, port)
    import shutil
    import time
    import torch.distributed as dist
    import _torch_spmd_harness as SH
    from repro_torch.dist import sharding, spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import run_training
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import CheckpointManager
    cfg, qcfg, tcfg, dcfg = SH.setup()
    mesh = make_host_mesh(TRAIN_MODEL, "cpu")
    specs = spmd.state_specs(cfg, qcfg, tcfg, mesh)
    like = spmd.init_sharded_state(cfg, qcfg, tcfg, torch.Generator(), mesh, specs)
    state = ckpt.restore(src, like, step=0, shardings=sharding.Layout(mesh, specs))
    sp = spmd.Spmd(mesh, specs["params"], osc_specs=specs["osc"])
    tp = {i: tuple(t is not None for t in M.layer_tp(sp, cfg, i)[:2])
          for i in range(cfg.n_layers)}
    loss0, grads = step0_grads(state["params"], cfg, qcfg, tcfg, dcfg, sp)
    full = spmd.gather_tree(grads, specs["params"], mesh)
    run_dir = os.path.join(out_dir, "run")
    if rank == 0:
        shutil.copytree(src, run_dir)
    dist.barrier()
    t0 = time.perf_counter()
    rep = run_training(cfg, qcfg, tcfg, dcfg, steps=TRAIN_STEPS, batch_size=8,
                       seq_len=16, ckpt_dir=run_dir, log_every=0, device="cpu",
                       model_parallel=TRAIN_MODEL,
                       mgr=CheckpointManager(run_dir, save_every=10 ** 6,
                                             async_io=False))
    if rank == 0:
        embed_tp, head_tp = M.vocab_tp(sp, cfg)
        torch.save({"mesh": mesh.shape, "tp": tp, "embed_tp": embed_tp is not None,
                    "head_tp": head_tp is not None,
                    "loss0": float(loss0), "grads": full, "losses": rep.losses,
                    "grad_norms": rep.grad_norms, "train_s": time.perf_counter() - t0},
                   os.path.join(out_dir, "train.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# serving: the CLI on a (1, 4) mesh, tensor-parallel
# ---------------------------------------------------------------------------

SERVE_RANKS = 4
SERVE_ARGV = ["--device", "cpu", "--smoke", "--quant", "w4a4", "--batch", "3",
              "--slots", "2", "--prompt-len", "8", "--new-tokens", "4", "--chunk", "8"]


def teacher_forced(params, cache, prompts, forced, cfg, qcfg, sp) -> torch.Tensor:
    """f32 logits (B, 1 + F, V) of a one-chunk prefill of `prompts` and F
    decode steps fed `forced`."""
    from repro_torch.models import model as M
    b, plen = prompts.shape
    pos = torch.arange(plen, dtype=torch.int32)[None].expand(b, plen)
    lg, cache = M.prefill_step(params, cache, {"tokens": prompts, "pos": pos},
                               cfg, qcfg, spmd=sp)
    outs = [lg[:, -1]]
    for j in range(forced.shape[1]):
        p = torch.full((b,), plen + j, dtype=torch.int32)
        lg, cache = M.decode_step(params, cache, {"tokens": forced[:, j:j + 1],
                                                  "pos": p}, cfg, qcfg, spmd=sp)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1).float()


def serve_rank(rank: int, port: int, out_dir: str) -> None:
    _env(rank, SERVE_RANKS, port)
    import torch.distributed as dist
    from repro_torch.dist import spmd
    from repro_torch.dist.spmd import WHOLE
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    run = serve.main(SERVE_ARGV + ["--model-parallel", str(SERVE_RANKS)])
    sp, cfg, qcfg = run.spmd, run.cfg, run.qcfg
    rows = int(run.engine.executor.pool["layers"][0]["kv"].k.shape[1])
    cache_len = rows * SERVE_RANKS
    prompts = torch.from_numpy(run.prompts)
    new = int(SERVE_ARGV[SERVE_ARGV.index("--new-tokens") + 1])
    step = lambda p, c, x: M.prefill_step(p, c, x, cfg, qcfg, spmd=sp)  # noqa: E731
    toks, _ = serve.greedy_generate(step, run.params,
                                    M.init_cache(cfg, qcfg, len(prompts), cache_len,
                                                 "cpu", spmd=sp), prompts, new)
    streams = {k: v.tokens for k, v in run.engine.results.items()}
    forced = torch.tensor([streams[f"req-{i}"][:3] for i in range(len(prompts))],
                          dtype=torch.int32)
    tp_logits = teacher_forced(run.params, M.init_cache(cfg, qcfg, len(prompts),
                                                        cache_len, "cpu", spmd=sp),
                               prompts, forced, cfg, qcfg, sp)
    full = spmd.gather_tree(run.params, sp.pspecs, sp.mesh)
    res = {"streams": streams, "greedy": toks.tolist(), "kv_rows": rows,
           "tp": [tuple(t is not None for t in M.layer_tp(sp, cfg, i)[:2])
                  for i in range(cfg.n_layers)],
           "embed_tp": M.vocab_tp(sp, cfg)[0] is not None,
           "head_tp": M.vocab_tp(sp, cfg)[1] is not None}
    if rank == 0:
        res["tp_logits"] = tp_logits
        res["one_logits"] = teacher_forced(full, M.init_cache(cfg, qcfg, len(prompts),
                                                              cache_len, "cpu"),
                                           prompts, forced, cfg, qcfg, WHOLE)
        res["vocab"] = cfg.vocab_size
    torch.save(res, os.path.join(out_dir, f"serve{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# every block family on a (1, 2) mesh: what runs tensor-parallel, and the
# forward and step-0 gradient against one process
# ---------------------------------------------------------------------------

ARCH_RANKS = 2
ARCHS = ("granite-moe-1b-a400m", "gemma2-2b", "musicgen-medium", "xlstm-350m",
         "recurrentgemma-9b", "llama-3.2-vision-11b")


def arch_case(arch: str, sp=None, full=None, route: str = "auto") -> dict:
    """The reduced `arch` (w4a4, `route` the fused_matmul setting): its
    seed-0 params, a forward's logits and the step-0 gradient of a 2 x 16
    batch (hard labels), on `sp`'s mesh (this rank's slices of `full`) or
    whole (sp None)."""
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import get_preset
    from repro_torch.data.synthetic import DataConfig, sample_batch
    from repro_torch.dist import sharding, spmd
    from repro_torch.models import model as M
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.train_step import make_grad_fn
    cfg = reduced_config(get_config(arch))
    qcfg = get_preset("w4a4").replace(fused_matmul=route)
    if full is None:
        full = M.init_params(cfg, qcfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             sample_batch(cfg, DataConfig(), 0, 2, 16).items()}
    params, out = full, {}
    if sp is not None:
        params = sharding.shard_tree(full, sp.pspecs, sp.mesh, sp.mesh.coords)
        out["tp"] = [[t is not None for t in M.layer_tp(sp, cfg, i)[:3]]
                     for i in range(cfg.n_layers)]
        out["head_tp"] = M.vocab_tp(sp, cfg)[1] is not None
    kw = {} if sp is None else {"spmd": sp}
    with torch.no_grad():
        out["logits"] = M.forward(params, batch, cfg, qcfg, **kw)[0].float()
    _, _, grads = make_grad_fn(cfg, qcfg, TrainConfig(), **kw)(
        params, batch, torch.zeros((), dtype=torch.int32))
    if sp is not None:
        grads = spmd.gather_tree(grads, sp.pspecs, sp.mesh)
    out["grads"] = grads
    return out


def archs_rank(rank: int, port: int, out_dir: str) -> None:
    _env(rank, ARCH_RANKS, port)
    import torch.distributed as dist
    from repro_torch.dist import sharding, spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import get_preset
    from repro_torch.models import model as M
    mesh = make_host_mesh(ARCH_RANKS, "cpu")
    res = {}
    for arch in ARCHS:
        full = M.init_params(reduced_config(get_config(arch)), get_preset("w4a4"),
                             torch.Generator().manual_seed(0), "cpu")
        sp = spmd.Spmd(mesh, sharding.param_pspecs(full, mesh))
        res[arch] = arch_case(arch, sp, full)
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "archs.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the recurrent blocks and the cross-attention sublayer on their slices
# ---------------------------------------------------------------------------

BLOCK_ARCH = {"mlstm": "xlstm-350m", "slstm": "xlstm-350m",
              "rglru": "recurrentgemma-9b", "cross": "llama-3.2-vision-11b"}
# mode -> (quantization, compute dtype, fused route): fp weights at f32;
# w4a4 MDQ at bf16 unfused (the JAX package's route on the CPU) and on the
# kernel route (its plain versions here; the card's route)
BLOCK_MODES = {"f32": ("fp", "float32", "auto"), "w4a4": ("w4a4", "bfloat16", "off"),
               "w4a4_kernel": ("w4a4", "bfloat16", "auto")}
BLOCK_CASES = tuple((b, m) for b in BLOCK_ARCH for m in BLOCK_MODES)
BLOCK_B, BLOCK_S, BLOCK_CHUNK = 2, 16, 8
BLOCK_RANKS = (2, 4)
SERVE_PROMPT, SERVE_FORCED = 8, 3


def block_setup(block: str, mode: str) -> tuple:
    """(cfg, qcfg, compute dtype) of a case: the arch's reduced config
    (d_model 64, 4 heads, lru_width 64) at the mode's dtype."""
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import QuantConfig
    quant, dtype, route = BLOCK_MODES[mode]
    cfg = reduced_config(get_config(BLOCK_ARCH[block])).replace(dtype=dtype)
    qcfg = (QuantConfig(mode="off") if quant == "fp" else
            QuantConfig(w_bits=4, a_bits=4, mode="mdq", fused_matmul=route))
    return cfg, qcfg, torch.float32 if dtype == "float32" else torch.bfloat16


def block_inputs(block: str, mode: str) -> dict:
    """Seeded numpy f32 inputs of a case: x and the output cotangent dy (B,
    S, d), and for the cross sublayer the patch embeddings (B, P, d)."""
    cfg, _, _ = block_setup(block, mode)
    rng = np.random.default_rng(BLOCK_CASES.index((block, mode)) + 101)
    d = cfg.d_model
    out = {"x": rng.standard_normal((BLOCK_B, BLOCK_S, d)).astype(np.float32) * 0.5,
           "dy": rng.standard_normal((BLOCK_B, BLOCK_S, d)).astype(np.float32)}
    if block == "cross":
        out["embeds"] = rng.standard_normal(
            (BLOCK_B, cfg.n_frontend_tokens, d)).astype(np.float32) * 0.5
    return out


def block_names(block: str) -> tuple:
    """The linears a case splits (`models.model.layer_tp`'s names)."""
    from repro_torch.models import model as M
    return {"mlstm": M.MLSTM_LINEARS, "slstm": M.SLSTM_FFN, "rglru": M.RGLRU_LINEARS,
            "cross": M.CROSS_LINEARS}[block]


def run_block(block: str, mode: str, tree: dict, mesh=None) -> dict:
    """A case's output and gradients (`block_inputs`' dy as the output
    cotangent): the whole block on `tree` (mesh None), or on `mesh`
    tensor-parallel, its split linears cut to this rank's slices by the
    sharding rules. Returns {"y" (f32), "dx", "grads": {leaf path:
    gradient}, "specs": {a split leaf's path: its spec}}."""
    from repro_torch.dist import sharding
    from repro_torch.dist.spmd import Spmd
    from repro_torch.models import model as M
    from repro_torch.models import recurrent as R
    cfg, qcfg, cd = block_setup(block, mode)
    inp = {k: torch.from_numpy(v) for k, v in block_inputs(block, mode).items()}
    tp = specs = None
    if mesh is not None:  # the split linears' slices; the rest whole, as
        names = block_names(block)  # `Spmd.gather` gives it
        specs = sharding.param_pspecs(tree, mesh)
        tp = Spmd(mesh, specs).tp((), names)
        assert tp is not None, block
        specs = {k: v for k, v in specs.items() if k in names}
        tree = {k: sharding.shard_tree(v, specs[k], mesh, mesh.coords) if k in names
                else v for k, v in tree.items()}
    live = {k: v.clone().requires_grad_(True) for k, v in _walk(tree)}
    p: dict = {}
    for k, v in live.items():
        node = p
        for key in k[:-1]:
            node = node.setdefault(key, {})
        node[k[-1]] = v
    x = inp["x"].to(cd).requires_grad_(True)
    if block == "mlstm":
        y, _ = R.mlstm_block(p, x, cfg, qcfg, cd, chunk=BLOCK_CHUNK, tp=tp)
    elif block == "slstm":
        y, _ = R.slstm_block(p, x, cfg, qcfg, cd, tp=tp)
    elif block == "rglru":
        y, _ = R.rglru_block(p, x, cfg, qcfg, cd, tp=tp)
    else:
        kv = M.cross_kv(p, inp["embeds"].to(cd), cfg, qcfg, cd, tp)
        y = M._cross_sublayer(p, x, kv, cfg, qcfg, cd, tp)
    gs = torch.autograd.grad(torch.sum(y.float() * inp["dy"]), list(live.values()) + [x],
                             allow_unused=True)  # the sLSTM's s_r reads no activation
    return {"y": y.detach().float(), "dx": gs[-1].float(),
            "grads": {"/".join(k): g for k, g in zip(live, gs) if g is not None},
            "specs": None if specs is None else {"/".join(k): s for k, s in _walk_specs(specs)}}


def xlstm_serving(sp, full: dict) -> torch.Tensor:
    """Logits of a one-chunk prefill and SERVE_FORCED decode steps of the
    reduced xlstm-350m (w4a4 serving params `full`), on `sp`'s mesh (this
    rank's slices) or whole."""
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding
    from repro_torch.models import model as M
    cfg, qcfg = reduced_config(get_config("xlstm-350m")), get_preset("w4a4")
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, SERVE_PROMPT + SERVE_FORCED))
                            .astype(np.int32))
    params = full if sp.whole else sharding.shard_tree(full, sp.pspecs, sp.mesh,
                                                       sp.mesh.coords)
    cache = M.init_cache(cfg, qcfg, 2, SERVE_PROMPT + SERVE_FORCED, "cpu", spmd=sp)
    return teacher_forced(params, cache, toks[:, :SERVE_PROMPT], toks[:, SERVE_PROMPT:],
                          cfg, qcfg, sp)


def recurrent_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    _env(rank, world, port)
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding, spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    mesh = make_host_mesh(world, "cpu")
    trees = torch.load(os.path.join(out_dir, "blocks.pt"))
    res = {case: run_block(*case, trees[case], mesh) for case in BLOCK_CASES}
    torch.save(res, os.path.join(out_dir, f"rec_m{world}_rank{rank}.pt"))
    if world == BLOCK_RANKS[0]:
        cfg, qcfg = reduced_config(get_config("xlstm-350m")), get_preset("w4a4")
        full = M.init_serving_params(cfg, qcfg, torch.Generator().manual_seed(0), "cpu")
        sp = spmd.Spmd(mesh, sharding.param_pspecs(full, mesh), ordered_sums=True)
        split = [M.layer_tp(sp, cfg, i, training=False)[:3] for i in range(cfg.n_layers)]
        logits = xlstm_serving(sp, full)
        if rank == 0:
            torch.save({"sharded": logits, "one": xlstm_serving(spmd.WHOLE, full),
                        "split": [[t is not None for t in lt] for lt in split],
                        "head_tp": M.vocab_tp(sp, cfg)[1] is not None},
                       os.path.join(out_dir, "rec_serve.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# vocab-parallel losses on (2, 2) and (1, 4)
# ---------------------------------------------------------------------------

VOCAB_RANKS, VOCAB_MODELS = 4, (2, 4)
# name -> (vocab, final softcap), over a padded vocab of LOSS_VP: 16
# columns a rank at M 4 (32 at M 2); "pad_rank" leaves M 4's last rank
# nothing but padding
LOSS_CASES = {"plain": (62, 0.0), "softcap": (62, 30.0), "pad_rank": (45, 0.0)}
LOSS_VP, LOSS_B, LOSS_S, LOSS_K, LOSS_T = 64, 2, 6, 4, 2.0
LOSSES = ("hard", "hard_mask", "sparse", "sparse_mask", "mckd", "soft",
          "teacher", "teacher_mask")
# the reduced qwen1.5-0.5b step: batch, sequence
VOCAB_STEP = (4, 16)


def loss_inputs(case: str) -> dict:
    """Seeded numpy inputs of a loss case over the whole padded vocab: two
    views of logits (the first the single-view losses'), labels and top-K
    ids on rank boundaries and at the last id, a row of spikes on the
    other half of the vocab from its label (so its max lies on another
    rank at M 2 and 4), a mask, teacher logits and their probabilities."""
    vocab, cap = LOSS_CASES[case]
    rng = np.random.default_rng(sorted(LOSS_CASES).index(case))
    shape = (LOSS_B, LOSS_S)
    x = rng.normal(size=(2,) + shape + (LOSS_VP,)) * 3.0
    labels = rng.integers(0, vocab, size=shape)
    labels[0] = [0, 15, 16, 31, 32, vocab - 1]
    for s_ in range(LOSS_S):
        lab = labels[1, s_]
        x[:, 1, s_, lab + 32 if lab < 32 else lab - 32] += 12.0
    if cap > 0.0:
        x = cap * np.tanh(x / cap)
    x[..., vocab:] = -1e9
    ids = rng.integers(0, vocab, size=(2,) + shape + (LOSS_K,))
    ids[..., 0] = labels
    ids[:, 0, 0] = [0, 15, 16, 31]
    ids[:, 0, 1] = [32, min(47, vocab - 1), min(48, vocab - 1), vocab - 1]
    p = rng.dirichlet(np.ones(LOSS_K), size=(2,) + shape)
    t = rng.normal(size=shape + (LOSS_VP,)) * 2.0
    t[..., vocab:] = -1e9
    e = np.exp(t - t.max(-1, keepdims=True))
    return {"x": x.astype(np.float32), "labels": labels.astype(np.int32),
            "ids": ids.astype(np.int32), "p": p.astype(np.float32),
            "mask": (rng.random(shape) < 0.7).astype(np.float32),
            "teacher": t.astype(np.float32),
            "probs": (e / e.sum(-1, keepdims=True)).astype(np.float32)}


def loss_of(name: str, x, inp: dict, tp=None):
    """Loss `name` of `LOSSES` on logits x (2, B, S, C): the whole vocab
    (tp None) or the rank's columns; inp's tensors whole."""
    from repro_torch.core import kd
    mask = inp["mask"] if name.endswith("_mask") else None
    kind = name.removesuffix("_mask")
    if kind == "hard":
        return kd.hard_ce(x[0], inp["labels"], mask, tp=tp)
    if kind == "sparse":
        return kd.sparse_soft_ce(x[0], inp["ids"][0], inp["p"][0], mask, tp=tp)
    if kind == "mckd":
        return kd.mckd_loss(x, inp["ids"], inp["p"], tp=tp)
    if kind == "soft":
        probs = inp["probs"] if tp is None else tp.local(inp["probs"], -1)
        return kd.soft_ce(x[0], probs, mask, tp=tp)
    return kd.kd_from_teacher_logits(x[0], inp["teacher"], LOSS_T, mask, tp=tp)


def loss_cases_on(tp) -> dict:
    """{case: {loss: (value, gradient of the rank's columns, "loss" bytes)}}."""
    from repro_torch.dist import spmd
    out = {}
    for case in LOSS_CASES:
        inp = {k: torch.from_numpy(v) for k, v in loss_inputs(case).items()}
        out[case] = {}
        for name in LOSSES:
            x = tp.local(inp["x"], -1).clone().requires_grad_(True)
            spmd.reset_moved_bytes()
            loss = loss_of(name, x, inp, tp)
            moved = spmd.moved_bytes_by_use().get("loss", 0)
            (g,) = torch.autograd.grad(loss, x)
            assert spmd.moved_bytes_by_use().get("loss", 0) == moved  # none backward
            out[case][name] = (float(loss.detach()), g, moved)
    return out


def vocab_step(sp, kd_mode: str, full: dict) -> dict:
    """Step 0 of the reduced qwen1.5-0.5b on `sp` (this rank's slices of
    `full`; whole where sp is WHOLE): loss_main over the data ranks, the
    gathered gradient of the tied table, the bytes by use and the shape of
    every all-gather launched."""
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import get_preset
    from repro_torch.data.mckd_store import synthetic_kd_labels
    from repro_torch.data.synthetic import DataConfig, sample_batch
    from repro_torch.dist import sharding, spmd
    from repro_torch.launch import cost
    from repro_torch.train.state import TrainConfig
    from repro_torch.train.train_step import make_grad_fn
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    tcfg = TrainConfig(kd=kd_mode)
    batch = sample_batch(cfg, DataConfig(), 0, *VOCAB_STEP)
    if kd_mode == "mckd":
        batch["kd_idx"], batch["kd_p"] = synthetic_kd_labels(
            batch["labels"], cfg.vocab_size, tcfg.kd_topk)
    params = full
    if not sp.whole:
        batch = sp.rows(batch)
        params = sharding.shard_tree(full, sp.pspecs, sp.mesh, sp.mesh.coords)
    gathers = []
    record = cost.record_collective

    def spy(kind, out):
        if kind == "gather":
            gathers.append(tuple(out.shape))
        record(kind, out)

    cost.record_collective = spy
    spmd.reset_moved_bytes()
    try:
        _, metrics, grads = make_grad_fn(cfg, get_preset("w4a4"), tcfg, spmd=sp)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.zeros((), dtype=torch.int32))
    finally:
        cost.record_collective = record
    by_use = spmd.moved_bytes_by_use()
    if not sp.whole:
        grads = spmd.gather_tree(grads, sp.pspecs, sp.mesh)
    return {"loss_main": float(sp.mean(metrics["loss_main"])),
            "table_grad": grads["embed"]["w"], "by_use": by_use,
            "gathers": gathers, "rows": int(batch["tokens"].size)}


def vocab_rank(rank: int, port: int, out_dir: str) -> None:
    _env(rank, VOCAB_RANKS, port)
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding, spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    full = M.init_params(cfg, get_preset("w4a4"), torch.Generator().manual_seed(0), "cpu")
    res = {}
    for m in VOCAB_MODELS:
        mesh = make_host_mesh(m, "cpu")
        sp = spmd.Spmd(mesh, sharding.param_pspecs(full, mesh))
        tp = spmd.TPSplit(mesh.group(("model",)), mesh.coords["model"], m)
        res[m] = {"coords": mesh.coords, "losses": loss_cases_on(tp),
                  "head_tp": M.vocab_tp(sp, cfg)[1] is not None,
                  "step": {k: vocab_step(sp, k, full) for k in ("mckd", "none")}}
    if rank == 0:
        res["one"] = {k: vocab_step(spmd.WHOLE, k, full) for k in ("mckd", "none")}
    torch.save(res, os.path.join(out_dir, f"vocab{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    import torch.multiprocessing as mp
    if sys.argv[1] == "--linears":
        for m in (2, 4):
            mp.spawn(linears_rank, args=(m, free_port(), sys.argv[2]), nprocs=m,
                     join=True)
    elif sys.argv[1] == "--train":
        mp.spawn(train_rank, args=(free_port(), sys.argv[2], sys.argv[3]),
                 nprocs=TRAIN_RANKS, join=True)
    elif sys.argv[1] == "--archs":
        mp.spawn(archs_rank, args=(free_port(), sys.argv[2]), nprocs=ARCH_RANKS,
                 join=True)
    elif sys.argv[1] == "--vocab":
        mp.spawn(vocab_rank, args=(free_port(), sys.argv[2]), nprocs=VOCAB_RANKS,
                 join=True)
    elif sys.argv[1] == "--recurrent":
        for m in BLOCK_RANKS:
            mp.spawn(recurrent_rank, args=(m, free_port(), sys.argv[2]), nprocs=m,
                     join=True)
    elif sys.argv[1] == "--serve":
        mp.spawn(serve_rank, args=(free_port(), sys.argv[2]), nprocs=SERVE_RANKS,
                 join=True)
    else:
        raise SystemExit(f"unknown mode {sys.argv[1]}")
