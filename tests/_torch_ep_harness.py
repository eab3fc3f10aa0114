"""Subprocess harness for tests/test_torch_ep.py: the port's split MoE
experts on gloo ranks of the CPU.

    PYTHONPATH=src python tests/_torch_ep_harness.py OUT_DIR
    PYTHONPATH=src python tests/_torch_ep_harness.py --obr OUT_DIR

Without a mode, two groups of ranks run at once:

* 2 ranks, a (1, 2) mesh: every case of EXPERT_CASES twice, on
  EP_EXPERTS experts (the rules split the expert axis: expert
  parallelism) and on 3 (only d_ff divides: tensor parallelism within the
  experts); then the MoE FFNs of OUT_DIR/moe_case.npz (the reduced
  granite-moe's, 4 experts, from the JAX package's test: expert-parallel)
  and OUT_DIR/moe_case_tp.npz (the same cut to 3 experts: d_ff split) on
  both of the port's routes, and the reduced granite-moe's cut to 3
  experts from the port's init (`moe_ffn_tp`, with its input's gradient);
  then the MoE FFN of OUT_DIR/dp_case.npz routed over 2 data ranks
  (DP_CASES on a (2, 1) mesh: `dp_moe`). Each rank writes
  OUT_DIR/m2_rank{R}.pt.
* 4 ranks: the cases on a (1, 4) mesh (EP_EXPERTS experts, then 6); the
  DP_CASES of 4 ranks ((4, 1), and (2, 2) with the experts split); the
  reduced granite-moe's QAT (`run_training(model_parallel=2)`, a (2, 2)
  mesh, TRAIN_STEPS steps) from the checkpoint in OUT_DIR/src (the JAX
  package's init state, bridged), with the capacity buffers' rows it ran
  (`models.moe.buffer_rows`); and the serving CLI on a (1, 4) mesh
  (each rank 1 expert) with the expert-parallel `greedy_generate` of the
  same prompts. Each rank writes OUT_DIR/m4_rank{R}.pt.

--obr (tests/test_torch_obr_sharded.py): 4 ranks take OBR (Eq. 10) and
the oscillation fraction on their slices of OBR_CASES' leaves, on a
(2, 2) and a (1, 4) mesh (`obr_rank`), and write OUT_DIR/obr_rank{R}.pt.

A case's rank cuts the case's whole parameters to its slices by the
sharding rules (`dist.sharding.param_pspecs`), runs the expert linear on
them (`qlinear` with a `TPSplit`) and saves its output, the gradients of
its leaves and input, and its g factors, in f32. The test runs the whole
linear on the same numpy inputs (`run_case` without a mesh) and holds the
slices against it.

Not a test module.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from _torch_tp_harness import _env, _t, _walk, free_port

G, C, D, F = 2, 8, 32, 48
EP_EXPERTS = 4
TP_EXPERTS = {2: 3, 4: 6}  # experts that do not divide the model axis

# name -> (linear, mode, route): "auto" the kernel route (its plain
# version on the CPU), "off" the unfused composition, "serve" int codes
# (packed int4 along the contraction) through the expert fallback
EXPERT_CASES = {
    "moe_in_mdq": ("moe_in", "mdq", "auto"),
    "moe_in_mdq_off": ("moe_in", "mdq", "off"),
    "moe_in_lsq": ("moe_in", "lsq", "auto"),
    "moe_in_lsq_off": ("moe_in", "lsq", "off"),
    "moe_in_serve": ("moe_in", "mdq", "serve"),
    "moe_out_mdq": ("moe_out", "mdq", "auto"),
    "moe_out_mdq_off": ("moe_out", "mdq", "off"),
    "moe_out_lsq": ("moe_out", "lsq", "auto"),
    "moe_out_lsq_off": ("moe_out", "lsq", "off"),
    "moe_out_serve": ("moe_out", "mdq", "serve"),
}
EQS = {"moe_in": "gecd,edf->gecf", "moe_out": "gecf,efd->gecd"}


def case_inputs(case: str, n_experts: int) -> dict:
    """The case's whole parameters (a tree the sharding rules walk), its
    input and its output cotangent, from a numpy generator."""
    from repro_torch.core.policy import QuantConfig, act_spec, weight_spec
    from repro_torch.core.quantizer import init_scale
    from repro_torch.models.common import convert_to_serving, kind_of
    name, mode, route = EXPERT_CASES[case]
    qcfg = QuantConfig(w_bits=4, a_bits=4, mode=mode,
                       fused_matmul="auto" if route == "serve" else route)
    rng = np.random.default_rng(list(EXPERT_CASES).index(case) + 7 * n_experts)
    k, n = (D, F) if name == "moe_in" else (F, D)
    w = _t(rng.standard_normal((n_experts, k, n)) * k ** -0.5)
    spec = weight_spec(qcfg, kind_of(name))
    p = {"w": w, "w_scale": init_scale(w, spec, (0,) if spec.granularity != "per_tensor"
                                       else ())}
    if act_spec(qcfg, kind_of(name)) is not None:
        p["a_scale"] = _t(np.float32(0.3 + 0.1 * rng.random()))
        p["a_offset"] = _t(np.float32(-0.2 * rng.random()))
    x = _t(rng.standard_normal((G, n_experts, C, k)))
    dy = _t(rng.standard_normal((G, n_experts, C, n)))
    tree = {name: p}
    if route == "serve":
        tree = convert_to_serving(tree, qcfg)
    return {"name": name, "qcfg": qcfg, "tree": tree, "x": x, "dy": dy,
            "serve": route == "serve"}


def _model_dim(spec):
    for d, entry in enumerate(spec or ()):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return d
    return None


def g_factors(p: dict, name: str, qcfg, tp=None) -> dict:
    """The weight scale's and the activation quantizer's g factors of a
    latent linear (tp: its slice, cut along `tp.dim`)."""
    from repro_torch.core.policy import act_spec, weight_spec
    from repro_torch.core.quantizer import scale_grad_factor
    from repro_torch.models.common import kind_of
    w = p["w"].detach()
    return {"w_scale": scale_grad_factor(weight_spec(qcfg, kind_of(name)), w,
                                         tuple(p["w_scale"].shape), tp),
            "a_scale": scale_grad_factor(act_spec(qcfg, kind_of(name)), w, (), tp)}


def run_case(case: str, n_experts: int, mesh=None) -> dict:
    """Output, gradients and g factors of one case: the whole linear (mesh
    None), or this rank's slices on `mesh` (a `launch.mesh.HostMesh`).
    Returns {"y", "grads": {"x" | leaf path: tensor}, "g", "specs",
    "experts"}."""
    from repro_torch.dist import sharding
    from repro_torch.dist.spmd import TPSplit
    from repro_torch.models import common as C_
    c = case_inputs(case, n_experts)
    name, qcfg, tree, x, dy = c["name"], c["qcfg"], c["tree"], c["x"], c["dy"]
    tp, specs, experts = None, None, False
    if mesh is not None:
        specs = sharding.param_pspecs(tree, mesh)
        tree = sharding.shard_tree(tree, specs, mesh, mesh.coords)
        wkey = "w" if "w" in tree[name] else ("codes4" if "codes4" in tree[name] else "codes")
        experts = _model_dim(specs[name][wkey]) == 0
        tp = TPSplit(mesh.group(("model",)), mesh.coords["model"], mesh.shape["model"],
                     experts=experts)
        if experts:  # this rank's experts' rows of the buffer and of dY
            dy = tp.local(dy, 1)
        elif name == "moe_out":  # row-parallel: this rank's input columns
            x = tp.local(x, 3)
        else:  # column-parallel: this rank's output columns
            dy = tp.local(dy, 3)
    if c["serve"]:
        xin = tp.split_model(x, 1) if experts else x
        with torch.no_grad():
            y = C_.qlinear(tree[name], xin, name, qcfg, EQS[name], torch.float32, tp)
        return {"y": y, "grads": {}, "g": {}, "specs": None, "experts": experts}
    leaves = dict(_walk(tree))
    live = {k: v.clone().requires_grad_(True) for k, v in leaves.items()}
    p = {k[-1]: v for k, v in live.items()}
    x = x.clone().requires_grad_(True)
    xin = tp.split_model(x, 1) if experts else x
    y = C_.qlinear(p, xin, name, qcfg, EQS[name], torch.float32, tp)
    loss = torch.sum(y * dy)
    gs = torch.autograd.grad(loss, list(live.values()) + [x])
    grads = {"/".join(k): g for k, g in zip(live, gs)}
    grads["x"] = gs[-1]
    dim = None if tp is None else C_._tp_dim(name, tp)
    g = g_factors(p, name, qcfg, None if tp is None else tp._replace(dim=dim))
    return {"y": y.detach(), "grads": grads, "g": g, "experts": experts,
            "specs": None if specs is None else {"/".join(k): s for k, s
                                                 in _walk(specs)}}


def magnitudes(case: str, n_experts: int) -> dict:
    """The size of what each gradient that sums over ranks sums, from the
    whole inputs and the kernels' plain quantizers (`kernels.ref`), expert
    by expert: per element of x, the sum over the contraction of |dY| x
    |Wd|; per scale, g times the sum over its terms of |the cotangent of
    the dequantized operand| x |the quantizer's derivative| (Eq. 7)."""
    from repro_torch.core.policy import act_spec, weight_spec
    from repro_torch.kernels import ref
    from repro_torch.models.common import kind_of
    c = case_inputs(case, n_experts)
    name, qcfg, x, dy = c["name"], c["qcfg"], c["x"], c["dy"]
    p = c["tree"][name]
    aspec, wspec = act_spec(qcfg, kind_of(name)), weight_spec(qcfg, kind_of(name))
    g = g_factors(p, name, qcfg)
    ws = torch.broadcast_to(p["w_scale"].reshape(-1, 1, 1) if p["w_scale"].dim()
                            else p["w_scale"], (n_experts, 1, p["w"].shape[2]))
    dxm, sa, so, sw = [], 0.0, 0.0, []
    for e in range(n_experts):
        x2 = x[:, e].reshape(-1, x.shape[-1])
        dy2 = dy[:, e].reshape(x2.shape[0], -1).abs()
        ua, qa, xd = ref._act_codes(x2, p["a_scale"], p["a_offset"], aspec.q_n, aspec.q_p)
        uw, qw, wd = ref._weight_codes(p["w"][e], ws[e], wspec.q_n, wspec.q_p)
        mfa = ref._in_range(ua, aspec.q_n, aspec.q_p)
        mfw = ref._in_range(uw, wspec.q_n, wspec.q_p)
        dxd, dwd = dy2 @ wd.abs().T, xd.abs().T @ dy2
        dxm.append(dxd.reshape(G, C, -1))
        sa += float((dxd * (qa - mfa * ua).abs()).sum())
        so += float((dxd * (1 - mfa)).sum())
        sw.append(float((dwd * (qw - mfw * uw).abs()).sum()))
    gw = g["w_scale"]
    out = {"x": torch.stack(dxm, 1),
           f"{name}/a_scale": float(g["a_scale"]) * sa,
           f"{name}/a_offset": float(g["a_scale"]) * so}
    if gw.dim() == 0:
        out[f"{name}/w_scale"] = float(gw) * sum(sw)
    else:
        out[f"{name}/w_scale"] = gw * torch.tensor(sw).reshape(gw.shape)
    return out


def cases_on(mesh) -> dict:
    m = mesh.shape["model"]
    return {(case, e): run_case(case, e, mesh) for e in (EP_EXPERTS, TP_EXPERTS[m])
            for case in EXPERT_CASES}


# ---------------------------------------------------------------------------
# the MoE FFN, expert-parallel, on the JAX package's test inputs
# ---------------------------------------------------------------------------

def moe_config():
    from repro_torch.configs.registry import get_config, reduced_config
    return reduced_config(get_config("granite-moe-1b-a400m"))


def moe_ffn_split(path: str, mesh) -> dict:
    """The port's `moe_ffn` on this rank's slices of the numpy params in
    `path` (flattened "a/b" keys; the reduced granite-moe with as many
    experts as the router has columns), for both of the port's routes:
    expert-parallel where the experts divide the model axis, else d_ff
    split within each expert."""
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding, spmd
    from repro_torch.models.moe import moe_ffn
    data = np.load(path)
    p: dict = {}
    for key in data.files:
        if key != "x":
            lin, leaf = key.split("/")
            p.setdefault(lin, {})[leaf] = torch.from_numpy(data[key])
    cfg = moe_config().replace(n_experts=int(p["router"]["w"].shape[1]))
    tree = {"moe": p}
    specs = sharding.param_pspecs(tree, mesh)
    sp = spmd.Spmd(mesh, specs)
    names = ("moe_in", "moe_gate", "moe_out")
    tp = sp.tp(("moe",), names)._replace(experts=sp.experts(("moe", "moe_in")))
    local = sharding.shard_tree(tree, specs, mesh, mesh.coords)["moe"]
    full = sp.gather(("moe",), local, names)
    x = torch.from_numpy(data["x"]).to(torch.bfloat16)
    out = {"experts": tp.experts, "local_experts": int(full["moe_in"]["w"].shape[0]),
           "local_ff": int(full["moe_in"]["w"].shape[2]),
           "router_rows": int(full["router"]["w"].shape[1])}
    for route in ("auto", "off"):
        qcfg = get_preset("w4a4").replace(fused_matmul=route)
        y, aux = moe_ffn(full, x, cfg, qcfg, torch.bfloat16, tp)
        out[route] = {"y": y.float(), "lb_loss": float(aux["lb_loss"]),
                      "drop_frac": float(aux["drop_frac"])}
    return out


def moe_ffn_tp(mesh, n_experts: int = 3) -> dict:
    """The port's `moe_ffn` of the reduced granite-moe cut to `n_experts`
    (only d_ff divides the model axis: tensor parallelism within the
    experts), from seed-0 params, on this rank's slices: its output, aux
    and the gradient of its input."""
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding, spmd
    from repro_torch.models.moe import moe_ffn, moe_init
    cfg = moe_config().replace(n_experts=n_experts)
    qcfg = get_preset("w4a4")
    tree = {"moe": moe_init(torch.Generator().manual_seed(0), cfg, qcfg)}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    names = ("moe_in", "moe_gate", "moe_out")
    if mesh is None:
        p, tp = tree["moe"], None
    else:
        specs = sharding.param_pspecs(tree, mesh)
        sp = spmd.Spmd(mesh, specs)
        tp = sp.tp(("moe",), names)._replace(experts=sp.experts(("moe", "moe_in")))
        p = sp.gather(("moe",), sharding.shard_tree(tree, specs, mesh, mesh.coords)["moe"],
                      names)
    x = x.clone().requires_grad_(True)
    y, aux = moe_ffn(p, x, cfg, qcfg, torch.bfloat16, tp)
    (dx,) = torch.autograd.grad(torch.sum(y.float() * torch.cos(
        torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape))), [x])
    return {"experts": tp is not None and tp.experts, "split": tp is not None,
            "y": y.detach().float(), "dx": dx.float(),
            "lb_loss": float(aux["lb_loss"].detach()),
            "drop_frac": float(aux["drop_frac"])}


# ---------------------------------------------------------------------------
# the MoE FFN on data ranks: the global batch routed over them
# ---------------------------------------------------------------------------

# the reduced granite-moe's FFN (4 experts, top 2) at a capacity factor that
# drops, on DP_ROWS x DP_SEQ tokens (OUT_DIR/dp_case.npz)
DP_CAPACITY_FACTOR = 1.0
DP_ROWS, DP_SEQ = 8, 16
# case -> (data ranks, model ranks, dispatch groups, microbatches)
DP_CASES = {"d2_g1": (2, 1, 1, 1), "d2_g2": (2, 1, 2, 1), "d2_g4": (2, 1, 4, 1),
            "d2_g1_accum2": (2, 1, 1, 2), "d4_g1": (4, 1, 1, 1),
            "d4_g2": (4, 1, 2, 1), "d2x2_g1": (2, 2, 1, 1)}


def dp_config(groups: int):
    return moe_config().replace(capacity_factor=DP_CAPACITY_FACTOR,
                                moe_dispatch_groups=groups)


def _dp_params(data) -> dict:
    p: dict = {}
    for key in data.files:
        if "/" in key:
            lin, leaf = key.split("/")
            p.setdefault(lin, {})[leaf] = torch.from_numpy(data[key])
    return p


def dp_one(path: str, groups: int, accum: int) -> list:
    """`dp_moe`'s microbatches in one process (the whole batch's routing):
    per microbatch the gradient of sum(y * ct) + lb_loss for its input."""
    from repro_torch.core.policy import get_preset
    from repro_torch.models.moe import moe_ffn
    data = np.load(path)
    p, n = _dp_params(data), DP_ROWS // accum
    out = []
    for i in range(accum):
        x = torch.from_numpy(data["x"][i * n:(i + 1) * n]).to(torch.bfloat16)
        x.requires_grad_(True)
        y, aux = moe_ffn(p, x, dp_config(groups), get_preset("w4a4"), torch.bfloat16)
        (dx,) = torch.autograd.grad(torch.sum(y.float() * torch.from_numpy(
            data["ct"][i * n:(i + 1) * n])) + aux["lb_loss"], [x])
        out.append(dx.float())
    return out


def dp_moe(path: str, mesh, groups: int, accum: int) -> dict:
    """The port's `moe_ffn` on this data rank's share of each microbatch of
    the numpy batch in `path` (x and a cotangent ct, (DP_ROWS, DP_SEQ, d),
    and the params of `moe_ffn_split`'s file), routed over the data ranks
    (`Spmd.dp`), the experts split over the model ranks where the mesh has
    them: per microbatch its output, keep mask, lb_loss and drop_frac
    (each the data ranks' mean, as the train step takes them) and the keep
    mask that routing the rank's own rows (dp=None) gives; and the
    gradient of sum(y * ct) + lb_loss (the rank's lb_loss over the data
    ranks, so the ranks' losses add up to the batch's) for its rows."""
    from repro_torch.core.policy import get_preset
    from repro_torch.dist import sharding, spmd
    from repro_torch.models import moe
    data = np.load(path)
    p = _dp_params(data)
    cfg = dp_config(groups)
    qcfg = get_preset("w4a4")
    tree = {"moe": p}
    specs = sharding.param_pspecs(tree, mesh)
    sp = spmd.Spmd(mesh, specs)
    names = ("moe_in", "moe_gate", "moe_out")
    tp = sp.tp(("moe",), names)
    if tp is not None:
        tp = tp._replace(experts=sp.experts(("moe", "moe_in")))
    full = sp.gather(("moe",), sharding.shard_tree(tree, specs, mesh, mesh.coords)["moe"],
                     names if tp is not None else ())
    rows = sp.rows({"x": data["x"], "ct": data["ct"]}, accum)
    dp = sp.dp
    x = torch.from_numpy(rows["x"]).to(torch.bfloat16).requires_grad_(True)
    ct = torch.from_numpy(rows["ct"])
    n = x.shape[0] // accum
    out = {"coords": dict(mesh.coords), "experts": tp is not None and tp.experts,
           "parts": dp.parts, "index": dp.index, "y": [], "keep": [], "own_keep": [],
           "lb_loss": [], "drop_frac": [], "rows": []}
    loss = 0.0
    for i in range(accum):
        moe.reset_buffer_rows()
        y, aux = moe.moe_ffn(full, x[i * n:(i + 1) * n], cfg, qcfg, torch.bfloat16, tp,
                             dp, keep_mask=True)
        out["rows"].append(moe.buffer_rows())
        loss = loss + torch.sum(y.float() * ct[i * n:(i + 1) * n]) + aux["lb_loss"] / dp.parts
        with torch.no_grad():
            own = moe.moe_ffn(full, x[i * n:(i + 1) * n], cfg, qcfg, torch.bfloat16, tp,
                              keep_mask=True)[1]["keep"]
        out["y"].append(y.detach().float())
        out["keep"].append(aux["keep"])
        out["own_keep"].append(own)
        out["lb_loss"].append(float(sp.mean(aux["lb_loss"].detach())))
        out["drop_frac"].append(float(sp.mean(aux["drop_frac"])))
    (dx,) = torch.autograd.grad(loss, [x])
    out["dx"] = dx.float()
    return out


def dp_cases_on(world: int, out_dir: str) -> dict:
    """Every case of DP_CASES on `world` ranks."""
    from repro_torch.launch.mesh import make_host_mesh
    path = os.path.join(out_dir, "dp_case.npz")
    return {case: dp_moe(path, make_host_mesh(model, "cpu"), groups, accum)
            for case, (data, model, groups, accum) in DP_CASES.items()
            if data * model == world}


# ---------------------------------------------------------------------------
# training on (2, 2) and serving on (1, 4)
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_MODEL, BATCH, SEQ = 4, 2, 8, 16


def train_setup():
    """(cfg, qcfg, tcfg, dcfg) of the (2, 2) run: w3a3 (OBR 0.1), the
    oscillation tracked; the edges and the router at 4 bits (8 in the
    preset: XLA takes ~15 s to compile OBR's 256 levels of each 8-bit leaf
    in the JAX package's run that the test holds the losses against)."""
    from repro_torch.core.policy import get_preset
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.train.state import TrainConfig
    return (moe_config(), get_preset("w3a3").replace(
        track_oscillation=True, edge_bits=4, router_bits=4),
            TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=1), DataConfig(seed=0))


def train(cfg, out_dir: str, model_parallel: int = 1):
    """`run_training` of the reduced granite-moe (`train_setup`) from the
    checkpoint in `out_dir`, no checkpoint written."""
    from repro_torch.launch.train import run_training
    from repro_torch.train.fault_tolerance import CheckpointManager
    _, qcfg, tcfg, dcfg = train_setup()
    return run_training(cfg, qcfg, tcfg, dcfg, steps=TRAIN_STEPS, batch_size=BATCH,
                        seq_len=SEQ, ckpt_dir=out_dir, log_every=0, device="cpu",
                        model_parallel=model_parallel,
                        mgr=CheckpointManager(out_dir, save_every=10 ** 6,
                                              async_io=False))


SERVE_ARGV = ["--device", "cpu", "--smoke", "--arch", "granite-moe-1b-a400m",
              "--quant", "w3a3", "--batch", "3", "--slots", "2", "--prompt-len", "8",
              "--new-tokens", "4", "--chunk", "8"]


def serve_ranks(world: int) -> dict:
    """The serving CLI on a (1, world) mesh; the expert-parallel
    `greedy_generate` of each prompt alone; rank 0 also the teacher-forced
    logits beside the one-process model's on the gathered params."""
    from _torch_tp_harness import teacher_forced
    from repro_torch.dist import spmd
    from repro_torch.dist.spmd import WHOLE
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    run = serve.main(SERVE_ARGV + ["--model-parallel", str(world)])
    sp, cfg, qcfg = run.spmd, run.cfg, run.qcfg
    cache_len = int(run.engine.executor.pool["layers"][0]["kv"].k.shape[1]) * world
    prompts = torch.from_numpy(run.prompts)
    new = int(SERVE_ARGV[SERVE_ARGV.index("--new-tokens") + 1])
    step = lambda p, c, x: M.prefill_step(p, c, x, cfg, qcfg, spmd=sp)  # noqa: E731
    greedy = [serve.greedy_generate(step, run.params,
                                    M.init_cache(cfg, qcfg, 1, cache_len, "cpu", spmd=sp),
                                    prompts[i:i + 1], new)[0][0].tolist()
              for i in range(len(prompts))]
    streams = {k: v.tokens for k, v in run.engine.results.items()}
    ffn = [M.layer_tp(sp, cfg, i)[1] for i in range(cfg.n_layers)]
    out = {"streams": streams, "greedy": greedy,
           "ep": [t is not None and t.experts for t in ffn],
           "local_experts": [int(lay["moe"]["moe_in"]["codes4"].shape[0])
                             for lay in run.params["layers"]]}
    forced = torch.tensor([streams[f"req-{i}"][:3] for i in range(len(prompts))],
                          dtype=torch.int32)
    out["ep_logits"] = teacher_forced(run.params, M.init_cache(
        cfg, qcfg, len(prompts), cache_len, "cpu", spmd=sp), prompts, forced, cfg, qcfg, sp)
    full = spmd.gather_tree(run.params, sp.pspecs, sp.mesh)
    out["one_logits"] = teacher_forced(full, M.init_cache(
        cfg, qcfg, len(prompts), cache_len, "cpu"), prompts, forced, cfg, qcfg, WHOLE)
    return out


def group_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    _env(rank, world, port)
    import torch.distributed as dist
    from repro_torch.dist import spmd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    t0 = time.perf_counter()
    res = {"cases": cases_on(make_host_mesh(world, "cpu")),
           "dp": dp_cases_on(world, out_dir)}
    if world == 2:
        mesh = make_host_mesh(world, "cpu")
        res["moe_ffn"] = {case: moe_ffn_split(os.path.join(out_dir, f"{case}.npz"), mesh)
                          for case in ("moe_case", "moe_case_tp")}
        res["moe_ffn_tp"] = moe_ffn_tp(mesh)
    else:
        import shutil
        run_dir = os.path.join(out_dir, "ck_ep")
        if rank == 0:
            shutil.copytree(os.path.join(out_dir, "src"), run_dir)
        dist.barrier()
        spmd.reset_moved_bytes()
        moe.reset_buffer_rows()
        rep = train(moe_config(), run_dir, TRAIN_MODEL)
        res["train"] = {"losses": rep.losses, "grad_norms": rep.grad_norms,
                        "metrics": rep.metrics, "healths": rep.healths,
                        "mesh": rep.mesh.shape, "moved": spmd.moved_bytes(),
                        "moved_by_use": spmd.moved_bytes_by_use(),
                        "buffer_rows": moe.buffer_rows(),
                        "count_bytes": moe.count_gather_bytes()}
        res["serve"] = serve_ranks(world)
    res["wall_s"] = time.perf_counter() - t0
    torch.save(res, os.path.join(out_dir, f"m{world}_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# OBR (Eq. 10) and the oscillation fraction on slices (--obr)
# ---------------------------------------------------------------------------

# case -> (linear, whole shape, the scale's group axes)
OBR_CASES = {
    "w_in": ("w_in", (16, 24), ()),              # 0-d scale; FSDP + TP column
    "wq": ("wq", (16, 4, 8), (1,)),              # per-head scale, heads on model
    "moe_in_ep": ("moe_in", (4, 16, 24), (0,)),  # per-expert, experts on model (EP)
    "moe_in_tp": ("moe_in", (3, 16, 24), (0,)),  # per-expert, d_ff on model
    "embed": ("embed", (32, 16), ()),            # vocab on model; its state FSDP too
    "router": ("router", (15, 3), ()),           # nothing divides: whole on every rank
}
OBR_MESHES = {"2x2": 2, "1x4": 4}  # mesh -> its model ranks of 4
OSC_THRESHOLD = 0.005


def obr_qcfg():
    """w3a3 with the edges and the router at 4 bits (16 bins)."""
    from repro_torch.core.policy import get_preset
    return get_preset("w3a3").replace(track_oscillation=True, edge_bits=4,
                                      router_bits=4)


def obr_inputs() -> dict:
    """case -> numpy arrays: the weight w, its scale s (one a group), the
    weight after a step w2, and an oscillation state (prev_int, prev_dir,
    freq) with about half its EMAs above OSC_THRESHOLD."""
    rng = np.random.default_rng(31)
    out = {}
    for case, (_, shape, groups) in OBR_CASES.items():
        sshape = tuple(n if i in groups else 1 for i, n in enumerate(shape)) if groups else ()
        w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        s = np.array(0.03 + 0.03 * rng.random(sshape), dtype=np.float32)
        out[case] = {"w": w, "s": s,
                     "w2": (w + 0.02 * rng.standard_normal(shape)).astype(np.float32),
                     "prev_int": rng.integers(-4, 4, shape).astype(np.int8),
                     "prev_dir": rng.integers(-1, 2, shape).astype(np.int8),
                     "freq": (0.01 * rng.random(shape)).astype(np.float32)}
    return out


def obr_state(key: str = "w") -> tuple:
    """(params, osc): the whole tree {case: {linear: {"w", "w_scale"}}}
    (`key` the weight: "w" or "w2") and its oscillation states in
    `quant_leaf_paths` order."""
    from repro_torch.core.oscillation import OscState
    from repro_torch.models.model import quant_leaf_paths
    inp = obr_inputs()
    params = {case: {name: {"w": torch.from_numpy(inp[case][key]),
                            "w_scale": torch.from_numpy(inp[case]["s"])}}
              for case, (name, _, _) in OBR_CASES.items()}
    osc = tuple(OscState(*(torch.from_numpy(inp[path[0]][k])
                           for k in ("prev_int", "prev_dir", "freq")))
                for path, _, _, _ in quant_leaf_paths(params, obr_qcfg()))
    return params, osc


def stats_bytes(params, specs: dict, qcfg, mesh, osc_reads: int = 1) -> dict:
    """The bytes OBR and the oscillation fraction move to a rank in a step
    of the whole tree `params` (a meta tree will do) under the state specs
    `specs`: for each quantized leaf its weight's spec splits, its Eq. 10
    sums in f32 (the sum of squares, and 3 x bins x the whole scale's
    groups); for each oscillation state its spec splits, one int64 count
    each of the `osc_reads` times the step reads the fraction."""
    from repro_torch.dist import sharding as shard
    from repro_torch.dist.spmd import spec_at
    from repro_torch.models.model import quant_leaf_paths
    obr = osc = 0
    for j, (path, _, s, spec) in enumerate(quant_leaf_paths(params, qcfg)):
        if shard.split_dims(spec_at(specs["params"], path)["w"], mesh):
            obr += 4 * (1 + 3 * spec.n_bins * s.numel())
        if specs["osc"] and shard.split_dims(specs["osc"][j].freq, mesh):
            osc += 8 * osc_reads
    return {"obr": obr, "oscillation": osc}


def obr_on(mesh) -> dict:
    """This rank's OBR and oscillation results on `mesh`: Eq. 10 over every
    case at once (its total, each leaf's gradient slice, the bytes moved by
    use) and case by case (each value), each state's fraction, and each
    state's Eq. 12 update on the stepped weights' oscillation view."""
    from repro_torch import tree as T
    from repro_torch.core.oscillation import update_osc_state
    from repro_torch.dist import sharding, spmd
    from repro_torch.models.model import quant_leaf_paths
    from repro_torch.train.train_step import obr_, osc_fractions
    qcfg = obr_qcfg()
    params, osc = obr_state()
    specs = sharding.state_pspecs({"params": params, "mu": params, "nu": params,
                                   "osc": osc, "err": ()}, mesh, qcfg)
    sp = spmd.Spmd(mesh, specs["params"], osc_specs=specs["osc"])
    local = sharding.shard_tree(params, specs["params"], mesh, mesh.coords)
    local_osc = sharding.shard_tree(osc, specs["osc"], mesh, mesh.coords)
    one = torch.ones(())
    grads = T.map_tree(torch.zeros_like, local)
    spmd.reset_moved_bytes()
    total = obr_(local, grads, qcfg, one, sp)
    fracs = osc_fractions(local_osc, OSC_THRESHOLD, sp)
    moved = spmd.moved_bytes_by_use()
    values = {case: float(obr_({case: local[case]}, T.map_tree(
        torch.zeros_like, {case: local[case]}), qcfg, one, sp)) for case in OBR_CASES}
    stepped = sharding.shard_tree(obr_state("w2")[0], specs["params"], mesh, mesh.coords)
    paths = quant_leaf_paths(stepped, qcfg)
    new = [update_osc_state(st, *sp.osc_view(j, path, w, s), spec,
                            momentum=qcfg.osc_momentum)
           for j, (st, (path, w, s, spec)) in enumerate(zip(local_osc, paths))]
    cases = [path[0] for path, _, _, _ in paths]
    return {"coords": dict(mesh.coords), "total": float(total), "values": values,
            "moved": moved,
            "grads": {case: grads[case][name]["w"] for case, (name, _, _)
                      in OBR_CASES.items()},
            "wspec": {case: specs["params"][case][name]["w"]
                      for case, (name, _, _) in OBR_CASES.items()},
            "ospec": {case: specs["osc"][j].freq for j, case in enumerate(cases)},
            "fracs": {case: float(f) for case, f in zip(cases, fracs)},
            "osc": {case: tuple(st) for case, st in zip(cases, new)}}


def obr_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    _env(rank, world, port)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    res = {name: obr_on(make_host_mesh(model, "cpu")) for name, model in OBR_MESHES.items()}
    torch.save(res, os.path.join(out_dir, f"obr_rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    if sys.argv[1] == "--obr":
        mp.spawn(obr_rank, args=(4, free_port(), sys.argv[2]), nprocs=4)
    else:
        out = sys.argv[1]
        ctxs = [mp.spawn(group_rank, args=(w, free_port(), out), nprocs=w, join=False)
                for w in (2, 4)]
        for ctx in ctxs:
            while not ctx.join():
                pass
