"""Split MoE experts in the port (`models.moe.moe_ffn(tp=...)`) on gloo
ranks of the CPU, against the whole computation on the same inputs.

tests/_torch_ep_harness.py runs the ranks in subprocesses (one run, its
own wall-time bar):

* Per expert linear (moe_in column-parallel, moe_out row-parallel), on 2
  and 4 ranks, in f32: expert parallelism (EP, 4 experts: the rules split
  the expert axis) and tensor parallelism within the experts (3 experts
  on 2 ranks, 6 on 4: only d_ff divides), on the kernel route (the plain
  versions on the CPU) and the unfused one, under MDQ (a scale an expert)
  and LSQ (per-tensor scales), and in serving form (int4 codes packed
  along the contraction, the dequantize-and-einsum fallback). EP: the
  outputs, the expert weights' and per-expert scales' gradients and the
  buffer's gradient (all-gathered from the parts) bit-equal to the whole
  linear. TP: the column slices' outputs bit-equal to the whole's columns.
  What sums over the ranks (row-parallel outputs, the column-parallel dX,
  the activation quantizer's and the replicated weight scales'
  gradients) is held to summation order, as in tests/test_torch_tp.py:
  1e-6 of the largest magnitude, or of the size of what it sums
  (`_torch_ep_harness.magnitudes`), and 2^-8 of that size for the kernel
  route's column-parallel dX and activation scale and offset (the kernels
  round each rank's dX partial to bf16). Every slice's g factors equal the
  whole weight's (bit-equal where its groups are whole on the rank, 1e-6
  where their l1 is all-reduced over the ranks).
* The MoE FFN on 2 ranks against the JAX package's `moe_ffn` on
  tests/test_torch_moe.py's inputs, on both of the port's routes:
  expert-parallel (4 experts, 2 a rank) under that file's bar (the output
  bit for bit, lb_loss within 1e-6 relative, drop_frac exactly), and cut
  to 3 experts (tensor parallelism within the experts) with each output
  element within one bf16 ulp of the JAX package's (moe_out's partials
  summed over the ranks in another order).
* The MoE FFN with 3 experts on 2 ranks against one process: the router's
  aux bit-equal, the output within one bf16 ulp, its input's gradient
  within 2e-2 relative L2.
* The reduced granite-moe's QAT (w3a3: OBR, oscillation tracked; edges
  and router at 4 bits, so that XLA compiles the JAX package's run in
  ~20 s) on a (2, 2) mesh, experts and attention split over the 2 model
  ranks, from the JAX package's init state, against one process with
  `moe_dispatch_groups=2` (its groups are the data ranks' rows, so
  routing and capacity match): step 0's drop_frac bit-equal, its
  loss_main within 1e-6 relative (the attention's row-parallel wo sums
  its f32 partials over the model ranks, and the loss is a mean over the
  data ranks: one f32 ulp apart from the JAX init); its lb_loss, which the sharded run takes as the mean over
  the data ranks of each rank's Switch loss, within 1e-6 relative of
  that mean computed by one process on each data rank's rows (one process
  over both groups takes the product of the means instead); step 0's
  loss within 1e-6 relative of that loss; the 4 losses within the
  reference's 5 % (tests/test_spmd.py) of one process's and of the JAX
  package's one-device run (2 dispatch groups too); the gradient norm of
  steps 0 and 1 within 2e-3 relative. `spmd.moved_bytes_by_use()` counts
  the expert buffers' gathers under "experts" to the byte.
* Serving on a (1, 4) mesh (one expert a rank, the vocabulary split; the
  attention, whose 2 kv heads do not split in 4, gathered): the engine's
  streams equal the expert-parallel `greedy_generate` of each prompt alone
  (a one-chunk prefill: no expert can overflow its capacity), on every
  rank; the teacher-forced logits of a prefill and 3 decode steps
  bit-equal to the one-process model on the gathered params.
* The dry run of the reduced granite-moe at smoke shapes, EP (4 experts)
  and TP within the experts (6): rank 0's FLOPs of kernels 1, 2, 5 and 6
  on a (1, 4) mesh, x 4, equal the one-rank count exactly, op by op.
"""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ep_harness as H  # noqa: E402
from test_torch_tp import _assemble, _rel  # noqa: E402

HARNESS = os.path.join(os.path.dirname(__file__), "_torch_ep_harness.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SUM_BAR = 1e-6        # f32, summation order only
KERNEL_COL_BAR = 2.0 ** -8
LOSS_BAR, GNORM_BAR, GRAD_BAR = 0.05, 2e-3, 2e-2


def _jax_training(state_only: bool = False):
    """The JAX package's init state of the (2, 2) run's configuration
    (`_torch_ep_harness.train_setup`) as numpy, and its one-device losses
    over TRAIN_STEPS steps with 2 dispatch groups (the data ranks' rows).
    The reference runs unrolled, its pattern repeated so that its two
    layers stay out of a lax.scan (as tests/_torch_parity.train_states
    does): a scanned leaf stacks the layers, and the reference's Eq. 10
    then takes one l2 norm over both layers' weights (loss_obr 34.3 at this
    configuration's init) where its unrolled form, the paper and the port
    take one a layer (48.0)."""
    import jax
    from repro.configs.registry import get_config, reduced_config
    from repro.core.policy import get_preset as j_preset
    from repro.data.synthetic import DataConfig, sample_batch
    from repro.train.state import TrainConfig, init_state
    from repro.train.train_step import make_train_step
    cfg = reduced_config(get_config("granite-moe-1b-a400m"))
    cfg = cfg.replace(pattern=cfg.pattern * 3)
    qcfg = j_preset("w3a3").replace(track_oscillation=True, edge_bits=4, router_bits=4)
    tcfg = TrainConfig(total_steps=H.TRAIN_STEPS, warmup_steps=1)
    state = init_state(jax.random.PRNGKey(0), cfg, qcfg, tcfg)
    state0 = jax.tree.map(np.asarray, state)
    if state_only:
        return state0, None
    g2 = cfg.replace(moe_dispatch_groups=2)
    step = jax.jit(make_train_step(g2, qcfg, tcfg))
    losses = []
    for i in range(H.TRAIN_STEPS):
        state, m = step(state, sample_batch(g2, DataConfig(seed=0), i, H.BATCH, H.SEQ))
        losses.append(float(m["loss"]))
    return state0, losses


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The harness's results, with the JAX package's outputs on the same
    inputs: the MoE FFN's inputs (4 experts, and cut to 3) and the
    training's init state are written first (the ranks read them); the JAX
    package's MoE FFNs and its one-device training run while the ranks
    do."""
    import test_torch_moe as TM
    from repro_torch import bridge
    from repro_torch.train import checkpoint as ckpt
    out = tmp_path_factory.mktemp("ep")
    jc, _ = TM.configs(TM.ARCH)
    jq = TM.get_preset("w4a4").replace(fused_matmul="on")
    x = TM._x(jc)
    moe = {}
    for case, e in (("moe_case", jc.n_experts), ("moe_case_tp", H.TP_EXPERTS[2])):
        jce = jc.replace(n_experts=e)
        p = TM._moe_params(jce, jq)
        np.savez(out / f"{case}.npz", x=x, **{f"{lin}/{leaf}": np.asarray(v)
                                              for lin, d in p.items() for leaf, v in d.items()})
        moe[case] = (p, jce)
    cfg, qcfg, _, _ = H.train_setup()
    state0, _ = _jax_training(state_only=True)
    ckpt.save(str(out / "src"), bridge.state_from_jax(
        state0, cfg.replace(pattern=cfg.pattern * 3), "cpu", qcfg=qcfg), 0)
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, HARNESS, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done: dict = {}

    def wait():  # the harness's own wall time, its pipes drained meanwhile
        done["err"] = proc.communicate(timeout=300)[1]
        done["wall"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait)
    waiter.start()
    try:
        jax_moe = {case: TM._jax_moe(p, x, jce, jq) for case, (p, jce) in moe.items()}
        _, losses_ref = _jax_training()
    finally:
        waiter.join(timeout=330)
        proc.kill()
    assert proc.returncode == 0, done.get("err", "")[-4000:]
    wall = done["wall"]
    res = {m: [torch.load(out / f"m{m}_rank{r}.pt") for r in range(m)] for m in (2, 4)}
    return {"res": res, "wall": wall, "jax": jax_moe, "losses_ref": losses_ref,
            "dir": out}


# ---------------------------------------------------------------------------
# per expert linear
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["ep", "tp"])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", list(H.EXPERT_CASES))
def test_expert_linear_slices_match_whole(ranks, case, m, layout):
    e = H.EP_EXPERTS if layout == "ep" else H.TP_EXPERTS[m]
    outs = [r["cases"][(case, e)] for r in ranks["res"][m]]
    ep = outs[0]["experts"]
    assert ep == (layout == "ep")  # the rules' choice: experts divide, or only d_ff
    name, _, route = H.EXPERT_CASES[case]
    row = name == "moe_out" and not ep
    whole = H.run_case(case, e)
    y = _assemble([o["y"] for o in outs], 1 if ep else None if row else 3)
    assert y.shape == whole["y"].shape
    if row:  # partial products summed over the ranks
        assert _rel(y, whole["y"]) < SUM_BAR, _rel(y, whole["y"])
    else:
        assert torch.equal(y, whole["y"]), _rel(y, whole["y"])
    if route == "serve":
        return
    mags = H.magnitudes(case, e)
    specs = outs[0]["specs"]
    assert set(outs[0]["grads"]) == set(whole["grads"])
    split = 0
    for key, want in whole["grads"].items():
        if key == "x":  # EP all-gathers the parts' gradients; row-parallel keeps its columns
            dim = 3 if row else None
        else:
            dim = H._model_dim(specs[key])
            split += dim is not None
        got = _assemble([o["grads"][key] for o in outs], dim)
        assert got.shape == want.shape, key
        assert torch.isfinite(got).all(), key
        leaf = key.split("/")[-1]
        sums = (key == "x" and not ep and not row) or leaf in ("a_scale", "a_offset") or (
            leaf == "w_scale" and dim is None)
        if ep and not sums:  # the expert products keep their bits
            assert torch.equal(got, want), (key, _rel(got, want))
        elif key in mags and sums:  # held against the size of what it sums
            k = KERNEL_COL_BAR if (route == "auto" and not row and not ep and leaf in (
                "x", "a_scale", "a_offset")) else SUM_BAR
            err = (got - want).abs()
            assert bool((err <= k * torch.as_tensor(mags[key])).all()), (
                key, float(err.max()), k * float(torch.as_tensor(mags[key]).max()))
        else:
            assert _rel(got, want) < SUM_BAR, (key, _rel(got, want))
    assert split >= 1  # the weight (and a per-expert scale under EP) split
    # g factors: the whole weight's, from the slice
    c = H.case_inputs(case, e)
    gw = H.g_factors(c["tree"][name], name, c["qcfg"])
    for kind, want in gw.items():
        parts = [o["g"][kind] for o in outs]
        if ep and want.dim():  # per expert, each group whole on its rank
            assert torch.equal(torch.cat(parts, 0), want), kind
        else:  # the l1 all-reduced over the ranks (or the whole element count)
            got = _assemble(parts, None)
            assert _rel(got, want) < SUM_BAR, (kind, _rel(got, want))


# ---------------------------------------------------------------------------
# the MoE FFN against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["auto", "off"])
def test_ep_moe_ffn_matches_jax(ranks, route):
    y_j, aux_j = ranks["jax"]["moe_case"]
    for r in ranks["res"][2]:
        got = r["moe_ffn"]["moe_case"]
        assert got["experts"] and got["local_experts"] == 2 and got["router_rows"] == 4
        np.testing.assert_array_equal(got[route]["y"].numpy(), y_j)
        assert abs(got[route]["lb_loss"] - aux_j["lb_loss"]) <= 1e-6 * abs(aux_j["lb_loss"])
        assert got[route]["drop_frac"] == aux_j["drop_frac"]


@pytest.mark.parametrize("route", ["auto", "off"])
def test_tp_within_experts_moe_ffn_matches_jax(ranks, route):
    """The MoE FFN cut to 3 experts on 2 ranks (each expert's d_ff split)
    against the JAX package's on the same inputs: the router runs whole
    (lb_loss within 1e-6 relative, drop_frac exactly, as for EP); the
    output differs from the one-process value only where moe_out's f32
    partials, summed over the ranks in another order, round to the other
    bf16 neighbour: each element within one bf16 ulp of the JAX output."""
    from _torch_parity import bf16_ulp
    y_j, aux_j = ranks["jax"]["moe_case_tp"]
    for r in ranks["res"][2]:
        got = r["moe_ffn"]["moe_case_tp"]
        assert not got["experts"] and got["local_experts"] == 3 and got["local_ff"] == 48
        y = got[route]["y"].numpy().astype(np.float64)
        gap = np.abs(y - y_j)
        assert (gap <= bf16_ulp(y_j)).all(), float((gap / np.maximum(
            bf16_ulp(y_j), 1e-30)).max())
        assert (gap == 0).mean() > 0.9
        assert abs(got[route]["lb_loss"] - aux_j["lb_loss"]) <= 1e-6 * abs(aux_j["lb_loss"])
        assert got[route]["drop_frac"] == aux_j["drop_frac"]


def test_tp_within_experts_moe_ffn_matches_whole(ranks):
    """The MoE FFN with 3 experts on 2 ranks (each expert's d_ff split):
    the router and aux are whole (lb_loss and drop_frac bit-equal); the
    output and the input's gradient differ from one process only where
    moe_out's f32 partials, summed over the ranks, and the column-parallel
    dX partials round otherwise: each element within one bf16 ulp of its
    value; dX, a bf16 sum of the column-parallel partials, each rounded to
    bf16 by the kernels, within tests/test_torch_tp.py's 2e-2 relative L2
    for a tensor-parallel sublayer's gradients."""
    from repro_torch.kernels.ref import _bf16
    whole = H.moe_ffn_tp(None)
    for r in ranks["res"][2]:
        got = r["moe_ffn_tp"]
        assert got["split"] and not got["experts"]
        assert got["lb_loss"] == whole["lb_loss"] and got["drop_frac"] == whole["drop_frac"]
        ulp = (_bf16(whole["y"].abs() * (1 + 2.0 ** -8)) - whole["y"].abs()).abs()
        assert bool(((got["y"] - whole["y"]).abs() <= ulp).all())
        assert (got["y"] == whole["y"]).float().mean() > 0.9
        rel = float((got["dx"] - whole["dx"]).norm() / whole["dx"].norm())
        assert rel < GRAD_BAR, rel


# ---------------------------------------------------------------------------
# the reduced granite-moe's QAT on (2, 2) against one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(ranks):
    """One process with moe_dispatch_groups=2 (4 steps) from the same
    checkpoint, and the lb_loss the sharded run reports at step 0: the mean
    over the data ranks of each rank's rows' Switch loss, each from one
    process's forward."""
    import shutil
    from repro_torch.data.synthetic import sample_batch
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.state import init_state
    cfg, qcfg, tcfg, dcfg = H.train_setup()
    src, one = ranks["dir"] / "src", ranks["dir"] / "one"
    shutil.copytree(src, one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rep = H.train(cfg.replace(moe_dispatch_groups=2), str(one))
        like = init_state(cfg, qcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
        params = ckpt.restore(str(src), like, step=0)["params"]
        batch = sample_batch(cfg, dcfg, 0, H.BATCH, H.SEQ)
        half = H.BATCH // 2
        lbs = []
        with torch.no_grad():
            for lo in (0, half):
                rows = {k: torch.from_numpy(v[lo:lo + half]) for k, v in batch.items()}
                lbs.append(M.forward(params, rows, cfg, qcfg)[1]["lb_loss"])
    finally:
        torch.set_num_threads(threads)
    return rep, float((lbs[0] + lbs[1]) / 2)


def test_training_runs_expert_parallel(ranks):
    for r in ranks["res"][4]:
        tr = r["train"]
        assert tr["mesh"] == {"data": 2, "model": 2}
        assert np.isfinite(tr["losses"]).all()
        assert tr["losses"] == ranks["res"][4][0]["train"]["losses"]


def test_training_counts_the_expert_buffers(ranks):
    """`spmd.moved_bytes_by_use()["experts"]` counts the expert buffers'
    collectives: each MoE layer's bf16 output buffer all-gathered along the
    experts in each of the step's 2 forwards (the block's checkpoint runs
    it again in the backward) and its input buffer's gradient all-gathered
    from the parts once; beyond those, only f32 scalars (the replicated
    scales' partial gradients and the g factors' sums over the ranks).
    "obr" and "oscillation" count only the leaves' sums
    (`_torch_ep_harness.stats_bytes`, one read of the fraction a step: no
    sentinel), no gathered leaf or EMA."""
    from repro_torch.dist import sharding as shard
    from repro_torch.dist.spmd import state_specs
    from repro_torch.models.moe import capacity
    from repro_torch.train.state import init_state
    cfg = H.moe_config()
    _, qcfg, tcfg, _ = H.train_setup()
    mesh = shard.AxisSizes(("data", "model"), (2, H.TRAIN_MODEL))
    like = init_state(cfg, qcfg, tcfg, torch.Generator(), "meta")
    stats = {k: v * H.TRAIN_STEPS for k, v in H.stats_bytes(
        like["params"], state_specs(cfg, qcfg, tcfg, mesh), qcfg, mesh).items()}
    g = cfg.moe_dispatch_groups
    tokens = H.BATCH * H.SEQ // 2  # a data rank's rows
    rows = g * capacity(tokens // g, cfg)
    buffers = 3 * cfg.n_layers * cfg.n_experts * rows * cfg.d_model * 2 * H.TRAIN_STEPS
    for r in ranks["res"][4]:
        tr = r["train"]
        rest = tr["moved_by_use"]["experts"] - buffers
        assert 0 <= rest <= 16 * 4 * cfg.n_layers * H.TRAIN_STEPS, (tr["moved_by_use"], buffers)
        assert rest % 4 == 0
        assert sum(tr["moved_by_use"].values()) <= sum(tr["moved"].values())
        assert tr["moved_by_use"]["obr"] > 0 and tr["moved_by_use"]["oscillation"] > 0
        assert (tr["moved_by_use"]["obr"] + tr["moved_by_use"]["oscillation"]
                <= stats["obr"] + stats["oscillation"]), (tr["moved_by_use"], stats)
        assert {k: tr["moved_by_use"][k] for k in stats} == stats


def test_training_step0_matches_one_process(ranks, one_process):
    rep, lb_ranks = one_process
    got = ranks["res"][4][0]["train"]["metrics"][0]
    want = rep.metrics[0]
    assert abs(got["loss_main"] - want["loss_main"]) <= SUM_BAR * abs(want["loss_main"]), (
        got, want)
    assert got["drop_frac"] == want["drop_frac"], (got, want)
    assert abs(got["lb_loss"] - lb_ranks) <= 1e-6 * abs(lb_ranks), (got["lb_loss"], lb_ranks)
    print(f"lb_loss: the ranks' mean {got['lb_loss']}, one process over both groups "
          f"{want['lb_loss']}")
    _, _, tcfg, _ = H.train_setup()
    loss0 = ranks["res"][4][0]["train"]["losses"][0]
    expect = want["loss_main"] + tcfg.lb_coef * lb_ranks
    assert abs(loss0 - expect) <= 1e-6 * abs(expect), (loss0, expect, rep.losses[0])


def test_training_losses_within_the_reference_bar(ranks, one_process):
    """The 4 losses within the reference's 5 % (tests/test_spmd.py) of the
    one-process port's and of the JAX package's one-device run (both with 2
    dispatch groups, from the same init state); the gradient norm at steps
    0 and 1 within 2e-3 relative of one process's."""
    rep, _ = one_process
    tr = ranks["res"][4][0]["train"]
    print(f"losses: (2, 2) {tr['losses']}, one process {rep.losses}, "
          f"the JAX package {ranks['losses_ref']}")
    for base in (rep.losses, ranks["losses_ref"]):
        for x, y in zip(tr["losses"], base):
            assert abs(x - y) / abs(y) < LOSS_BAR, (tr["losses"], base)
    gaps = [abs(x - y) / y for x, y in zip(tr["grad_norms"][:2], rep.grad_norms[:2])]
    print(f"gradient norm gaps at steps 0-1: {gaps}")
    assert max(gaps) < GNORM_BAR, (tr["grad_norms"], rep.grad_norms)


# ---------------------------------------------------------------------------
# serving on (1, 4)
# ---------------------------------------------------------------------------

def test_serving_runs_expert_parallel(ranks):
    for r in ranks["res"][4]:
        assert all(r["serve"]["ep"]) and r["serve"]["local_experts"] == [1, 1]


def test_serving_streams_equal_ep_greedy(ranks):
    streams = ranks["res"][4][0]["serve"]["streams"]
    for r in ranks["res"][4]:
        s = r["serve"]
        assert s["streams"] == streams
        assert s["greedy"] == [streams[f"req-{i}"] for i in range(len(streams))]


def test_serving_logits_equal_one_process(ranks):
    s = ranks["res"][4][0]["serve"]
    assert torch.isfinite(s["ep_logits"]).all()
    assert torch.equal(s["ep_logits"], s["one_logits"]), float(
        (s["ep_logits"] - s["one_logits"]).abs().max())


def test_ep_harness_wall_time(ranks):
    assert ranks["wall"] <= 60.0, ranks["wall"]


# ---------------------------------------------------------------------------
# the dry run: rank 0 of a (1, 4) mesh counts its experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("experts", [H.EP_EXPERTS, H.TP_EXPERTS[4]])
def test_dry_run_rank0_counts_its_experts(experts):
    """Rank 0's FLOPs of the QAT kernels, x 4, equal the one-rank count op
    by op: the batched kernels on 1 expert of 4 (EP) or on every expert's
    quarter of d_ff (6 experts), the attention's and the head's on their
    slices."""
    from repro_torch.configs import shapes as shp
    from repro_torch.launch import dryrun as D
    cfg = H.moe_config().replace(n_experts=experts)
    recs = []
    for mesh in ((1, 1), (1, 4)):
        rec = D.lower_cell("granite-moe-1b-a400m", "train_4k", multi_pod=False,
                           preset="w4a4", grad_accum=8, serve_kv_bits=8, mesh_sizes=mesh,
                           cfg=cfg, shape=shp.get_shape("train_4k", smoke=True))
        assert rec["status"] == "ok", rec.get("traceback")
        recs.append(rec["cost"]["by_op"])
    for op in ("kernel::quant_matmul", "kernel::quant_matmul_bwd",
               "kernel::quant_matmul_batched", "kernel::quant_matmul_bwd_batched"):
        one, four = recs[0][op]["flops"], recs[1][op]["flops"]
        assert one > 0 and 4 * four == one, (op, one, four)
