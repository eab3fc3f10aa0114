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
  ranks, from the JAX package's init state, against one process at the
  configuration's one dispatch group (the data ranks route the global
  batch, as the reference's jitted step does): step 0's drop_frac
  bit-equal, its loss_main, lb_loss (the batch's Switch loss) and loss
  within 1e-6 relative (the attention's row-parallel wo sums its f32
  partials over the model ranks, and the loss is a mean over the data
  ranks: one f32 ulp apart from the JAX init); the 4 losses within the
  reference's 5 % (tests/test_spmd.py) of one process's and of the JAX
  package's one-device run (one dispatch group too); the gradient norm of
  steps 0 and 1 within 2e-3 relative. `spmd.moved_bytes_by_use()` counts
  the expert buffers' gathers, at the local capacities the ranks report,
  and the routing counts' gathers under "experts" to the byte.
* The MoE FFN routed over data ranks (`moe_ffn(dp=...)`: 2 ranks at 1, 2
  and 4 dispatch groups and at 2 microbatches, 4 ranks at 1 and 2 groups,
  and (2, 2) with the experts split) against the JAX package's on the
  whole batch, at a capacity that drops: the keep mask and the output bit
  for bit on each rank's rows, lb_loss within 1e-6 relative, drop_frac
  exactly, the input's gradient equal to the port's in one process; each
  case shows that routing each rank's own rows keeps other pairs.
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
    over TRAIN_STEPS steps (the configuration's one dispatch group).
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
    step = jax.jit(make_train_step(cfg, qcfg, tcfg))
    losses = []
    for i in range(H.TRAIN_STEPS):
        state, m = step(state, sample_batch(cfg, DataConfig(seed=0), i, H.BATCH, H.SEQ))
        losses.append(float(m["loss"]))
    return state0, losses


def _jax_dp(p, x, ct, groups: int, accum: int) -> list:
    """The JAX package's `moe_ffn` (w4a4, the fused route, exact bf16) on
    each of `accum` microbatches of consecutive rows of the whole batch x,
    at `groups` dispatch groups and H.DP_CAPACITY_FACTOR: per microbatch
    its output, keep mask (T, k), lb_loss, drop_frac and the gradient of
    sum(y * ct) + lb_loss with respect to its input."""
    import jax
    import jax.numpy as jnp
    import test_torch_moe as TM
    from repro.models import common as JC
    from repro.models import moe as JMoe
    jc = TM.configs(TM.ARCH)[0].replace(capacity_factor=H.DP_CAPACITY_FACTOR,
                                        moe_dispatch_groups=groups)
    jq = TM.get_preset("w4a4").replace(fused_matmul="on")
    e, k = jc.n_experts, jc.moe_top_k
    pj = jax.tree.map(jnp.asarray, p)

    def keep_of(pp, xx):
        xt = xx.reshape(-1, jc.d_model)
        lg = JC.qlinear(pp["router"], xt, "router", jq, "td,de->te", cdtype=jnp.float32)
        _, idx = jax.lax.top_k(jax.nn.softmax(lg, -1), k)
        t = xt.shape[0]
        grp = groups if groups > 1 and t % groups == 0 else 1
        c = JMoe.capacity(t // grp, jc)
        keep = jax.vmap(lambda xg, ig: JMoe._route_group(xg, None, ig, c, e, k, jnp.bfloat16)[2])(
            xt.reshape(grp, -1, jc.d_model), idx.reshape(grp, -1, k))
        return keep.reshape(t, k)

    def loss(pp, xx, cc):
        y, aux = JMoe.moe_ffn(pp, xx, jc, jq, jnp.bfloat16)
        return jnp.sum(y.astype(jnp.float32) * cc) + aux["lb_loss"]

    fwd = jax.jit(lambda pp, xx: JMoe.moe_ffn(pp, xx, jc, jq, jnp.bfloat16))
    n = x.shape[0] // accum
    out = []
    for i in range(accum):
        xb = jnp.asarray(x[i * n:(i + 1) * n], jnp.bfloat16)
        cb = jnp.asarray(ct[i * n:(i + 1) * n])
        y, aux = fwd.lower(pj, xb).compile(TM.EXACT_BF16)(pj, xb)
        keep = jax.jit(keep_of).lower(pj, xb).compile(TM.EXACT_BF16)(pj, xb)
        dx = jax.jit(jax.grad(loss, argnums=1)).lower(pj, xb, cb).compile(
            TM.EXACT_BF16)(pj, xb, cb)
        out.append({"y": np.asarray(y.astype(jnp.float32)), "keep": np.asarray(keep),
                    "lb_loss": float(aux["lb_loss"]), "drop_frac": float(aux["drop_frac"]),
                    "dx": np.asarray(dx.astype(jnp.float32))})
    return out


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
    rng = np.random.default_rng(34)
    dp_x = rng.standard_normal((H.DP_ROWS, H.DP_SEQ, jc.d_model)).astype(np.float32)
    dp_ct = rng.standard_normal(dp_x.shape).astype(np.float32)
    dp_p = moe["moe_case"][0]
    np.savez(out / "dp_case.npz", x=dp_x, ct=dp_ct,
             **{f"{lin}/{leaf}": np.asarray(v) for lin, d in dp_p.items()
                for leaf, v in d.items()})
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
        jax_dp = {(g, n): _jax_dp(dp_p, dp_x, dp_ct, g, n)
                  for _, _, g, n in H.DP_CASES.values()}
        _, losses_ref = _jax_training()
    finally:
        waiter.join(timeout=330)
        proc.kill()
    assert proc.returncode == 0, done.get("err", "")[-4000:]
    wall = done["wall"]
    res = {m: [torch.load(out / f"m{m}_rank{r}.pt") for r in range(m)] for m in (2, 4)}
    return {"res": res, "wall": wall, "jax": jax_moe, "losses_ref": losses_ref,
            "dir": out, "jax_dp": jax_dp}


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
# the MoE FFN on data ranks against the JAX package's on the whole batch
# ---------------------------------------------------------------------------

def _dp_results(ranks, case: str) -> list:
    data, model, _, _ = H.DP_CASES[case]
    return [r["dp"][case] for r in ranks["res"][data * model]]


@pytest.mark.parametrize("case", list(H.DP_CASES))
def test_data_ranks_route_the_global_batch(ranks, case):
    """The MoE FFN (H.DP_CAPACITY_FACTOR: it drops) on a case's data ranks,
    each holding its share of every microbatch, against the JAX package's
    `moe_ffn` on the whole microbatch: on each rank's rows the keep mask
    and the output bit for bit (tests/test_torch_moe.py's bar), the data
    ranks' mean lb_loss within 1e-6 relative and their mean drop_frac
    exactly; and routing each rank's own rows (the per-rank routing this
    replaces) keeps another set of pairs. The gradient of sum(y * ct) +
    lb_loss for the rank's rows (its lb_loss over the data ranks) within
    1e-6 of its largest value of the port's on the whole batch in one
    process (the JAX package's bf16 backward sums in other orders: its gap,
    up to two bf16 ulps on one process too, is printed)."""
    data, model, groups, accum = H.DP_CASES[case]
    ref = ranks["jax_dp"][(groups, accum)]
    one = H.dp_one(str(ranks["dir"] / "dp_case.npz"), groups, accum)
    outs = _dp_results(ranks, case)
    n = H.DP_ROWS // accum // data  # a rank's rows of a microbatch
    k = H.moe_config().moe_top_k
    own_differs = False
    for o in outs:
        r = o["coords"]["data"]
        assert o["parts"] == data and o["index"] == r
        assert o["experts"] == (model > 1)
        dx = []
        for i, want in enumerate(ref):
            lo = r * n
            keep = want["keep"].reshape(H.DP_ROWS // accum, H.DP_SEQ, k)[lo:lo + n]
            np.testing.assert_array_equal(o["keep"][i].numpy(), keep.reshape(-1, k))
            np.testing.assert_array_equal(o["y"][i].numpy(), want["y"][lo:lo + n])
            assert abs(o["lb_loss"][i] - want["lb_loss"]) <= 1e-6 * abs(want["lb_loss"]), (
                o["lb_loss"][i], want["lb_loss"])
            assert o["drop_frac"][i] == want["drop_frac"], (o["drop_frac"][i], want)
            assert 0 < want["drop_frac"] < 1
            own_differs |= not torch.equal(o["own_keep"][i], o["keep"][i])
            dx.append(one[i][lo:lo + n])
        want_dx = torch.cat(dx)
        err = float((o["dx"] - want_dx).abs().max())
        assert err <= 1e-6 * float(torch.cat(one).abs().max()), err
        jax_gap = max(float(np.abs(one[i].numpy() - w["dx"]).max()) for i, w in enumerate(ref))
        print(f"{case} rank {r}: dx gap {err} to one process; one process to the JAX "
              f"package {jax_gap}; drop_frac {[w['drop_frac'] for w in ref]}")
    assert own_differs, "per-rank routing keeps the same pairs: the case shows nothing"


# ---------------------------------------------------------------------------
# the reduced granite-moe's QAT on (2, 2) against one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(ranks):
    """One process at the configuration's one dispatch group (4 steps) from
    the same checkpoint."""
    import shutil
    cfg, _, _, _ = H.train_setup()
    src, one = ranks["dir"] / "src", ranks["dir"] / "one"
    shutil.copytree(src, one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return H.train(cfg, str(one))
    finally:
        torch.set_num_threads(threads)


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
    it again in the backward, at the same local capacity) and its input
    buffer's gradient all-gathered from the parts once, at the rows each
    call reported (`models.moe.buffer_rows`: the rank's local capacity,
    from its data group's counts), and each forward's gather of the data
    ranks' int32 (group, expert) counts; beyond those, only f32 scalars
    (the replicated scales' partial gradients and the g factors' sums over
    the ranks).
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
    calls = 2 * cfg.n_layers * H.TRAIN_STEPS  # each layer's 2 forwards a step
    c = capacity(H.BATCH * H.SEQ, cfg)  # the global batch's one group
    for j, r in enumerate(ranks["res"][4]):
        tr = r["train"]
        assert sum(tr["buffer_rows"].values()) == calls, tr["buffer_rows"]
        assert all(8 <= rows <= c and rows % 8 == 0 for rows in tr["buffer_rows"])
        # the model ranks of a data group (ranks 2 d, 2 d + 1) hold the same rows
        assert tr["buffer_rows"] == ranks["res"][4][j - j % 2]["train"]["buffer_rows"]
        # 1.5: the output gathers of both forwards, the gradient gather once
        buffers = sum(rows * n for rows, n in tr["buffer_rows"].items()) * (
            3 * cfg.n_experts * cfg.d_model * 2) // 2
        assert tr["count_bytes"] == calls * 2 * cfg.n_experts * 4  # 2 ranks, 1 group
        rest = tr["moved_by_use"]["experts"] - buffers - tr["count_bytes"]
        assert 0 <= rest <= 16 * 4 * cfg.n_layers * H.TRAIN_STEPS, (tr["moved_by_use"], buffers)
        assert rest % 4 == 0
        assert sum(tr["moved_by_use"].values()) <= sum(tr["moved"].values())
        assert tr["moved_by_use"]["obr"] > 0 and tr["moved_by_use"]["oscillation"] > 0
        assert (tr["moved_by_use"]["obr"] + tr["moved_by_use"]["oscillation"]
                <= stats["obr"] + stats["oscillation"]), (tr["moved_by_use"], stats)
        assert {k: tr["moved_by_use"][k] for k in stats} == stats


def test_training_step0_matches_one_process(ranks, one_process):
    """Step 0 on (2, 2) routes the global batch as one process does: its
    drop_frac bit-equal, its lb_loss (the data ranks' mean of each rank's
    mean probabilities against the batch's choice counts: the batch's
    Switch loss) within 1e-6 relative, and its loss within 1e-6
    relative."""
    rep = one_process
    got = ranks["res"][4][0]["train"]["metrics"][0]
    want = rep.metrics[0]
    assert abs(got["loss_main"] - want["loss_main"]) <= SUM_BAR * abs(want["loss_main"]), (
        got, want)
    assert got["drop_frac"] == want["drop_frac"], (got, want)
    assert abs(got["lb_loss"] - want["lb_loss"]) <= 1e-6 * abs(want["lb_loss"]), (
        got["lb_loss"], want["lb_loss"])
    print(f"lb_loss: the ranks' mean {got['lb_loss']}, one process {want['lb_loss']}; "
          f"drop_frac {got['drop_frac']}")
    loss0 = ranks["res"][4][0]["train"]["losses"][0]
    assert abs(loss0 - rep.losses[0]) <= 1e-6 * abs(rep.losses[0]), (loss0, rep.losses[0])


def test_training_losses_within_the_reference_bar(ranks, one_process):
    """The 4 losses within the reference's 5 % (tests/test_spmd.py) of the
    one-process port's and of the JAX package's one-device run (both at
    the configuration's one dispatch group, from the same init state); the
    gradient norm at steps 0 and 1 within 2e-3 relative of one
    process's."""
    rep = one_process
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


@pytest.mark.parametrize("groups", [1, 2])
def test_dry_run_gathers_the_routing_counts(groups):
    """The dry run on a (2, 1) mesh routes the global batch over the 2 data
    ranks: each MoE layer's forward (2 a step: the block's checkpoint runs
    it again) all-gathers the ranks' int32 (group, expert) counts, the only
    collective counted under "experts" here (no model axis); rank 0's
    buffer holds the group's capacity over its ranks, rounded up to 8,
    where the one group spans both ranks (meta tensors hold no counts: the
    balanced load), and the group's capacity where it holds a whole
    group."""
    from repro_torch.configs import shapes as shp
    from repro_torch.launch import dryrun as D
    from repro_torch.models.moe import capacity
    cfg = H.moe_config().replace(moe_dispatch_groups=groups)
    shape = shp.get_shape("train_4k", smoke=True)
    rec = D.lower_cell("granite-moe-1b-a400m", "train_4k", multi_pod=False,
                       preset="w4a4", grad_accum=8, serve_kv_bits=8, mesh_sizes=(2, 1),
                       cfg=cfg, shape=shape)
    assert rec["status"] == "ok", rec.get("traceback")
    m = rec["moe"]
    assert m["data_ranks"] == 2 and m["dispatch_groups"] == groups
    calls = 2 * cfg.n_layers * rec["grad_accum"]
    assert m["count_gather_bytes"] == calls * 2 * groups * cfg.n_experts * 4
    assert rec["collectives"]["bytes_by_use"]["experts"] == m["count_gather_bytes"]
    c = capacity(shape.global_batch * shape.seq_len // rec["grad_accum"] // groups, cfg)
    local = c if groups == 2 else max(8, (-(-c // 2) + 7) // 8 * 8)
    assert m["buffer_rows"] == {local: calls}, (m, c)


@pytest.mark.parametrize("accum", [1, 2])
def test_rows_take_a_share_of_each_microbatch(accum):
    """`Spmd.rows(batch, accum)` on data rank 0 of 2: its half of each of
    the `accum` microbatches of consecutive rows, in order (the step cuts
    them again, so microbatch i over the ranks is the batch's microbatch
    i, as the reference's train step cuts it); a microbatch whose rows do
    not split over the data ranks is refused."""
    from repro_torch.dist.spmd import Spmd
    from repro_torch.launch import dryrun as D
    batch = {"tokens": np.arange(8 * 3).reshape(8, 3), "labels": np.arange(8)}
    with D.rank0_mesh(("data", "model"), (2, 1), "cpu") as mesh:
        sp = Spmd(mesh)
        rows = sp.rows(batch, accum)
        assert sp.dp.parts == 2 and sp.dp.index == 0
        want = [0, 1, 2, 3] if accum == 1 else [0, 1, 4, 5]
        np.testing.assert_array_equal(rows["labels"], want)
        np.testing.assert_array_equal(rows["tokens"], batch["tokens"][want])
        with pytest.raises(ValueError, match="microbatches"):
            sp.rows({"labels": np.arange(8)}, 8)  # one row a microbatch
