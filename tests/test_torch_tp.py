"""Tensor-parallel compute in the port (`dist.spmd.Spmd(tp_compute=True)`)
on gloo ranks of the CPU, against the whole computation on the same inputs.

tests/_torch_tp_harness.py runs the ranks in subprocesses (each run with
its own wall-time bar, as tests/_torch_spmd_harness.py does):

* Per linear, on 2 and 4 ranks, in f32: the column-parallel wq (per-head
  N-side scale and a bias), the row-parallel wo (per-head K-side scale),
  w_in / w_out with per-tensor scales under module_l1 and lsq, the untied
  and the tied head over a padded vocab, and the vocab-parallel embedding,
  on the kernel route (the plain versions on the CPU) and, for wq / wo,
  the unfused one. Forward, dX, dW and every scale's gradient against the
  whole linear. A column slice's forward is the whole output's columns
  bit for bit (so are the heads' gathered logits and the embedding's
  rows). Where a sum over ranks enters (row-parallel outputs, the
  column-parallel dX, the replicated leaves' gradients, the l1 of a g
  factor), the bar is summation order only, in f32: 1e-6 of the largest
  magnitude of a tensor, and for dX and the 0-d leaves (sums whose terms
  cancel) 1e-6 of the size of what they sum (`_torch_tp_harness.
  magnitudes`). On the kernel route one more cause enters: the kernels
  round each rank's dX accumulator to bf16 (`kernels.ref.quant_matmul_dx`),
  so a column-parallel dX and the activation scale's and offset's
  gradients are held to 2^-8 of that size (half a bf16 ulp of each
  partial and of the whole's). A g factor taken from a slice alone is off
  by sqrt(M) and a gradient not summed over the ranks by up to M x: both
  far outside either bar.
* The reduced granite-8b training run of the sharded harness ((2, 4)
  mesh, w4a4 MDQ, 8 steps) tensor-parallel: step 0's loss within 1e-3
  relative of the one-process port; every leaf's step-0 gradient,
  gathered, within 2e-2 relative L2 of the one-process gradient, scale
  leaves included; all 8 losses within the reference's 5 % bar
  (tests/test_spmd.py) of the one-process port's and of the reference's
  one-device run.
* Every block family on a (1, 2) mesh (MoE, its experts
  expert-parallel, gemma2's local / global attention, musicgen's learned
  positions and audio frames, xlstm's mLSTM on heads and sLSTM FFN on
  d_ff, recurrentgemma's RG-LRU on channels with its local attention
  whole, llama-vision's cross-attention on heads): which sublayers run
  tensor-parallel and which stay gathered, the forward's logits, and every leaf's step-0
  gradient against one process: a tensor-parallel sublayer's leaves to
  2e-2 relative L2 and its scales to 0.2 of their kind's RMS; a gathered
  sublayer's to 2e-2 or twice the kernel route's own gap against the
  unfused route on that leaf.
* Sharded serving on a (1, 4) mesh (heads, d_ff and vocab over 4 ranks,
  the KV sequence over the same 4): the logits of a prefill and 3
  teacher-forced decode steps against the one-process model under the
  bf16 model-logits bar of tests/test_fused_qat_matmul.py (90 % of the
  logits within 1e-3, mean gap under 0.05, probabilities within 0.02,
  argmax unchanged); the engine's streams equal the tensor-parallel
  `greedy_generate`, the same on every rank.
* The dry run at smoke shapes on a (1, 4) mesh of reduced qwen1.5-0.5b:
  rank 0's dot FLOPs x 4 equal the one-rank count exactly for train,
  prefill and decode; the dots that stay whole on every rank (a serving
  chunk's attention over its own keys: the cache's heads are not split)
  are pinned op by op.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import _torch_tp_harness as H  # noqa: E402

HARNESS = os.path.join(os.path.dirname(__file__), "_torch_tp_harness.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SUM_BAR = 1e-6  # f32, summation order only


def _harness(args: list, timeout: int = 300) -> float:
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, HARNESS, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# per linear
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def linears(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_linears")
    wall = _harness(["--linears", str(out)])
    res = {m: [torch.load(out / f"m{m}_rank{r}.pt") for r in range(m)] for m in (2, 4)}
    return res, wall


def _model_dim(spec):
    for d, entry in enumerate(spec or ()):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return d
    return None


def _assemble(parts: list, dim) -> torch.Tensor:
    """The ranks' slices along `dim` in rank order; a replicated tensor
    (dim None) must be the same bits on every rank."""
    if dim is None:
        for p in parts[1:]:
            assert torch.equal(p, parts[0])
        return parts[0]
    return torch.cat(parts, dim)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / max(scale, 1e-30)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("case", list(H.LINEAR_CASES))
def test_sliced_linear_matches_whole(linears, case, ranks):
    res, _ = linears
    ranks_out = [r[case] for r in res[ranks]]
    whole = H.run_case(case)
    name = H.LINEAR_CASES[case][0]
    column = name in ("wq", "w_in")
    y = _assemble([r["y"] for r in ranks_out], 2 if column else None)
    assert y.shape == whole["y"].shape
    if name in ("wo", "w_out"):  # partial products summed over the ranks
        assert _rel(y, whole["y"]) < SUM_BAR, _rel(y, whole["y"])
    else:
        assert torch.equal(y, whole["y"]), _rel(y, whole["y"])
    specs = ranks_out[0]["specs"]
    mags = H.magnitudes(case)
    # the kernels round each rank's dX accumulator to bf16
    # (`kernels.ref.quant_matmul_dx`): a column-parallel dX, and the
    # activation scale's and offset's gradients summed from it, carry half
    # a bf16 ulp (2^-9) of every rank's partial and of the whole's
    kernel_col = (H.LINEAR_CASES[case][2] == "auto"
                  and name in ("wq", "w_in", "lm_head", "tied"))
    assert set(ranks_out[0]["grads"]) == set(whole["grads"])
    split = 0
    for key, want in whole["grads"].items():
        if key == "x":
            dim = 2 if name in ("wo", "w_out") else None
        else:
            dim = _model_dim(specs[key])
            split += dim is not None
        got = _assemble([r["grads"][key] for r in ranks_out], dim)
        assert got.shape == want.shape, key
        assert torch.isfinite(got).all(), key
        if key in mags:  # held against the size of what it sums
            k = 2.0 ** -8 if kernel_col and key.split("/")[-1] in (
                "x", "a_scale", "a_offset") else SUM_BAR
            err = (got - want).abs()
            assert bool((err <= k * torch.as_tensor(mags[key])).all()), (
                key, float(err.max()), k * float(torch.as_tensor(mags[key]).max()))
        else:
            assert _rel(got, want) < SUM_BAR, (key, _rel(got, want))
    assert split >= 1  # the weight (and a per-head scale) split over the ranks


def test_linears_harness_wall_time(linears):
    assert linears[1] <= 60.0, linears[1]


# ---------------------------------------------------------------------------
# the reduced granite-8b training run on a (2, 4) mesh
# ---------------------------------------------------------------------------

LOSS0_BAR, GRAD_BAR, LOSS_BAR, GNORM_BAR, SCALAR_BAR = 1e-3, 2e-2, 0.05, 2e-3, 0.2


@pytest.fixture(scope="module")
def training(tmp_path_factory):
    import jax
    import _torch_spmd_harness as SH
    from test_torch_spmd import _reference
    from repro_torch import bridge
    from repro_torch.dist.spmd import WHOLE
    from repro_torch.launch.train import run_training
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import CheckpointManager
    from repro_torch.train.state import init_state
    tmp = tmp_path_factory.mktemp("tp_train")
    state0, ref_losses = _reference()
    cfg, qcfg, tcfg, dcfg = SH.setup()
    src = str(tmp / "src")
    ckpt.save(src, bridge.state_from_jax(jax.tree.map(np.asarray, state0), cfg, "cpu",
                                         qcfg=qcfg), 0)
    wall = _harness(["--train", src, str(tmp)])
    res = torch.load(tmp / "train.pt")
    like = init_state(cfg, qcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    params = ckpt.restore(src, like, step=0)["params"]
    loss0, grads = H.step0_grads(params, cfg, qcfg, tcfg, dcfg, WHOLE)
    one = str(tmp / "one")
    import shutil
    shutil.copytree(src, one)
    rep = run_training(cfg, qcfg, tcfg, dcfg, steps=H.TRAIN_STEPS, batch_size=8,
                       seq_len=16, ckpt_dir=one, log_every=0, device="cpu",
                       mgr=CheckpointManager(one, save_every=10 ** 6, async_io=False))
    res.update(wall=wall, losses_ref=ref_losses, loss0_1proc=float(loss0),
               grads_1proc=grads, losses_1proc=rep.losses,
               grad_norms_1proc=rep.grad_norms)
    return res


def test_training_runs_tensor_parallel(training):
    """Every layer's attention and FFN, the embedding and the head split
    over the 4 model ranks; the run is finite and learns."""
    assert training["mesh"] == {"data": 2, "model": 4}
    assert all(a and f for a, f in training["tp"].values())
    assert training["embed_tp"] and training["head_tp"]
    assert np.isfinite(training["losses"]).all()
    assert training["losses"][-1] < training["losses"][0]


def test_training_step0_matches_one_process(training):
    """Step 0's loss within 1e-3 relative of one process; its gradient,
    gathered, leaf by leaf: every leaf with axes (weights, per-head scales,
    biases, norms, the table) within 2e-2 relative L2. A 0-d leaf (a
    per-tensor weight scale, an activation scale or offset) is one sum over
    a whole tensor whose Eq. 7 terms cancel, so its own relative gap
    measures that cancellation (at step 0 up to 11 % of a leaf's value;
    the unfused f32 route moves them as far, through activation codes that
    flip on a reordered f32 sum): each is held instead to 0.2 of the RMS of
    its kind over the model, which a missing sum over the model ranks or
    a g factor from a slice (an error of the order of the leaf itself, in
    every linear of the kind) breaks. The per-linear tests hold each 0-d
    leaf's sum and g factor exactly."""
    from repro_torch import tree as T
    from repro_torch.dist import sharding
    a, b = training["loss0"], training["loss0_1proc"]
    assert abs(a - b) / abs(b) < LOSS0_BAR, (a, b)
    paths = [p for p, _, _ in sharding.with_specs(training["grads_1proc"],
                                                  training["grads_1proc"])]
    got, want = T.leaves(training["grads"]), T.leaves(training["grads_1proc"])
    assert len(got) == len(want) == len(paths)
    kinds: dict = {}
    for path, g, w in zip(paths, got, want):
        assert g.shape == w.shape, path
        assert torch.isfinite(g).all(), path
        if w.dim() == 0:
            kinds.setdefault(path[-1], []).append((path, float(g), float(w)))
            continue
        rel = float((g - w).norm() / w.norm())
        assert rel < GRAD_BAR, (path, rel)
    assert set(kinds) == {"w_scale", "a_scale", "a_offset"}
    for kind, leaves in kinds.items():
        rms = float(np.sqrt(np.mean([w * w for _, _, w in leaves])))
        worst = max((abs(g - w) / rms, path) for path, g, w in leaves)
        print(f"{kind}: {len(leaves)} leaves, largest gap {worst[0]:.3e} of the RMS "
              f"({worst[1]})")
        assert worst[0] < SCALAR_BAR, (kind, worst)


def test_training_losses_within_the_reference_bar(training):
    """All 8 losses within the reference's 5 % (tests/test_spmd.py) of the
    one-process port's and of the reference's one-device run; the
    gradient's norm at steps 0 and 1 (the same weights: lr is 0 at step 0)
    within 2e-3 relative of one process's, which a gradient scaled by a
    factor breaks."""
    for base in (training["losses_1proc"], training["losses_ref"]):
        for x, y in zip(training["losses"], base):
            assert abs(x - y) / abs(y) < LOSS_BAR, (training["losses"], base)
    ga, gb = training["grad_norms"], training["grad_norms_1proc"]
    gaps = [abs(x - y) / y for x, y in zip(ga[:2], gb[:2])]
    print(f"gradient norm gaps at steps 0-1: {gaps}")
    assert max(gaps) < GNORM_BAR, (ga, gb)


def test_training_harness_wall_time(training):
    assert training["wall"] <= 90.0, training["wall"]


# ---------------------------------------------------------------------------
# every block family on a (1, 2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def families(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_archs")
    wall = _harness(["--archs", str(out)])
    return torch.load(out / "archs.pt"), wall


# per family: the sublayers that must run tensor-parallel, (mixer, FFN,
# cross-attention) by layer (`models.model.layer_tp`), on 2 model ranks of
# the reduced configs (4 heads, d_ff 96, padded vocab 272 split in 2; an
# MoE FFN's 4 experts split 2 a rank, expert-parallel; lru_width 64): the
# mLSTM on its heads, the sLSTM's own FFN on its d_ff (its cell stays
# whole: no mixer split), the RG-LRU on its channels and the cross layer's
# xq / xk / xv / xo on heads; an attention whose one kv head does not
# split (recurrentgemma's local layer) stays gathered
FAMILY_TP = {
    "granite-moe-1b-a400m": [(True, True, False)] * 2,
    "gemma2-2b": [(True, True, False)] * 2,
    "musicgen-medium": [(True, True, False)] * 2,
    "xlstm-350m": [(True, False, False)] * 7 + [(False, True, False)],
    "recurrentgemma-9b": [(True, True, False)] * 2 + [(False, True, False),
                                                      (True, True, False)],
    "llama-3.2-vision-11b": [(True, True, False)] * 4 + [(True, True, True)],
}


# the route-gap allowance's readings (the bf16 w4a4 reduced configs, seed
# 0, 2 x 16 tokens): a gathered leaf's step-0 gap to one process, against
# its kernel route's own gap to the unfused route. Every leaf of a gathered
# sublayer past 2e-2: 3 of xlstm's sLSTM cell, s_o's a_scale 0.028 (route
# 0.045), s_f's 0.059 (0.067) and s_i's bias 1.775 (1.573: the stabilised
# input gate's gradient cancels); 3 of recurrentgemma's local attention
# (whose one kv head does not split), wv's w_scale 0.030 (0.432), wk's
# a_offset 0.030 (1.146) and w_scale 0.054 (0.851). No leaf of a
# tensor-parallel sublayer takes it: the worst of those are xlstm's mv w
# 0.012, recurrentgemma's lam 0.016 and llama-vision's wq w 0.010 (bar
# 2e-2), and their scales' 0.051 of their kind's RMS (bar 0.2).
ROUTE_GAP_FACTOR = 2.0
_SCALES = ("w_scale", "a_scale", "a_offset")


# a split mixer's leaves: the attention's, the mLSTM's, the RG-LRU's
# (under "rg", beside the block's unread ln1)
MIXER_LEAVES = ("ln1", "wq", "wk", "wv", "wo", "ln", "m_up_gate", "m_up", "conv_w",
                "mq", "mk", "mv", "m_i", "m_f", "hn_g", "m_down", "rg")
CROSS_LEAVES = ("ln_x", "xq", "xk", "xv", "xo", "xgate")


def _in_tp_sublayer(path: tuple, tp: list, head_tp: bool) -> bool:
    """The leaf at `path` belongs to a sublayer that ran tensor-parallel:
    the embedding / head, or a split mixer's (`MIXER_LEAVES`: an
    attention's ln1, wq / wk / wv / wo; an mLSTM's leaves; an RG-LRU's),
    dense or sLSTM FFN's (ln2, w_in / w_gate / w_out), MoE FFN's (ln2, and
    the router and experts under moe) or cross-attention's (ln_x, xq / xk /
    xv / xo, xgate) leaves. An sLSTM's cell leaves (its mixer runs whole)
    are not."""
    if path[0] in ("embed", "lm_head"):
        return head_tp
    if path[0] != "layers":
        return False
    mixer, ffn, cross = tp[path[1]]
    return ((mixer and path[2] in MIXER_LEAVES)
            or (ffn and path[2] in ("ln2", "w_in", "w_gate", "w_out", "moe"))
            or (cross and path[2] in CROSS_LEAVES))


@pytest.mark.parametrize("arch", list(FAMILY_TP))
def test_every_block_family_tensor_parallel(families, arch):
    """Reduced `arch` on a (1, 2) mesh: the split sublayers are the ones
    the rules split, the rest is gathered whole; the forward's logits
    within the bf16 model-logits bar (bit-equal here); every leaf's step-0
    gradient, gathered, against one process's. A leaf of a sublayer that
    ran tensor-parallel: its weights, biases, norms and the table within
    2e-2 relative L2; its scales (w_scale, a_scale, a_offset: sums whose
    Eq. 7 terms cancel, so the reordered sums move them by a share of
    their own size, as in the training test) each element within 0.2 of
    the RMS of its kind over those sublayers, which a missing sum or a g
    factor from a slice breaks. A leaf of a gathered sublayer (the sLSTM's
    cell, an attention whose kv heads do not split), where no
    tensor-parallel code runs and only
    the reordered backward reaching it moves it: within 2e-2 or twice the
    gap the kernel route itself leaves against the unfused route on that
    leaf (`ROUTE_GAP_FACTOR`, readings above)."""
    from repro_torch import tree as T
    from repro_torch.dist import sharding
    res = families[0][arch]
    assert [tuple(x) for x in res["tp"]] == FAMILY_TP[arch]
    assert res["head_tp"]
    whole, off = H.arch_case(arch), H.arch_case(arch, route="off")
    a, b = res["logits"], whole["logits"]
    d = (a - b).abs().numpy()
    assert np.quantile(d, 0.9) < 1e-3 and d.mean() < 0.05
    assert torch.equal(a.argmax(-1), b.argmax(-1))
    paths = [p for p, _, _ in sharding.with_specs(whole["grads"], whole["grads"])]
    scales: dict = {}
    n_tp = 0
    for path, g, w, o in zip(paths, T.leaves(res["grads"]), T.leaves(whole["grads"]),
                             T.leaves(off["grads"])):
        assert g.shape == w.shape and torch.isfinite(g).all(), path
        norm = max(float(w.norm()), 1e-30)
        rel = float((g - w).norm()) / norm
        if _in_tp_sublayer(path, res["tp"], res["head_tp"]):
            n_tp += 1
            if path[-1] in _SCALES:
                scales.setdefault(path[-1], []).append((path, g.flatten(), w.flatten()))
            else:
                assert rel < GRAD_BAR, (path, rel)
            continue
        route = float((o - w).norm()) / norm
        assert rel < max(GRAD_BAR, ROUTE_GAP_FACTOR * route), (path, rel, route)
    assert n_tp > 0
    for kind, leaves in scales.items():
        rms = float(torch.cat([w for _, _, w in leaves]).pow(2).mean().sqrt())
        worst = max((float((g - w).abs().max()) / rms, path) for path, g, w in leaves)
        assert worst[0] < SCALAR_BAR, (kind, worst)


def test_families_harness_wall_time(families):
    assert families[1] <= 60.0, families[1]


# ---------------------------------------------------------------------------
# sharded serving on a (1, 4) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_serve")
    wall = _harness(["--serve", str(out)])
    return [torch.load(out / f"serve{r}.pt") for r in range(H.SERVE_RANKS)], wall


def test_serving_runs_tensor_parallel(serving):
    ranks, _ = serving
    for r in ranks:
        assert all(a and f for a, f in r["tp"])
        assert r["embed_tp"] and r["head_tp"]
        assert r["kv_rows"] == 64  # 8 + 4 rows rounded up to 4 x 64: one split a rank


def test_serving_logits_within_the_bf16_logits_bar(serving):
    """The tensor-parallel logits (a one-chunk prefill and 3 teacher-forced
    decode steps) against the one-process model on the gathered params,
    under tests/test_fused_qat_matmul.py's bf16 model-logits bar."""
    r = serving[0][0]
    a = r["tp_logits"][..., :r["vocab"]]
    b = r["one_logits"][..., :r["vocab"]]
    assert torch.isfinite(a).all()
    d = (a - b).abs().numpy()
    print(f"logits: max |gap| {d.max():.3e}, bit-equal share {(d == 0).mean():.4f}")
    assert np.quantile(d, 0.9) < 1e-3, np.quantile(d, 0.9)
    assert d.mean() < 0.05, d.mean()
    assert float((a.softmax(-1) - b.softmax(-1)).abs().max()) < 0.02
    assert torch.equal(a.argmax(-1), b.argmax(-1))


def test_serving_streams_equal_tensor_parallel_greedy(serving):
    ranks, _ = serving
    streams = ranks[0]["streams"]
    for r in ranks:
        assert r["streams"] == streams
        assert r["greedy"] == [streams[f"req-{i}"] for i in range(len(streams))]


def test_serving_harness_wall_time(serving):
    assert serving[1] <= 60.0, serving[1]


# ---------------------------------------------------------------------------
# the dry run: rank 0 of a (1, 4) mesh counts its slices
# ---------------------------------------------------------------------------

DRY_SHAPES = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
# the recurrent families' training cells, each cut to blocks that split
# whole (the sLSTM's cell and recurrentgemma's one-kv-head local attention
# stay whole on every rank, so their dots do not shrink): (arch, the
# pattern it is cut to, or None for its own)
DRY_RECURRENT = {"train-xlstm": ("xlstm-350m", "mlstm"),
                 "train-recurrentgemma": ("recurrentgemma-9b", "rglru"),
                 "train-llama-vision": ("llama-3.2-vision-11b", None)}


def _dry(kind: str, mesh: tuple) -> dict:
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.base import BlockDef
    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.launch import dryrun as D
    arch, mixer = DRY_RECURRENT.get(kind, ("qwen1.5-0.5b", None))
    cfg = reduced_config(get_config(arch))
    if mixer is not None:
        ffn = "dense" if mixer == "rglru" else "none"
        cfg = cfg.replace(pattern=(BlockDef(attn=mixer, ffn=ffn),), n_layers=2)
    shape = DRY_SHAPES.get(kind, "train_4k")
    rec = D.lower_cell(arch, shape, multi_pod=False, preset="w4a4",
                       grad_accum=8, serve_kv_bits=8, mesh_sizes=mesh, cfg=cfg,
                       shape=shp.get_shape(shape, smoke=True))
    assert rec["status"] == "ok", rec.get("traceback")
    return rec


@pytest.mark.parametrize("kind", list(DRY_SHAPES) + list(DRY_RECURRENT))
def test_dry_run_rank0_counts_its_slices(kind):
    """Reduced qwen1.5-0.5b (4 heads, d_ff 96, padded vocab 272: each
    splits in 4) at smoke shapes, and the training step of the reduced
    recurrent families (`DRY_RECURRENT`: two mLSTM blocks of xlstm-350m,
    two RG-LRU blocks with their FFN of recurrentgemma-9b, llama-3.2-vision
    with its cross layer; heads, lru_width 64 and d_ff split in 4): rank
    0's dot FLOPs on a (1, 4) mesh, x 4,
    equal the one-rank count exactly, op by op (each kernel and each aten
    dot), except the dots that stay whole on every rank, pinned: a
    serving chunk's attention over its own keys (`attend_chunk`'s
    `_grouped_scores` / `_grouped_pv`, aten::bmm: the KV cache splits its
    rows over the model ranks, not its heads, so q, k and v are gathered
    over heads first), n_layers x (2 B H C^2 D) for the scores plus as
    much for P.V at prefill (C = seq_len), and the scores alone at decode
    (one key: P.V is a broadcast multiply, not a dot). Training has none.
    Rank 0 also records the model axis's collectives: in training
    all-reduces and no all-gather (the loss reads rank 0's logit columns,
    each row's max and its two sums all-reduced under the use "loss":
    tokens x 3 x 4 B), all-gathers in serving (its row-parallel partials
    are gathered and summed in rank order, and the logits gathered whole;
    what all-reduces remain there are g factors' l1). An mLSTM or RG-LRU
    block all-gathers its conv's output over the model ranks (and the
    gradients of its conv_w / hn_g / lam parts); the cross layer gathers
    nothing."""
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config, reduced_config
    one, four = _dry(kind, (1, 1)), _dry(kind, (1, 4))
    if kind in DRY_RECURRENT:
        for op in set(one["cost"]["by_op"]) | set(four["cost"]["by_op"]):
            assert 4 * four["cost"]["by_op"].get(op, {}).get("flops", 0) == (
                one["cost"]["by_op"].get(op, {}).get("flops", 0)), op
        assert 4 * four["cost"]["flops"] == one["cost"]["flops"] > 0
        gathers = four["collectives"]["count_by_op"].get("all-gather", 0)
        assert (gathers > 0) == (DRY_RECURRENT[kind][1] is not None), gathers
        assert one["collectives"]["total_count"] == 0
        return
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    spec = shp.get_shape(DRY_SHAPES[kind], smoke=True)
    b, h, d = spec.global_batch, cfg.n_heads, cfg.head_dim_
    c = spec.seq_len if kind == "prefill" else 1
    whole = {"train": 0, "prefill": cfg.n_layers * 2 * (2 * b * h * c * c * d),
             "decode": cfg.n_layers * 2 * b * h * d}[kind]
    ops = set(one["cost"]["by_op"]) | set(four["cost"]["by_op"])
    flops = lambda r, op: r["cost"]["by_op"].get(op, {}).get("flops", 0)  # noqa: E731
    for op in ops:
        if op == "aten::bmm" and kind != "train":
            assert flops(four, op) == flops(one, op) == whole, op
        else:
            assert 4 * flops(four, op) == flops(one, op), op
    assert 4 * four["cost"]["flops"] - 3 * whole == one["cost"]["flops"]
    assert one["cost"]["flops"] > 4 * whole  # the split dots dominate
    by = four["collectives"]["count_by_op"]
    if kind == "train":
        assert by.get("all-gather", 0) == 0 and by.get("all-reduce", 0) > 0
        assert four["collectives"]["bytes_by_use"]["loss"] == four["tokens_per_step"] * 3 * 4
    else:
        assert by.get("all-gather", 0) > 0
    assert one["collectives"]["total_count"] == 0
