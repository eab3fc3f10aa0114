"""The port's sharded runtime on 8 gloo ranks of the CPU: the twin of
tests/test_spmd.py (whose harness runs the JAX package on 8 host devices).

tests/_torch_spmd_harness.py runs in a subprocess that spawns the ranks on a
(2, 4) (data, model) mesh: the reference's reduced granite-8b (2 layers,
d_model 64, 4 heads, d_ff 96, w4a4 MDQ, AdamW lr 3e-3), 8 x 16 batches, 8
steps through `launch.train.run_training(model_parallel=4)`, starting from
the reference's init_state (bridged, saved by one process at step 0, and
restored as each rank's slices); then `compressed_psum` over the data axis
and a decode with a sequence-sharded cache. The reference's four cases keep
their bars; the port is further held to its one-process run (step 0 within
1e-6 relative), to the reference's `compressed_psum` under `jax.vmap`
(bit-equal), and its sharded decode to the unsharded `decode_step` of the
gathered params (within 1e-4, the serving tests' bar on f32 logits).

The harness's sharded decode is not asserted bit-equal: each rank's 4
cache rows are a fraction of the flash-decode kernel's 64-key split, and on
the CPU the kernel's plain version sums a whole row's keys in one pass,
while the sharded route rescales each rank's partial sums by exp(m_r - m)
before adding them, which rounds otherwise. Where each rank holds whole
splits, the merge of every rank's split triples is the kernel's own merge
of the whole cache, bit for bit: held here against the CPU emulation of
the kernel's split-and-merge, and on the card by chip_smoke.py phase 24
(a 256-row cache, 2 splits a rank).

Also here: a world of one, with a gloo group of one process or without a
group, gives the same bits for training and serving; a model axis that does
not divide the world raises.
"""
import contextlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.registry import get_config as j_get_config, reduced_config as j_reduced
from repro.core.policy import QuantConfig as JQuantConfig
from repro.data.synthetic import DataConfig as JDataConfig, sample_batch as j_sample
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.grad_compress import compressed_psum as j_compressed_psum
from repro.train.state import TrainConfig as JTrainConfig, init_state as j_init_state
from repro.train.train_step import make_train_step as j_make_train_step

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import _torch_spmd_harness as H  # noqa: E402

HARNESS = os.path.join(os.path.dirname(__file__), "_torch_spmd_harness.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _reference():
    """The reference harness's one-device run and its init state."""
    cfg = j_reduced(j_get_config("granite-8b")).replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=96)
    qcfg = JQuantConfig(w_bits=4, a_bits=4, mode="mdq")
    tcfg = JTrainConfig(total_steps=20, warmup_steps=2,
                        adamw=JAdamWConfig(lr_peak=3e-3))
    dcfg = JDataConfig(p_noise=0.05)
    state0 = j_init_state(jax.random.PRNGKey(0), cfg, qcfg, tcfg)
    step = jax.jit(j_make_train_step(cfg, qcfg, tcfg))
    state, losses = state0, []
    for i in range(8):
        state, m = step(state, j_sample(cfg, dcfg, i, 8, 16))
        losses.append(float(m["loss"]))
    return state0, losses


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    from repro_torch import bridge
    from repro_torch.launch.train import run_training
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import CheckpointManager
    tmp = tmp_path_factory.mktemp("spmd")
    state0, ref_losses = _reference()
    cfg, qcfg, tcfg, dcfg = H.setup()
    port0 = bridge.state_from_jax(jax.tree.map(np.asarray, state0), cfg, "cpu",
                                  qcfg=qcfg)
    src = str(tmp / "src")
    ckpt.save(src, port0, 0)
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = str(tmp / "out.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, HARNESS, src, out], env=env,
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        res = json.load(f)
    # the one-process port from the same checkpoint
    one = str(tmp / "one")
    shutil.copytree(src, one)
    rep = run_training(cfg, qcfg, tcfg, dcfg, steps=8, batch_size=8, seq_len=16,
                       ckpt_dir=one, log_every=0, device="cpu",
                       mgr=CheckpointManager(one, save_every=10 ** 6, async_io=False))
    res.update(losses_ref=ref_losses, losses_1proc=rep.losses,
               grad_norms_1proc=rep.grad_norms, wall=wall)
    return res


def test_sharded_train_step_runs(result):
    assert result["n_ranks"] == 8 and result["mesh"] == {"data": 2, "model": 4}
    assert result["backend"] == "gloo"
    assert result["losses"][-1] < result["losses"][0]
    assert result["finite"]


def test_sharded_equals_single_device(result):
    """The sharded loss trajectory against the reference's one-device run
    (the reference's bar: 5 % relative)."""
    for x, y in zip(result["losses"], result["losses_ref"]):
        assert abs(x - y) / max(abs(y), 1e-6) < 0.05, (result["losses"],
                                                       result["losses_ref"])


def test_sharded_matches_one_process_port(result):
    """Losses, and the gradient's norm at steps 0 and 1, which run on the
    same weights (lr is 0 at step 0). The norm witnesses the gradient's
    scale, which Adam's step, and so the loss, hardly shows: a model-axis
    gradient summed once per model rank makes it 4x, a data mean left
    undivided 2x, with the losses of the first steps unmoved."""
    a, b = result["losses"], result["losses_1proc"]
    assert abs(a[0] - b[0]) / abs(b[0]) < 1e-6, (a, b)
    gap = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    ga, gb = result["grad_norms"], result["grad_norms_1proc"]
    ggap = [abs(x - y) / y for x, y in zip(ga[:2], gb[:2])]
    print(f"largest relative loss gap over 8 steps: {gap:.3e}; "
          f"gradient norm gaps at steps 0-1: {ggap}")
    assert gap < 0.05, (a, b)
    assert max(ggap) < 2e-4, (ga, gb)


def test_compressed_psum_close_to_exact(result):
    x = H.psum_input()
    exact = x.mean(0)
    got = np.asarray(result["psum"], np.float32)
    rel = np.linalg.norm(got - exact) / np.linalg.norm(exact)
    assert rel < 0.02, rel


def test_compressed_psum_bit_equal_to_reference_vmap(result):
    x = jnp.asarray(H.psum_input()[:, None, :])  # rank d holds row d
    ref = jax.vmap(lambda v: j_compressed_psum(v, "data"), axis_name="data")(x)
    np.testing.assert_array_equal(np.asarray(result["psum"], np.float32),
                                  np.asarray(ref[0, 0]))


@pytest.mark.parametrize("route", ["auto", "off"])
def test_sharded_decode(result, route):
    dec = result["decode"][route]
    assert dec["finite"]
    assert dec["cache_rows_per_rank"] == 4 and dec["batch_rows_per_rank"] == 4
    assert dec["max_abs_diff"] <= 1e-4, dec
    print(f"route {route}: sharded decode bit-equal to unsharded: {dec['bit_equal']}")


@pytest.mark.parametrize("storage", ["fp", "int8", "int4"])
@pytest.mark.parametrize("ranks", [2, 4])
def test_sequence_split_merge_is_the_kernels_merge(storage, ranks):
    """256 cache rows over 2 or 4 ranks, each a whole number of 64-key
    splits (slot 0 half written, slot 1 full, slot 2 idle): every rank's
    split triples (`pooled_decode_attention(parts=True)`), all of them
    merged in rank order by `merge_partials` (the sequence-sharded decode's
    merge), are bit-equal to the kernel's split-and-merge of the whole
    cache, emulated on the CPU."""
    from test_torch_serving_tc import _attention_inputs, _split_merge
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import merge_partials
    rng = np.random.default_rng(7 + ranks)
    q, k, v, ks, vs, pos, q_pos = _attention_inputs(rng, storage=storage, t=256)
    kw = dict(q_per_kv=2, window=0, softcap=0.0)
    whole = _split_merge(q, k, v, ks, vs, pos, q_pos, **kw)
    n = 256 // ranks
    cut = lambda x, r: None if x is None else x[:, r * n:(r + 1) * n]
    parts = [da.pooled_decode_attention(q, cut(k, r), cut(v, r), cut(ks, r), cut(vs, r),
                                        cut(pos, r), q_pos, parts=True, **kw)
             for r in range(ranks)]
    assert parts[0][0].shape[0] == n // da.KV_SPLIT
    merged = merge_partials(*(torch.cat([p[i] for p in parts]) for i in range(3)))
    for got, want in zip(merged, whole):
        assert torch.equal(got, want)


def test_harness_wall_time(result):
    assert result["wall"] <= 60.0, result["wall"]


def test_sharded_moe_equals_one_process(tmp_path):
    """Kernels 2 and 6 under a mesh: 4 model ranks holding the same rows
    (expert-parallel expert weights, OBR on gathered leaves, the
    oscillation state on slices, compression's all-reduced amax, the
    sentinel's flags) give one process's losses and metrics bit for bit.
    (Where the data axis splits the rows, the data ranks route the global
    batch together: tests/test_torch_ep.py holds that against the JAX
    package's `moe_ffn` and one process.)"""
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = str(tmp_path / "moe.json")
    proc = subprocess.run([sys.executable, HARNESS, "--moe", out], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        sharded = json.load(f)
    one = H.moe_run(str(tmp_path / "one"))
    assert sharded["mesh"] == {"data": 1, "model": 4}
    assert sharded["losses"] == one.losses
    assert sharded["metrics"] == one.metrics
    assert sharded["healths"] == one.healths == [0, 0, 0]
    assert one.metrics[-1]["osc_frac"] > 0 and one.metrics[-1]["loss_obr"] > 0


def test_no_tp_is_data_parallel_over_the_model_axis(tmp_path):
    """no_tp: 4 ranks of a (1, 4) mesh each take 2 of the 8 rows with the
    weights whole; the losses follow one process's (step 0 within 1e-6
    relative, the bar of the (2, 4) run)."""
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = str(tmp_path / "no_tp.json")
    proc = subprocess.run([sys.executable, HARNESS, "--no-tp", out], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out) as f:
        sharded = json.load(f)
    losses, rows, nbytes = H.no_tp_losses()
    assert sharded["mesh"] == {"data": 1, "model": 4}
    assert sharded["rows"] == 2 and rows == 8
    assert sharded["state_bytes"] == nbytes  # nothing split
    a, b = sharded["losses"], losses
    assert abs(a[0] - b[0]) / abs(b[0]) < 1e-6, (a, b)
    assert max(abs(x - y) / abs(y) for x, y in zip(a, b)) < 0.05, (a, b)


def test_sharded_serving_cache_holds_whole_splits(tmp_path):
    """The serving CLI on 2 model ranks: 8 + 4 cache rows rounded up to
    2 x 64, so each rank holds one whole key split of the decode kernel;
    the ranks' streams agree and are the one process's length."""
    from repro_torch.launch import serve
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    out = str(tmp_path / "serve.json")
    proc = subprocess.run([sys.executable, HARNESS, "--serve", out], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = []
    for r in range(2):
        with open(f"{out}.{r}") as f:
            ranks.append(json.load(f))
    one = serve.main(H.SERVE_ARGV)
    assert [r["kv_rows"] for r in ranks] == [64, 64]
    assert int(one.engine.executor.pool["layers"][0]["kv"].k.shape[1]) == 12
    assert ranks[0]["streams"] == ranks[1]["streams"]
    assert ({k: len(v) for k, v in ranks[0]["streams"].items()}
            == {k: len(v.tokens) for k, v in one.engine.results.items()})


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def group_of_one():
    """A gloo process group of this one process, for the block."""
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _train(ckpt_dir, model_parallel=None):
    from repro_torch.launch import train
    argv = ["--device", "cpu", "--smoke", "--arch", "qwen1.5-0.5b", "--quant", "w4a4",
            "--steps", "3", "--batch", "2", "--seq", "16", "--save-every", "2",
            "--ckpt", str(ckpt_dir)]
    if model_parallel is not None:
        argv += ["--model-parallel", str(model_parallel)]
    return train.main(argv)


def test_world_of_one_training_is_bit_equal(tmp_path):
    plain = _train(tmp_path / "a")
    flag = _train(tmp_path / "b", 1)
    with group_of_one():
        sharded = _train(tmp_path / "c", 1)
        # the sharded path resumes from the single-process checkpoint (step 2)
        resumed = _train(tmp_path / "a", 1)
    assert plain.mesh.world == flag.mesh.world == 1
    assert plain.mesh.backend is None and flag.mesh.backend is None
    assert sharded.mesh.world == 1 and sharded.mesh.backend == "gloo"
    assert sharded.losses == plain.losses == flag.losses
    assert resumed.start_step == 3 and resumed.steps_run == 0


def test_world_of_one_serving_is_bit_equal():
    from repro_torch.launch import serve
    argv = ["--device", "cpu", "--smoke", "--quant", "w4a4", "--batch", "3",
            "--slots", "2", "--prompt-len", "8", "--new-tokens", "4", "--chunk", "4"]
    plain = serve.main(argv)
    with group_of_one():
        sharded = serve.main(argv + ["--model-parallel", "1"])
    assert plain.spmd.whole and plain.spmd.mesh.backend is None
    assert sharded.spmd.whole and sharded.spmd.mesh.backend == "gloo"
    assert ({k: v.tokens for k, v in sharded.engine.results.items()}
            == {k: v.tokens for k, v in plain.engine.results.items()})


def test_model_axis_must_divide_the_world():
    from repro_torch.launch.mesh import make_host_mesh
    with group_of_one():
        with pytest.raises(ValueError, match="does not divide"):
            make_host_mesh(2, "cpu")
    with pytest.raises(ValueError, match="does not divide"):
        make_host_mesh(3, "cpu")  # a world of one without a group
