"""Gradient compression (`repro_torch.optim.grad_compress`) against the
JAX package's `repro.optim.grad_compress`, and wired into the train step.

Bars:
  * `compress_leaf` / `compress_tree` bit-equal to the reference on equal
    inputs (seeded numpy gradients, an all-zero leaf at the 1e-12 scale
    floor, a bf16 leaf, and the reference's own gradient tree of a step);
  * the three compression cases of tests/test_train_runtime.py;
  * one step with `compress_grads=True` from bridged params (reduced
    qwen1.5-0.5b, w4a4, f32, the reference's loss unrolled without remat as
    in tests/test_torch_train_step.py): per leaf the two int8 scales within
    1e-4 relative (the gradients' own bar; a weight scale's gradient, a sum
    with much cancellation, normalized there by its sum of |summands|, so
    its int8 scale here by that over 127), every code equal or one step
    apart where the two gradients straddle a rounding boundary (counted),
    the error trees within one scale step, and the updated params within
    1e-6 where the codes agree and the gradient exceeds 1e-3 of the leaf's
    largest (the train-step bar);
  * a checkpoint round trip of a state that carries "err".
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import one_torch_thread, train_batch, train_states  # noqa: E402,F401
from test_torch_train_step import _w_scale_norms  # noqa: E402
from repro.core import kd as j_kd  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim import schedule as j_schedule  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.data.synthetic import DataConfig, sample_batch  # noqa: E402
from repro_torch.optim import grad_compress as gc  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.train.state import TrainConfig, init_state  # noqa: E402


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _leaves_np():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((64, 48)) * 0.02).astype(np.float32),
            "big": (rng.standard_normal((300,)) * 40).astype(np.float32),
            "zero": np.zeros((5, 7), np.float32),
            "one": np.asarray(3e-13, np.float32).reshape(()),
            "bf16": (rng.standard_normal((33, 9)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("name", ["w", "big", "zero", "one", "bf16"])
def test_compress_leaf_bit_equal(name):
    """Twice in a row (the second call with the first's error), so the
    error feedback is compared too; the bf16 leaf goes in as bf16; the
    zero leaves start from a zero error (the 1e-12 scale floor)."""
    g = _leaves_np()[name]
    rng = np.random.default_rng(1)
    err = np.asarray(rng.standard_normal(g.shape) * 1e-3, np.float32)
    if name in ("zero", "one"):
        err = np.zeros_like(g)
    jg = jnp.asarray(g, jnp.bfloat16 if name == "bf16" else jnp.float32)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32)))
    if name == "bf16":
        tg = tg.to(torch.bfloat16)
    je, te = jnp.asarray(err), torch.from_numpy(err)
    for _ in range(2):
        jd, je = jgc.compress_leaf(jg, je)
        td, te = gc.compress_leaf(tg, te)
        assert td.dtype == te.dtype == torch.float32
        assert np.array_equal(_bits(td), _bits(jd))
        assert np.array_equal(_bits(te), _bits(je))
    if name == "zero":
        assert not td.any()


def test_compress_tree_bit_equal_and_init():
    leaves = _leaves_np()
    jtree = {"a": {"w": jnp.asarray(leaves["w"])},
             "b": (jnp.asarray(leaves["big"]), jnp.asarray(leaves["zero"]))}
    ttree = {"a": {"w": torch.from_numpy(leaves["w"])},
             "b": (torch.from_numpy(leaves["big"]), torch.from_numpy(leaves["zero"]))}
    terr = gc.init_error_tree(ttree)
    assert all(e.dtype == torch.float32 and not e.any() for e in T.leaves(terr))
    jd, je = jgc.compress_tree(jtree, jgc.init_error_tree(jtree))
    td, te = gc.compress_tree(ttree, terr)
    for a, b in zip(T.leaves(td) + T.leaves(te), jax.tree.leaves(jd) + jax.tree.leaves(je)):
        assert np.array_equal(_bits(a), _bits(b))


# ---- the compression cases of tests/test_train_runtime.py


def test_compress_leaf_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(64).astype(np.float32))
    err = torch.zeros(64)
    total = torch.zeros(64)
    for _ in range(50):
        sent, err = gc.compress_leaf(g, err)
        total = total + sent
    # error feedback => the average transmitted gradient converges to g
    np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=1e-2)


def test_compress_tree_structure():
    params = {"a": {"w": torch.ones((4, 4))}, "b": (torch.ones((2,)),)}
    err = gc.init_error_tree(params)
    grads = T.map_tree(lambda p: p * 0.37, params)
    deq, new_err = gc.compress_tree(grads, err)
    assert [p for p, _ in T.flatten(deq)] == [p for p, _ in T.flatten(params)]
    assert isinstance(deq["b"], tuple) and isinstance(new_err["b"], tuple)
    for got, want in zip(T.leaves(T.map_tree(torch.add, deq, new_err)),
                         T.leaves(grads)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


CFG = reduced_config(get_config("qwen1.5-0.5b")).replace(n_layers=2)
QCFG = QuantConfig(w_bits=4, a_bits=4, mode="mdq")


def test_train_with_compression_converges():
    tcfg = TrainConfig(total_steps=60, warmup_steps=4, compress_grads=True,
                       adamw=AdamWConfig(lr_peak=5e-3))
    state = init_state(CFG, QCFG, tcfg, torch.Generator().manual_seed(0), "cpu")
    step = TT.make_train_step(CFG, QCFG, tcfg)
    dcfg = DataConfig(p_noise=0.05)
    losses = []
    for i in range(50):
        b = sample_batch(CFG, dcfg, i, 16, 16)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.75, losses[::7]
    assert any(e.abs().max() > 0 for e in T.leaves(state["err"]))


# ---- one step with compression against the reference's


def _jax_layout(tree, cfg) -> dict:
    return {T.path_str(p): np.asarray(v, np.float32)
            for p, v in T.flatten(bridge.tree_to_jax_layout(tree, cfg))}


def _jax_flat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
            np.asarray(v, np.float32) for p, v in flat}


def _scale(g: np.ndarray) -> np.float32:
    return np.maximum(np.float32(np.abs(g).max()) / np.float32(127.0),
                      np.float32(1e-12))


def test_train_step_with_compression_matches_jax():
    (jc, tc), (jq, tq), (jt, tt), jstate, tstate = train_states(
        "qwen1.5-0.5b", unrolled=True, kd="mckd", total_steps=10, warmup_steps=0,
        compress_grads=True)
    assert jc.n_groups == 0 and jc.n_tail == 2
    jstate["err"] = jgc.init_error_tree(jstate["params"])
    tstate["err"] = gc.init_error_tree(tstate["params"])
    b = train_batch(jc)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def j_loss_fn(params):  # as tests/test_torch_train_step.py: no remat
        logits, aux = JM.forward(params, jb, jc, jq, remat=False)
        return (j_kd.sparse_soft_ce(logits, jb["kd_idx"], jb["kd_p"])
                + jt.lb_coef * aux["lb_loss"])

    j_grads = jax.jit(jax.grad(j_loss_fn))(jstate["params"])
    j_deq, j_err = jgc.compress_tree(j_grads, jstate["err"])
    lr = j_schedule.warmup_cosine(jstate["step"], peak=jt.adamw.lr_peak,
                                  warmup_steps=jt.warmup_steps,
                                  total_steps=jt.total_steps)
    j_params, _, _ = jax.jit(j_adamw.update, static_argnums=5)(
        j_deq, j_adamw.AdamWState(jstate["mu"], jstate["nu"]),
        jstate["params"], jstate["step"], lr, jt.adamw)

    # compress_tree on the reference's own gradient tree: bit-equal
    jg_t = bridge.params_from_jax(jax.tree.map(np.asarray, j_grads), tc, "cpu")
    d_on_j, e_on_j = gc.compress_tree(jg_t, gc.init_error_tree(jg_t))
    for got, want in ((d_on_j, j_deq), (e_on_j, j_err)):
        g, w = _jax_layout(got, tc), _jax_flat(want)
        assert set(g) == set(w)
        for k in w:
            assert np.array_equal(_bits(g[k]), _bits(w[k])), k

    # the whole step: the port's own gradients, compressed in the step
    _, _, t_grads = TT.make_grad_fn(tc, tq, tt)(tstate["params"], tb, tstate["step"])
    t_deq, t_err = gc.compress_tree(t_grads, gc.init_error_tree(t_grads))
    t_new, t_m = TT.make_train_step(tc, tq, tt)(tstate, tb)
    for a, c in zip(T.leaves(t_new["err"]), T.leaves(t_err)):
        assert torch.equal(a, c)  # the step's error tree is compress_tree's
    tg, tdq, ter = (_jax_layout(t, tc) for t in (t_grads, t_deq, t_new["err"]))
    jg, jdq, jer = (_jax_flat(t) for t in (j_grads, j_deq, j_err))
    tp, jp = _jax_layout(t_new["params"], tc), _jax_flat(j_params)
    norms = _w_scale_norms(_jax_flat(jstate["params"]), jg, jq)
    flips = total = 0
    for k in jg:
        st, sj = _scale(tg[k]), _scale(jg[k])
        norm = max(sj, norms[k].max() / 127) if k in norms else sj
        assert abs(st - sj) <= 1e-4 * norm, (k, st, sj, norm)
        ct, cj = np.round(tdq[k] / st), np.round(jdq[k] / sj)
        assert np.array_equal(tdq[k], ct.astype(np.float32) * st)
        diff = ct != cj
        assert np.all(np.abs(ct - cj) <= 1), k
        # a code apart only where the two gradients straddle a boundary
        ut, uj = tg[k] / st, jg[k] / sj
        lo = np.minimum(ut, uj)[diff]
        hi = np.maximum(ut, uj)[diff]
        assert np.all(np.floor(lo + 0.5) != np.floor(hi + 0.5)), k
        flips += int(diff.sum())
        total += diff.size
        assert np.all(np.abs(ter[k] - jer[k]) <= 1.5 * max(st, sj)), k
        big = ~diff & (np.abs(jg[k]) > 1e-3 * np.abs(jg[k]).max())
        assert np.all(np.abs(tp[k] - jp[k])[big] <= 1e-6), (k, np.abs(tp[k] - jp[k])[big].max())
    print(f"codes one step apart: {flips} of {total}")
    assert flips <= 1e-3 * total
    assert np.isfinite(float(t_m["loss"]))


def test_fatal_step_keeps_the_error_tree_and_rollback_restores_it(tmp_path):
    """A fatal step (NaN gradients) leaves "err" as it was; a healthy one
    moves it. Then the reference's NaN-rollback scenario with compression
    on: the error tree rides through the checkpoints and the rollback, and
    the run ends as tests/test_sentinel_faults.py's does."""
    from repro_torch.launch.train import run_training
    from repro_torch.testing import faultinject as fi
    from repro_torch.train import sentinel as S
    from repro_torch.train.fault_tolerance import CheckpointManager
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, compress_grads=True,
                       sentinel=S.SentinelConfig())
    state = init_state(CFG, QCFG, tcfg, torch.Generator().manual_seed(0), "cpu")
    step = TT.make_train_step(CFG, QCFG, tcfg, extra_loss=fi.nan_grads_at([0]))
    b = {k: torch.from_numpy(v) for k, v in sample_batch(CFG, DataConfig(), 0, 4, 16).items()}
    state, m = step(state, b)
    assert int(m["health"]) & S.NONFINITE_GRAD
    assert not any(e.any() for e in T.leaves(state["err"]))
    state, m = step(state, b)
    assert int(m["health"]) == 0 and any(e.any() for e in T.leaves(state["err"]))

    d = str(tmp_path)
    scfg = S.SentinelConfig(k_consecutive=2, max_retries=2, lr_backoff=0.5)
    mgr = CheckpointManager(d, save_every=4, async_io=False)
    hooks = fi.chain(fi.OneShot(9, fi.poison_params_nan),
                     fi.OneShot(9, lambda st: (fi.corrupt_checkpoint(d, step=8, seed=11),
                                               None)[1]))
    report = run_training(CFG, QCFG, tcfg.replace(total_steps=14, sentinel=scfg),
                          DataConfig(), steps=14, batch_size=4, seq_len=16,
                          ckpt_dir=d, save_every=4, mgr=mgr, on_step=hooks,
                          log_every=0, device="cpu")
    assert (report.steps_run, report.final_step, report.rollback_to) == (20, 13, [4])
    assert np.isfinite(report.final_loss) and ckpt.verify(d, 12)
    keys = ckpt.read_manifest(d, 12)["keys"]
    assert sum(k.startswith("err/") for k in keys) == len(T.leaves(state["params"]))


def test_checkpoint_round_trip_with_err(tmp_path):
    tcfg = TrainConfig(compress_grads=True)
    state = init_state(CFG, QCFG, tcfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    state["err"] = T.map_tree(lambda e: torch.randn(e.shape, generator=gen),
                              state["err"])
    ckpt.save(str(tmp_path), state, 3)
    fresh = init_state(CFG, QCFG, tcfg, torch.Generator().manual_seed(2), "cpu")
    back = ckpt.restore(str(tmp_path), fresh)
    assert len(T.leaves(back["err"])) == len(T.leaves(state["params"]))
    for a, b in zip(T.leaves(back), T.leaves(state)):
        assert torch.equal(a, b)
    # a state without "err" does not restore into one that carries it
    plain = init_state(CFG, QCFG, TrainConfig(), torch.Generator().manual_seed(0), "cpu")
    ckpt.save(str(tmp_path / "plain"), plain, 1)
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path / "plain"), fresh)
