"""The training half of the fault contract on the port: every case of
tests/test_sentinel_faults.py against `repro_torch.testing.faultinject`,
with the reference's numbers (reduced 2-layer qwen1.5-0.5b, 4-bit MDQ).

Component cases run beside the reference where both packages can: the
checkpoint corrupter flips the same bytes as the reference's on a copy of
the same file, and the in-step injectors run on both packages' train
steps from one latent state (the port's bridged from the reference's),
with the same health bits step by step and the port's params bit-unchanged
on a fatal step. The three end-to-end scenarios run the port's
`run_training` on the CPU (a few seconds each: the reference marks its own
`slow` for its compile time only).
"""
import functools
import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as j_get_config  # noqa: E402
from repro.configs.registry import reduced_config as j_reduced_config  # noqa: E402
from repro.core.policy import QuantConfig as JQuantConfig  # noqa: E402
from repro.testing import faultinject as jfi  # noqa: E402
from repro.train import sentinel as JS  # noqa: E402
from repro.train.state import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.state import init_state as j_init_state  # noqa: E402
from repro.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.data.synthetic import DataConfig, sample_batch  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.testing import faultinject as fi  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import sentinel as S  # noqa: E402
from repro_torch.train.fault_tolerance import CheckpointManager  # noqa: E402
from repro_torch.train.state import TrainConfig, init_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

CFG = reduced_config(get_config("qwen1.5-0.5b")).replace(n_layers=2)
QCFG = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
DCFG = DataConfig()
J_CFG = j_reduced_config(j_get_config("qwen1.5-0.5b")).replace(n_layers=2)
J_QCFG = JQuantConfig(w_bits=4, a_bits=4, mode="mdq")


def _tiny_state(x=0.0):
    return {"params": {"w": np.full((8, 8), x, np.float32),
                       "w_scale": np.float32(0.1)},
            "step": np.int32(0)}


def _tiny_like():
    return {"params": {"w": torch.zeros((8, 8)), "w_scale": torch.zeros(())},
            "step": torch.zeros((), dtype=torch.int32)}


# ------------------------------------------------- checkpoint corruption


def test_corrupt_latest_falls_back_to_verified(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, _tiny_state(1.0), 4)
    ckpt.save(d, _tiny_state(2.0), 8)
    fi.corrupt_checkpoint(d, step=8, nbytes=64, seed=1)
    assert not ckpt.verify(d, 8)
    assert ckpt.verify(d, 4)
    assert ckpt.latest_step(d, verified=True) == 4
    restored = ckpt.restore(d, _tiny_like())  # falls back past the corruption
    assert float(restored["params"]["w"][0, 0]) == 1.0


def test_corrupt_explicit_step_raises(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, _tiny_state(), 3)
    fi.corrupt_checkpoint(d, step=3, seed=2)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(d, _tiny_like(), step=3)


def test_truncated_npz_skipped_even_unverified(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, _tiny_state(1.0), 2)
    ckpt.save(d, _tiny_state(2.0), 5)
    fi.truncate_checkpoint(d, step=5, keep_frac=0.3)
    # a truncated zip fails even the cheap structural parse
    assert ckpt.latest_step(d) == 2
    assert ckpt.latest_step(d, verified=True) == 2


def test_corruption_is_deterministic_and_the_references(tmp_path):
    """Two corruptions of the same file with the same seed flip the same
    bytes, and the reference's injector flips the same bytes as the port's
    on a copy of the file (its LCG over the same size and seed)."""
    a, b, c = (str(tmp_path / n) for n in "abc")
    for d in (a, b):
        ckpt.save(d, _tiny_state(1.0), 1)
    shutil.copytree(a, c)
    clean = open(os.path.join(a, "ckpt_00000001.npz"), "rb").read()
    for d in (a, b):
        fi.corrupt_checkpoint(d, step=1, nbytes=16, seed=7)
    jfi.corrupt_checkpoint(c, step=1, nbytes=16, seed=7)
    pa, pb, pc = (open(os.path.join(d, "ckpt_00000001.npz"), "rb").read()
                  for d in (a, b, c))
    assert pa == pb == pc != clean


def test_manager_rollback_skips_corrupt(tmp_path):
    d = str(tmp_path)
    mgr = CheckpointManager(d, save_every=1, async_io=False)
    assert mgr.rollback(_tiny_like()) is None  # nothing saved yet
    ckpt.save(d, _tiny_state(1.0), 1)
    ckpt.save(d, _tiny_state(2.0), 2)
    fi.corrupt_checkpoint(d, step=2, seed=3)
    state, step = mgr.rollback(_tiny_like())
    assert step == 1 and float(state["params"]["w"][0, 0]) == 1.0
    mgr.guard.restore_handlers()


def test_delete_payload_leaves_an_orphaned_manifest(tmp_path):
    """`delete_checkpoint_payload` (no case of the reference's suite uses
    it; tests/test_checkpoint_ft.py removes the file by hand): the
    manifest stays and `latest_step` skips it."""
    d = str(tmp_path)
    ckpt.save(d, _tiny_state(1.0), 2)
    ckpt.save(d, _tiny_state(2.0), 4)
    fi.delete_checkpoint_payload(d)
    assert os.path.exists(os.path.join(d, "ckpt_00000004.manifest.json"))
    assert ckpt.latest_step(d) == 2


# ------------------------------------------------- async writer crashes


def test_async_retry_recovers(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "save", fi.flaky(ckpt.save, fail_times=2))
    ac = ckpt.AsyncCheckpointer(str(tmp_path), retries=3, backoff=0.001)
    ac.submit(_tiny_state(), 7)
    ac.wait()
    assert not ac.errors
    ac.raise_if_failed()
    assert ckpt.latest_step(str(tmp_path)) == 7


def test_async_terminal_failure_surfaces_at_maybe_save(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "save", fi.flaky(ckpt.save, fail_times=99))
    ac = ckpt.AsyncCheckpointer(str(tmp_path), retries=1, backoff=0.001)
    ac.submit(_tiny_state(), 5)
    ac.wait()  # drain the worker so the terminal error lands
    assert ac.errors
    with pytest.raises(ckpt.CheckpointError):
        ac.raise_if_failed()


def test_manager_surfaces_async_error_on_next_maybe_save(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt, "save", fi.flaky(ckpt.save, fail_times=99))
    mgr = CheckpointManager(str(tmp_path), save_every=1)
    mgr.async_.retries, mgr.async_.backoff = 1, 0.001
    assert mgr.maybe_save(_tiny_state(), 1)
    mgr.async_.wait()  # let the failure land deterministically
    with pytest.raises(ckpt.CheckpointError):
        mgr.maybe_save(_tiny_state(), 2)
    mgr.guard.restore_handlers()


# ------------------------------------------------- detection in the step


KW = dict(total_steps=10, warmup_steps=2)
J_TCFG = JTrainConfig(sentinel=JS.SentinelConfig(), **KW)


@functools.lru_cache(maxsize=None)
def _j_step(extra_name=None, at=None):
    """The reference's jitted step (one compile for each injector)."""
    extra = getattr(jfi, extra_name)([at]) if extra_name else None
    return jax.jit(j_make_train_step(J_CFG, J_QCFG, J_TCFG, extra_loss=extra))


def _both(extra_name=None, at=None):
    """The reference's state and jitted step, and the port's state (bridged
    from it) and step, with the reference's TrainConfig and the injector
    `extra_name` (of both packages' faultinject) firing at step `at`."""
    jstate = j_init_state(jax.random.PRNGKey(0), J_CFG, J_QCFG, J_TCFG)
    tstate = bridge.state_from_jax(jax.tree.map(np.asarray, jstate), CFG, "cpu",
                                   qcfg=QCFG)
    extra = getattr(fi, extra_name)([at]) if extra_name else None
    t_step = make_train_step(CFG, QCFG, TrainConfig(sentinel=S.SentinelConfig(), **KW),
                             extra_loss=extra)
    return jstate, _j_step(extra_name, at), tstate, t_step


def _batch(i):
    b = sample_batch(CFG, DCFG, i, 4, 16)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _params_copy(state):
    return [p.clone() for p in T.leaves(state["params"])]


def test_nan_grads_detected_and_update_skipped():
    jstate, j_step, tstate, t_step = _both("nan_grads_at", 1)
    for i in range(3):
        jb, tb = _batch(i)
        before = _params_copy(tstate)
        jstate, jm = j_step(jstate, jb)
        tstate, tm = t_step(tstate, tb)
        h = int(tm["health"])
        assert h == int(jm["health"]), (i, h, int(jm["health"]))
        if i == 1:
            assert h & S.NONFINITE_GRAD and h & S.NONFINITE_LOSS
            for a, b in zip(before, T.leaves(tstate["params"])):
                assert torch.equal(a, b)  # update skipped, bit for bit
        else:
            assert h == S.OK
    assert int(tm["sentinel_skipped"]) == int(jm["sentinel_skipped"]) == 1
    assert np.isfinite(float(tm["loss"]))  # recovered after the poisoned step


def test_nan_loss_only_keeps_grads_finite():
    jstate, j_step, tstate, t_step = _both("nan_loss_at", 0)
    jb, tb = _batch(0)
    _, jm = j_step(jstate, jb)
    before = _params_copy(tstate)
    _, tm = t_step(tstate, tb)
    h = int(tm["health"])
    assert h == int(jm["health"])
    assert h & S.NONFINITE_LOSS and not (h & S.NONFINITE_GRAD)
    assert np.isfinite(float(tm["grad_norm"]))
    for a, b in zip(before, T.leaves(tstate["params"])):
        assert torch.equal(a, b)


def test_scale_collapse_persists_until_rollback():
    jstate, j_step, tstate, t_step = _both()
    assert fi._first_scale_path(tstate["params"]) == ("embed", "w_scale") \
        == jfi._first_scale_path(jstate["params"])
    jstate = jfi.collapse_scale(jstate, 0.0)
    old = tstate["params"]["embed"]["w_scale"]
    tstate = fi.collapse_scale(tstate, 0.0)
    assert float(old) != 0.0  # the poisoner left the old tensor alone
    for i in range(2):
        jb, tb = _batch(i)
        jstate, jm = j_step(jstate, jb)
        tstate, tm = t_step(tstate, tb)
        assert int(tm["health"]) == int(jm["health"])
        assert int(tm["health"]) & S.SCALE_COLLAPSE  # skip preserves poison
    assert int(tm["sentinel_skipped"]) == int(jm["sentinel_skipped"]) == 2


def test_sentinel_disabled_has_no_health_metric():
    tcfg = TrainConfig(total_steps=10, warmup_steps=2, sentinel=None)
    state = init_state(CFG, QCFG, tcfg, torch.Generator().manual_seed(0), "cpu")
    state, m = make_train_step(CFG, QCFG, tcfg)(state, _batch(0)[1])
    assert "health" not in m and state["sent"] == ()


def test_poison_params_nan_matches_the_reference_leaf():
    """poison_params_nan NaNs the `w` beside the first w_scale in both
    packages (the token embedding), leaves every other leaf as it was, and
    persists through a skipped step."""
    jstate, j_step, tstate, t_step = _both()
    jp = jfi.poison_params_nan(jstate)
    tp = fi.poison_params_nan(tstate)
    for st in (jp, tp):
        assert np.isnan(np.asarray(st["params"]["embed"]["w"])).all()
    assert not torch.isnan(tstate["params"]["embed"]["w"]).any()
    jb, tb = _batch(0)
    _, jm = j_step(jp, jb)
    tp2, tm = t_step(tp, tb)
    assert int(tm["health"]) == int(jm["health"])
    assert int(tm["health"]) & S.NONFINITE_LOSS
    assert torch.isnan(tp2["params"]["embed"]["w"]).all()


# ------------------------------------------------- end to end


def test_e2e_nan_rollback_recovery(tmp_path):
    """The acceptance scenario: NaN params injected at step 9 (a poison
    that persists), the newest checkpoint (step 8) byte-corrupted. The run
    skips the poisoned updates, rolls back to the newest CRC-verified
    checkpoint (step 4, NOT the corrupt step 8), applies the LR backoff and
    reaches the target step count with a finite loss."""
    d = str(tmp_path)
    scfg = S.SentinelConfig(k_consecutive=2, max_retries=2, lr_backoff=0.5)
    tcfg = TrainConfig(total_steps=14, warmup_steps=2, sentinel=scfg)
    mgr = CheckpointManager(d, save_every=4, async_io=False)
    hooks = fi.chain(
        fi.OneShot(9, fi.poison_params_nan),
        fi.OneShot(9, lambda state: (fi.corrupt_checkpoint(d, step=8,
                                                           seed=11), None)[1]))
    report = run_training(CFG, QCFG, tcfg, DCFG, steps=14, batch_size=4,
                          seq_len=16, ckpt_dir=d, save_every=4, mgr=mgr,
                          on_step=hooks, log_every=0, device="cpu")
    assert report.final_step == 13
    assert np.isfinite(report.final_loss)
    assert report.rollbacks == 1 and report.rollback_to == [4]
    assert report.lr_scale == 0.5
    # 9 clean steps (0-8) + 2 fatal (9, 10) + the replay from 5 after
    # falling back to the verified step-4 checkpoint (NOT corrupt 8) = 20
    assert report.steps_run == 20
    fatal = S.NONFINITE_LOSS | S.NONFINITE_GRAD
    assert report.healths == [0] * 9 + [fatal] * 2 + [0] * 9
    # recovery re-wrote the step 8 / 12 checkpoints; both verify now
    assert ckpt.verify(d, 12) and ckpt.verify(d, 8)


def test_e2e_retries_exhausted_aborts(tmp_path):
    """A fault that survives rollback (re-poisoned every visit) must end in
    SentinelAbort, not an infinite loop."""
    scfg = S.SentinelConfig(k_consecutive=1, max_retries=1)
    tcfg = TrainConfig(total_steps=12, warmup_steps=2, sentinel=scfg)
    mgr = CheckpointManager(str(tmp_path), save_every=2, async_io=False)
    hooks = fi.OneShot(5, fi.poison_params_nan, times=99)  # fires every visit
    with pytest.raises(S.SentinelAbort):
        run_training(CFG, QCFG, tcfg, DCFG, steps=12, batch_size=4,
                     seq_len=16, ckpt_dir=str(tmp_path), save_every=2,
                     mgr=mgr, on_step=hooks, log_every=0, device="cpu")
    mgr.guard.restore_handlers()


def test_e2e_sigterm_preemption_checkpoints_and_exits(tmp_path):
    """SIGTERM mid-run: the loop takes a final forced checkpoint and exits
    cleanly at the step boundary, and the signal handlers are restored."""
    d = str(tmp_path)
    handler = signal.getsignal(signal.SIGTERM)
    tcfg = TrainConfig(total_steps=10, warmup_steps=2,
                       sentinel=S.SentinelConfig())
    mgr = CheckpointManager(d, save_every=100, async_io=False)
    report = run_training(CFG, QCFG, tcfg, DCFG, steps=10, batch_size=4,
                          seq_len=16, ckpt_dir=d, save_every=100, mgr=mgr,
                          on_step=fi.sigterm_at(3), log_every=0, device="cpu")
    assert report.preempted
    assert report.final_step == 3
    assert ckpt.latest_step(d, verified=True) == 3  # forced final checkpoint
    assert np.isfinite(report.final_loss)
    assert signal.getsignal(signal.SIGTERM) == handler
