"""The run sentinel's unit cases (tests/test_sentinel.py) on the port's
`repro_torch.train.sentinel`, each through both packages on the same
inputs where the reference has the function: the same health bits, the
same fatal verdict and the same new telemetry, bit for bit. The cases
mirrored elsewhere (non-finite loss, scale collapse / explode in
tests/test_torch_train_step.py, select_update in test_torch_train_parts.py,
the runner's streak and retries in test_torch_train_cli.py) are not
repeated.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.train import sentinel as JS  # noqa: E402
from repro_torch.train import sentinel as S  # noqa: E402

CFG = S.SentinelConfig()
J_CFG = JS.SentinelConfig()


def _warm(ema=1.0, var=0.01, obs=100, lr_scale=1.0, skipped=0):
    f = lambda v: torch.tensor(v, dtype=torch.float32)
    i = lambda v: torch.tensor(v, dtype=torch.int32)
    return S.SentinelState(loss_ema=f(ema), loss_sq=f(var + ema ** 2), obs=i(obs),
                           lr_scale=f(lr_scale), skipped=i(skipped))


def _j_warm(ema=1.0, var=0.01, obs=100, lr_scale=1.0, skipped=0):
    return JS.SentinelState(loss_ema=jnp.float32(ema),
                            loss_sq=jnp.float32(var + ema ** 2),
                            obs=jnp.int32(obs), lr_scale=jnp.float32(lr_scale),
                            skipped=jnp.int32(skipped))


def _both(loss, scale=0.1, osc=None, grads_bad=False, leaves=True, **warm):
    """health_check in both packages; returns (bits, fatal, state) of each."""
    g = np.ones((3,), np.float32)
    b = np.asarray([[1.0, np.inf], [0, 0]] if grads_bad else np.zeros((2, 2)),
                   np.float32)
    t_grads = {"a": torch.from_numpy(g), "b": (torch.from_numpy(b),)}
    j_grads = {"a": jnp.asarray(g), "b": (jnp.asarray(b),)}
    t_leaves = [(torch.ones((4, 4)), torch.tensor(scale, dtype=torch.float32),
                 None)] if leaves else []
    j_leaves = [(jnp.ones((4, 4)), jnp.full((), scale, jnp.float32), None)] \
        if leaves else []
    t = S.health_check(torch.tensor(loss, dtype=torch.float32), t_grads, t_leaves,
                       None if osc is None else torch.tensor(osc), _warm(**warm), CFG)
    j = JS.health_check(jnp.float32(loss), j_grads, j_leaves,
                        None if osc is None else jnp.float32(osc), _j_warm(**warm),
                        J_CFG)
    assert int(t[0]) == int(j[0]) and bool(t[1]) == bool(j[1])
    for a, c in zip(t[2], j[2]):
        assert np.array_equal(a.numpy(), np.asarray(c)), (a, c)
    return t


def test_healthy_step_updates_ema():
    bits, fatal, st = _both(1.05)
    assert int(bits) == S.OK and not bool(fatal)
    assert int(st.obs) == 101 and int(st.skipped) == 0
    assert abs(float(st.loss_ema) - 1.0) < 0.01  # the EMA drifted toward 1.05


def test_nonfinite_grad_detected():
    bits, fatal, _ = _both(1.0, grads_bad=True)
    assert int(bits) & S.NONFINITE_GRAD and bool(fatal)


def test_loss_spike_z_score():
    # ema 1, var 0.01 -> sigma 0.1; a loss of 10 is z = 90 >> z_max
    bits, fatal, st = _both(10.0)
    assert int(bits) & S.LOSS_SPIKE and bool(fatal)
    assert float(st.loss_ema) == 1.0  # the spike is not folded in


def test_spike_guard_unarmed_during_warmup():
    bits, fatal, _ = _both(10.0, obs=CFG.spike_warmup - 1)
    assert not (int(bits) & S.LOSS_SPIKE) and not bool(fatal)


def test_first_observation_bootstraps_ema():
    _, _, new = _both(7.5, leaves=False, ema=0.0, var=0.0, obs=0)
    assert float(new.loss_ema) == 7.5 and int(new.obs) == 1


def test_osc_spike_is_advisory_not_fatal():
    bits, fatal, _ = _both(1.0, osc=0.9)
    assert int(bits) & S.OSC_SPIKE
    assert not bool(fatal)  # the default fatal_bits leave OSC_SPIKE out


@pytest.mark.parametrize("bits", [0, S.NONFINITE_LOSS | S.LOSS_SPIKE,
                                  S.SCALE_COLLAPSE | S.OSC_SPIKE, 63])
def test_describe_bitmask(bits):
    assert S.describe(bits) == JS.describe(bits)
    assert S.describe(0) == "ok"
    if bits & S.NONFINITE_LOSS:
        assert "nonfinite_loss" in S.describe(bits) and "loss_spike" in S.describe(bits)


def test_apply_lr_backoff():
    state = {"sent": _warm(lr_scale=1.0), "params": {}}
    out = S.apply_lr_backoff(state, 0.5)
    assert float(out["sent"].lr_scale) == 0.5
    assert float(state["sent"].lr_scale) == 1.0  # the original is untouched


class _FakeMgr:
    def __init__(self, restored):
        self.restored = restored
        self.calls = 0

    def rollback(self, like):
        self.calls += 1
        return self.restored


def test_runner_keeps_current_backoff_across_rollbacks():
    scfg = S.SentinelConfig(k_consecutive=1, max_retries=5, lr_backoff=0.5)
    mgr = _FakeMgr(({"sent": _warm(lr_scale=1.0)}, 10))
    runner = S.SentinelRunner(scfg, mgr, like=None)
    state, resume = runner.rollback({"sent": _warm(lr_scale=0.5)})
    # the checkpoint's lr_scale (1.0) gives way to the live history (0.5) x 0.5
    assert float(state["sent"].lr_scale) == 0.25 and resume == 11


def test_runner_no_checkpoint_aborts():
    runner = S.SentinelRunner(S.SentinelConfig(), _FakeMgr(None), like=None)
    with pytest.raises(S.SentinelAbort):
        runner.rollback({"sent": _warm()})
