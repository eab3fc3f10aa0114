"""The training-runtime cases of tests/test_train_runtime.py (apart from
grad accumulation, mirrored in test_torch_train_step.py, and compression,
in test_torch_grad_compress.py) and tests/test_bf16_moments.py on the port:
the AdamW decay mask, the schedules (against the reference's values), the
loss going down over 50 QAT steps with oscillation tracked, the oracle CE
bound, data determinism, and bf16 Adam moments (reduced 2-layer
qwen1.5-0.5b, 4-bit MDQ, the reference's sizes and thresholds).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import schedule as j_schedule  # noqa: E402
from _torch_parity import one_torch_thread  # noqa: E402,F401 (autouse)
from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.data.synthetic import DataConfig, oracle_ce, sample_batch  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train.state import TrainConfig, init_state  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

CFG = reduced_config(get_config("qwen1.5-0.5b")).replace(n_layers=2)
QCFG = QuantConfig(w_bits=4, a_bits=4, mode="mdq", track_oscillation=True)
DCFG = DataConfig(p_noise=0.05)


def _train(tcfg, qcfg, steps):
    state = init_state(CFG, qcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    step = make_train_step(CFG, qcfg, tcfg)
    losses = []
    for i in range(steps):
        b = sample_batch(CFG, DCFG, i, 16, 16)
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    return state, m, losses


def test_adamw_decay_mask_excludes_scales():
    params = {"wq": {"w": torch.ones((4, 4)), "w_scale": torch.ones(())}}
    assert adamw._decay_mask(params) == [1.0, 0.0]  # w, then w_scale


@pytest.mark.parametrize("fn", ["warmup_cosine", "linear_warmup_decay"])
def test_schedules(fn):
    """The reference's three values, and the two packages within 1e-7 of the
    peak of each other over the whole schedule (f32 ops; the cosine of
    each library may differ in its last place)."""
    kw = dict(peak=1e-3, warmup_steps=10, total_steps=100)
    if fn == "warmup_cosine":
        assert float(schedule.warmup_cosine(0, **kw)) == 0.0
        np.testing.assert_allclose(float(schedule.warmup_cosine(10, **kw)), 1e-3,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            float(schedule.warmup_cosine(100, min_lr=1e-5, **kw)), 1e-5, rtol=1e-4)
    for s in range(0, 111, 7):
        got = float(getattr(schedule, fn)(torch.tensor(s, dtype=torch.int32), **kw))
        want = float(getattr(j_schedule, fn)(jnp.asarray(s, jnp.int32), **kw))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * kw["peak"])


def test_loss_decreases():
    tcfg = TrainConfig(total_steps=60, warmup_steps=4,
                       adamw=adamw.AdamWConfig(lr_peak=5e-3))
    _, m, losses = _train(tcfg, QCFG, 50)
    assert losses[-1] < losses[0] * 0.7, losses[::6]
    assert np.isfinite(losses).all()
    assert "osc_frac" in m


def test_oracle_ce_bound():
    assert 0 < oracle_ce(CFG, DCFG) < np.log(CFG.vocab_size)
    from repro.configs.registry import get_config as j_get_config
    from repro.configs.registry import reduced_config as j_reduced_config
    from repro.data.synthetic import DataConfig as JDataConfig
    from repro.data.synthetic import oracle_ce as j_oracle_ce
    jc = j_reduced_config(j_get_config("qwen1.5-0.5b")).replace(n_layers=2)
    assert oracle_ce(CFG, DCFG) == j_oracle_ce(jc, JDataConfig(p_noise=0.05))


def test_data_determinism():
    b1 = sample_batch(CFG, DCFG, 7, 4, 16, host_index=3)
    b2 = sample_batch(CFG, DCFG, 7, 4, 16, host_index=3)
    assert np.array_equal(b1["tokens"], b2["tokens"])
    b3 = sample_batch(CFG, DCFG, 8, 4, 16, host_index=3)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_bf16_moments_train():
    """tests/test_bf16_moments.py: moments stored in bf16 (the update math
    in f32) halve their memory and the loss still goes down."""
    tcfg = TrainConfig(total_steps=60, warmup_steps=4,
                       adamw=adamw.AdamWConfig(lr_peak=5e-3,
                                               moments_dtype="bfloat16"))
    qcfg = QCFG.replace(track_oscillation=False)
    fresh = init_state(CFG, qcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(t.dtype == torch.bfloat16 for t in T.leaves(fresh["mu"]) + T.leaves(fresh["nu"]))
    state, _, losses = _train(tcfg, qcfg, 40)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.75, losses[::5]
    assert all(t.dtype == torch.bfloat16 for t in T.leaves(state["mu"]))
