"""The training path's smaller parts against the JAX package on the same
numpy inputs: full-sequence attention (global, sliding-window, GQA,
softcap), the KD losses, the latent param layout and its init statistics,
and the sentinel's tree select and the straggler watch (mirrors of
tests/test_sentinel.py and tests/test_checkpoint_ft.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs  # noqa: E402
from repro.core import kd as JK  # noqa: E402
from repro.core.policy import get_preset  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.core import kd as TK  # noqa: E402
from repro_torch.core.policy import get_preset as t_get_preset  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import sentinel as TS  # noqa: E402
from repro_torch.train.fault_tolerance import StragglerWatch  # noqa: E402


@pytest.mark.parametrize("kind", ["full", "window", "local_chunked"])
def test_attention_matches_jax(kind):
    """f32: only summation order differs (<= 1e-5); q_per_kv 2, softcap."""
    rng = np.random.default_rng(3)
    b, s, hkv, g, d = 2, 24, 2, 2, 16
    q = rng.standard_normal((b, s, hkv * g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    pos = np.arange(s)
    if kind == "local_chunked":
        kw = dict(window=5, softcap=30.0, chunk_q=8, q_per_kv=g)
        j = JA.attend_local_chunked(*map(jnp.asarray, (q, k, v)), **kw)
        t = TA.attend_local_chunked(*map(torch.from_numpy, (q, k, v)), **kw)
    else:
        kw = dict(causal=True, window=5 if kind == "window" else 0,
                  softcap=30.0, chunk_q=8, q_per_kv=g)
        j = JA.attend_full(*map(jnp.asarray, (q, k, v)), q_positions=jnp.asarray(pos),
                           k_positions=jnp.asarray(pos), **kw)
        t = TA.attend_full(*map(torch.from_numpy, (q, k, v)),
                           q_positions=torch.from_numpy(pos),
                           k_positions=torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-5)


def test_kd_losses_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32) * 3
    teacher = rng.standard_normal((2, 5, 40)).astype(np.float32) * 2
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)
    j_idx, j_p = JK.make_topk_labels(jnp.asarray(teacher), 6)
    t_idx, t_p = TK.make_topk_labels(torch.from_numpy(teacher), 6)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_p.numpy(), np.asarray(j_p), rtol=1e-6)
    tl, jl = torch.from_numpy(logits), jnp.asarray(logits)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(teacher), -1))
    pairs = [
        (TK.sparse_soft_ce(tl, t_idx, t_p, torch.from_numpy(mask)),
         JK.sparse_soft_ce(jl, j_idx, j_p, jnp.asarray(mask))),
        (TK.hard_ce(tl, torch.from_numpy(labels)), JK.hard_ce(jl, jnp.asarray(labels))),
        (TK.soft_ce(tl, torch.from_numpy(probs)), JK.soft_ce(jl, jnp.asarray(probs))),
        (TK.kd_from_teacher_logits(tl, torch.from_numpy(teacher), 2.0),
         JK.kd_from_teacher_logits(jl, jnp.asarray(teacher), 2.0)),
    ]
    for t, j in pairs:
        assert abs(float(t) - float(j)) <= 1e-6 * abs(float(j)), (float(t), float(j))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-8b"])
def test_init_params_layout_and_statistics_match_jax(arch):
    """Same tree, shapes and dtypes as the JAX package's init_params (in its
    groups/tail layout); the random values differ (torch's generator), so
    each weight's std and each LSQ scale init is held to 10% of JAX's."""
    jc, tc = configs(arch, "float32")
    jq, tq = get_preset("w4a4"), t_get_preset("w4a4")
    j = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jc, jq))
    t = bridge.tree_to_jax_layout(
        TM.init_params(tc, tq, torch.Generator().manual_seed(0), "cpu"), tc)
    jf = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): v
          for p, v in jax.tree_util.tree_flatten_with_path(j)[0]}
    tf = {T.path_str(p): v for p, v in T.flatten(t)}
    assert set(tf) == set(jf)
    for key, jv in jf.items():
        tv = tf[key]
        assert tv.shape == jv.shape and tv.dtype == jv.dtype, key
        if key.endswith("/w"):
            assert abs(tv.std() / jv.std() - 1) < 0.1, key
        elif key.endswith("w_scale"):
            np.testing.assert_allclose(tv, jv, rtol=0.1, err_msg=key)
        else:  # norms, biases, activation scales and offsets: constants
            np.testing.assert_array_equal(tv, jv, err_msg=key)


def test_select_update_passthrough():
    """Mirror of tests/test_sentinel.py::test_select_update_passthrough."""
    old = {"w": torch.zeros((2,)), "t": (torch.zeros(()),)}
    new = {"w": torch.ones((2,)), "t": (torch.ones(()),)}
    kept = TS.select_update(torch.tensor(True), old, new)
    assert float(kept["w"][0]) == 0.0 and float(kept["t"][0]) == 0.0
    taken = TS.select_update(torch.tensor(False), old, new)
    assert float(taken["w"][0]) == 1.0


def test_straggler_watch_injected_clock():
    """Mirror of tests/test_checkpoint_ft.py::test_straggler_watch_injected_clock."""
    times = iter([0.0, 1.0, 2.0, 3.0, 10.0, 10.5])
    sw = StragglerWatch(ratio=2.0, clock=lambda: next(times))
    assert [sw.tick() for _ in range(6)] == [False, False, False, False, True, False]
    assert sw.flags == 1 and sw.ema > 1.0
