"""The paper's experiment harness in the port against the JAX package:
activation-scale calibration, the sensitivity configs, MCKD (Eq. 9: the
loss, top-K labels, the store, the crops), and the twins of the paper-table
drivers. Mirrors tests/test_kd_sdam.py and tests/test_system.py.

Bars: calibration within 1e-6 relative (a mean over 4,096 elements summed
in another order); the sensitivity configs equal field by field; mckd_loss
within 1e-5 relative of the reference and of the mean of its per-view
losses; top-K labels equal (ties broken toward the lower index, as
lax.top_k does); the store's read-back equal bit for bit; a crop equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import kd as j_kd  # noqa: E402
from repro.core.calibration import calibrate_act_scale as j_calibrate  # noqa: E402
from repro.core.policy import QuantConfig as JQC  # noqa: E402
from repro.core.quantizer import QuantSpec as JSpec  # noqa: E402
from repro.data import mckd_store as j_store  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core import kd as t_kd  # noqa: E402
from repro_torch.core import sensitivity as t_sens  # noqa: E402
from repro_torch.core.calibration import calibrate_act_scale  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.core.quantizer import QuantSpec  # noqa: E402
from repro_torch.data.mckd_store import MCKDStore, window_crop  # noqa: E402
from repro_torch.data.synthetic import DataConfig, sample_batch  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

# ---------------------------------------------------------------------------
# calibration and sensitivity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,signed,offset", [(4, False, True), (8, False, True),
                                                (4, True, False), (2, True, False)])
def test_calibrate_act_scale_matches_jax(bits, signed, offset):
    x = np.random.default_rng(bits).standard_normal((64, 64)).astype(np.float32)
    x[3, 5] = 7.5  # an outlier: min / max and mean|x| all see it
    j_s, j_b = j_calibrate(jnp.asarray(x), JSpec(bits=bits, signed=signed,
                                                 offset=offset))
    t_s, t_b = calibrate_act_scale(torch.from_numpy(x),
                                   QuantSpec(bits=bits, signed=signed,
                                             offset=offset))
    assert t_s.dtype == t_b.dtype == torch.float32 and t_s.dim() == 0
    np.testing.assert_allclose(float(t_s), float(j_s), rtol=1e-6)
    assert float(t_b) == float(j_b)
    if offset:
        assert float(t_b) == float(x.min())


def test_calibrate_act_scale_floors_at_eps():
    for offset in (False, True):
        s, _ = calibrate_act_scale(torch.zeros((8,)), QuantSpec(bits=4, offset=offset))
        assert float(s) == pytest.approx(1e-9)


@pytest.mark.parametrize("which", ["leave_one_out_configs",
                                   "quantize_one_only_configs"])
@pytest.mark.parametrize("base", [dict(w_bits=2, a_bits=2, mode="lsq"),
                                  dict(w_bits=4, a_bits=4, mode="mdq",
                                       obr_lambda=0.1)])
def test_sensitivity_configs_match_jax(which, base):
    """Row names, and every QuantConfig field, equal the reference's."""
    from repro.core import sensitivity as j_sens
    assert t_sens.GROUPS == j_sens.GROUPS
    j_rows = list(getattr(j_sens, which)(JQC(**base)))
    t_rows = list(getattr(t_sens, which)(QuantConfig(**base)))
    assert [n for n, _ in t_rows] == [n for n, _ in j_rows]
    for (_, jq), (_, tq) in zip(j_rows, t_rows):
        assert dataclasses.asdict(tq) == dataclasses.asdict(jq)


def test_sensitivity_configs_quantize_what_they_name():
    from repro_torch.core.policy import act_spec, weight_spec
    base = QuantConfig(w_bits=2, a_bits=2, mode="mdq")
    rows = dict(t_sens.leave_one_out_configs(base))
    assert weight_spec(rows["All, except value"], "attn_v") is None
    assert weight_spec(rows["All, except value"], "attn_q") is not None
    only = dict(t_sens.quantize_one_only_configs(base))
    assert act_spec(only["FFN only"], "ffn_in") is not None
    assert act_spec(only["FFN only"], "attn_o") is None


# ---------------------------------------------------------------------------
# MCKD: the loss, top-K labels
# ---------------------------------------------------------------------------

def test_mckd_averages_crops():
    """Mirror of tests/test_kd_sdam.py::test_mckd_averages_crops, and the
    reference's value on the same inputs."""
    rng = np.random.default_rng(0)
    m, v = 3, 12
    s = rng.standard_normal((m, 2, 4, v)).astype(np.float32)
    t = rng.standard_normal((m, 2, 4, v)).astype(np.float32)
    j_idx, j_p = jax.vmap(lambda tl: j_kd.make_topk_labels(tl, 4))(jnp.asarray(t))
    idx, p = t_kd.make_topk_labels(torch.from_numpy(t), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(p.numpy(), np.asarray(j_p), rtol=1e-6)
    got = float(t_kd.mckd_loss(torch.from_numpy(s), idx, p))
    per = [float(t_kd.sparse_soft_ce(torch.from_numpy(s[i]), idx[i], p[i]))
           for i in range(m)]
    np.testing.assert_allclose(got, np.mean(per), rtol=1e-5)
    want = float(j_kd.mckd_loss(jnp.asarray(s), j_idx, j_p))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_topk_labels_break_ties_as_lax_top_k():
    """Equal teacher probabilities keep the lower class index first, as
    lax.top_k does (torch.topk promises no order among ties)."""
    logits = np.zeros((3, 5, 40), np.float32)
    logits[..., 7] = logits[..., 21] = logits[..., 3] = 2.0   # a 3-way tie
    logits[0, :, 30] = logits[0, :, 11] = 1.0                 # tied below it
    logits[1] = np.random.default_rng(1).integers(0, 3, (5, 40))
    j_idx, j_p = j_kd.make_topk_labels(jnp.asarray(logits), 6)
    idx, p = t_kd.make_topk_labels(torch.from_numpy(logits), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(p.numpy(), np.asarray(j_p), rtol=1e-6)
    assert idx.dtype == torch.int32
    assert idx[2, 0, :3].tolist() == [3, 7, 21]


def test_topk_probs_renormalized():
    t = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 50))
                         .astype(np.float32))
    idx, p = t_kd.make_topk_labels(t, 5)
    assert idx.shape == (2, 3, 5)
    np.testing.assert_allclose(p.sum(-1).numpy(), np.ones((2, 3)), rtol=1e-5)


# ---------------------------------------------------------------------------
# MCKD: the store and the crops
# ---------------------------------------------------------------------------

CFG = reduced_config(get_config("granite-8b")).replace(n_layers=2)
DCFG = DataConfig(p_noise=0.05)


def _teacher():
    fp = QuantConfig(mode="off")
    params = TM.init_params(CFG, fp, torch.Generator().manual_seed(0), "cpu")

    @torch.no_grad()
    def teacher_apply(view):
        b = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in view.items()}
        return TM.forward(params, b, CFG, fp)[0]
    return teacher_apply


def test_mckd_store_roundtrip(tmp_path):
    """Mirror of tests/test_system.py::test_mckd_store_roundtrip (2 batches
    x 2 crops of 8, K 4), plus: each item read back bit for bit against the
    labels recomputed from its view, and the manifest."""
    import json
    store = MCKDStore(str(tmp_path), k=4, n_crops=2)
    teacher_apply = _teacher()
    batches = [sample_batch(CFG, DCFG, i, 2, 16) for i in range(2)]
    crop = lambda b, m: window_crop(b, m, 8)
    store.build_shard(0, teacher_apply, batches, crop)
    items = list(store.iter_shard(0))
    assert len(items) == 4  # 2 batches x 2 crops
    for n, it in enumerate(items):
        assert it["kd_idx"].shape == (2, 8, 4) and it["kd_idx"].dtype == np.int32
        assert np.all(np.isfinite(it["kd_p"]))
        assert abs(float(np.sum(it["kd_p"][0, 0])) - 1.0) < 1e-4
        view = crop(batches[n // 2], n % 2)
        idx, p = t_kd.make_topk_labels(teacher_apply(view), 4)
        np.testing.assert_array_equal(it["kd_idx"], idx.numpy())
        np.testing.assert_array_equal(it["kd_p"], p.numpy())
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(it[k], view[k])
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest == {"k": 4, "n_crops": 2, "shards": 1, "n": 4}
    # the reference's reader takes the port's shard as it is
    j_items = list(j_store.MCKDStore(str(tmp_path), k=4, n_crops=2).iter_shard(0))
    for a, b in zip(items, j_items):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_store_feeds_a_train_step(tmp_path):
    """An item of the store trains one MCKD step (Eq. 9: no teacher in the
    loop): finite loss, health 0."""
    from repro_torch.core.policy import get_preset
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig, init_state
    from repro_torch.train.train_step import make_train_step
    store = MCKDStore(str(tmp_path), k=4, n_crops=2)
    store.build_shard(0, _teacher(), [sample_batch(CFG, DCFG, 0, 2, 16)],
                      lambda b, m: window_crop(b, m, 8))
    item = next(store.iter_shard(0))
    qcfg = get_preset("w4a4")
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, kd="mckd", kd_topk=4,
                       sentinel=SentinelConfig())
    state = init_state(CFG, qcfg, tcfg, torch.Generator().manual_seed(1), "cpu")
    _, m = make_train_step(CFG, qcfg, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in item.items()})
    assert np.isfinite(float(m["loss"])) and int(m["health"]) == 0


@pytest.mark.parametrize("arch,m,crop_len", [
    ("granite-8b", 0, 8), ("granite-8b", 3, 8), ("musicgen-medium", 2, 5),
    ("paper-deit-t", 1, 4)])
def test_window_crop_matches_jax(arch, m, crop_len):
    """The same numpy batch cropped on both sides (audio frames run along
    the tokens and are cropped with them; vision patches are kept whole)."""
    from repro.configs.registry import get_config as j_get_config
    from repro.configs.registry import reduced_config as j_reduced
    from repro.data.synthetic import DataConfig as JD, sample_batch as j_sample
    b = sample_batch(reduced_config(get_config(arch)), DataConfig(), 2, 2, 16)
    jb = j_sample(j_reduced(j_get_config(arch)), JD(), 2, 2, 16)
    if "frontend_embeds" in b:  # the same values on both sides
        b["frontend_embeds"] = np.asarray(jb["frontend_embeds"], np.float32)
    got = window_crop(b, m, crop_len)
    want = j_store.window_crop({k: jnp.asarray(v) for k, v in b.items()}, m,
                               crop_len)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["tokens"].shape == (2, crop_len)


# ---------------------------------------------------------------------------
# the table twins
# ---------------------------------------------------------------------------

def _stub_train_eval(cfg, qcfg, tcfg, *, steps=60, seed=0, teacher_forward=None,
                     step_fn=None, dcfg=None):
    """A stand-in for the reference's train_eval that trains nothing: its
    output keys, and a state the table's own code can read."""
    from repro.models import model as JM
    out = {"final_loss": 0.0, "eval_ce": 0.0, "eval_acc": 0.0, "s_per_step": 0.0}
    if qcfg.track_oscillation:
        out["osc_pct"] = 0.0
    return out, {"params": JM.init_params(jax.random.PRNGKey(0), cfg, qcfg),
                 "osc": ()}


def _reference_rows(name, monkeypatch):
    """The reference table's rows with its training stubbed out: the keys
    and row names its run() returns."""
    import importlib
    mod = importlib.import_module(f"benchmarks.{name}")
    monkeypatch.setattr(mod, "train_eval", _stub_train_eval)
    return mod.run() if name == "table2_sdam" else mod.run(steps=2)


def _shape(rows):
    """Row names / keys with the values' kinds, values dropped."""
    if isinstance(rows, dict):
        return {k: _shape(v) if isinstance(v, dict) else "value"
                for k, v in rows.items()}
    return [tuple(v if isinstance(v, str) or (isinstance(v, int) and i == 1)
                  else "value" for i, v in enumerate(r)) for r in rows]


def _values(rows):
    if isinstance(rows, dict):
        return [x for v in rows.values()
                for x in (_values(v) if isinstance(v, dict) else [v])]
    return [v for r in rows for v in r if not isinstance(v, str)]


@pytest.mark.parametrize("name", ["table1_sensitivity", "table2_sdam",
                                  "table4_qat", "table5_kd",
                                  "table7_oscillation"])
def test_table_twin_rows_match_the_reference(name, monkeypatch):
    """Each twin's run() at 3 steps on the CPU returns the reference's row
    names and keys (in order), every value finite."""
    import importlib
    twin = importlib.import_module(f"repro_torch.tables.{name}")
    got = twin.run(steps=3, device="cpu")
    want = _reference_rows(name, monkeypatch)
    assert _shape(got) == _shape(want)
    assert all(np.isfinite(v) for v in _values(got))


def test_table_twin_cli_needs_cuda_unless_asked():
    from repro_torch.tables import table5_kd
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            table5_kd.main(["--steps", "3"])


@pytest.mark.slow
def test_sensitivity_harness_orders_modules():
    """Mirror of tests/test_system.py::test_sensitivity_harness_orders_modules:
    leave-one-out losses are finite and distinct across module groups."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import TrainConfig, init_state
    from repro_torch.train.train_step import make_train_step
    base = QuantConfig(w_bits=2, a_bits=2, mode="mdq")
    tcfg = TrainConfig(total_steps=12, warmup_steps=2,
                       adamw=AdamWConfig(lr_peak=3e-3))
    finals = {}
    for name, qcfg in t_sens.leave_one_out_configs(base):
        state = init_state(CFG, qcfg, tcfg, torch.Generator().manual_seed(0), "cpu")
        step = make_train_step(CFG, qcfg, tcfg)
        for i in range(12):
            b = {k: torch.from_numpy(v)
                 for k, v in sample_batch(CFG, DCFG, i, 8, 16).items()}
            state, m = step(state, b)
        finals[name] = float(m["loss"])
    assert all(np.isfinite(v) for v in finals.values())
    assert len(set(round(v, 4) for v in finals.values())) > 1
