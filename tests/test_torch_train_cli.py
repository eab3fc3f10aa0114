"""The port's training CLI and its fault tolerance on the CPU: a smoke run
ends with a finite loss, CUDA is the default and its absence raises,
--compress-grads trains, a second run on the same checkpoint directory
resumes from the saved step, and a corrupted newest checkpoint falls back
to the previous one (mirrors of tests/test_checkpoint_ft.py); reduced granite-moe trains under w3a3,
and its oscillation state rides through a checkpoint."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import get_preset  # noqa: E402
from repro_torch.launch import train as L  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault_tolerance import CheckpointManager  # noqa: E402
from repro_torch.train.state import TrainConfig, init_state  # noqa: E402

SMOKE = ["--arch", "qwen1.5-0.5b", "--smoke", "--quant", "w4a4", "--batch", "2",
         "--seq", "8", "--device", "cpu"]


def _state(seed=0):
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    return init_state(cfg, get_preset("w4a4"), TrainConfig(),
                      torch.Generator().manual_seed(seed), "cpu")


def _flip_a_byte(path):
    data = bytearray(path.read_bytes())
    data[len(data) // 2] ^= 0xFF
    path.write_bytes(bytes(data))


def test_smoke_run_ends_with_finite_loss(tmp_path):
    rep = L.main(SMOKE + ["--steps", "2", "--ckpt", str(tmp_path)])
    assert rep.steps_run == 2 and rep.final_step == 1
    assert np.isfinite(rep.final_loss) and all(np.isfinite(rep.losses))
    assert rep.healths == [0, 0] and rep.skipped == 0


def test_cuda_is_the_default_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    argv = [a for a in SMOKE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.main(argv + ["--steps", "1", "--ckpt", str(tmp_path)])


def test_compress_grads_flag_trains(tmp_path):
    """--compress-grads: int8 gradients with error feedback through the
    CLI; finite losses, no health bit."""
    rep = L.main(SMOKE + ["--steps", "2", "--compress-grads", "--ckpt", str(tmp_path)])
    assert rep.steps_run == 2 and all(np.isfinite(rep.losses))
    assert rep.healths == [0, 0]


def test_second_run_resumes_from_the_saved_step(tmp_path):
    args = SMOKE + ["--ckpt", str(tmp_path), "--save-every", "2"]
    first = L.main(args + ["--steps", "3"])
    assert first.final_step == 2
    assert ckpt.latest_step(str(tmp_path), verified=True) == 2
    second = L.main(args + ["--steps", "4"])
    assert second.start_step == 3 and second.steps_run == 1
    assert second.final_step == 3 and np.isfinite(second.final_loss)


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    """Mirror of tests/test_checkpoint_ft.py::test_crc_verification_roundtrip
    and the manager's fallback: the newest checkpoint fails its CRC, the
    manager restores the previous one."""
    a, b = _state(0), _state(1)
    ckpt.save(str(tmp_path), a, 1)
    ckpt.save(str(tmp_path), b, 2)
    assert ckpt.verify(str(tmp_path), 2)
    _flip_a_byte(tmp_path / "ckpt_00000002.npz")
    assert not ckpt.verify(str(tmp_path), 2)
    assert ckpt.latest_step(str(tmp_path), verified=True) == 1
    mgr = CheckpointManager(str(tmp_path), async_io=False)
    state, step = mgr.restore_or_init(lambda: _state(2))
    mgr.guard.restore_handlers()
    assert step == 1
    for x, y in zip(T.leaves(state), T.leaves(a)):
        assert torch.equal(x, y)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.restore(str(tmp_path), a, step=2)


def test_roundtrip_gc_and_fingerprint(tmp_path):
    """Mirror of test_roundtrip, test_gc_removes_manifest_with_payload and
    test_config_fingerprint_mismatch_rejected."""
    state = _state(0)
    state["params"]["final_norm"]["g"] = state["params"]["final_norm"]["g"].to(
        torch.bfloat16)  # bf16 leaves round-trip through f32 storage
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), state, s, keep_last=2,
                  meta={"config_fingerprint": "abc"})
    files = sorted(os.listdir(tmp_path))
    assert "ckpt_00000001.npz" not in files
    assert "ckpt_00000001.manifest.json" not in files
    restored = ckpt.restore(str(tmp_path), state, expect_fingerprint="abc")
    for x, y in zip(T.leaves(restored), T.leaves(state)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(str(tmp_path), state, expect_fingerprint="deadbeef")


def test_async_checkpointer_lands_and_drains(tmp_path):
    """Mirror of tests/test_checkpoint_ft.py::test_async_wait_idempotent."""
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.submit(_state(0), 1)
    ac.wait()
    ac.wait()
    assert ckpt.latest_step(str(tmp_path), verified=True) == 1
    with pytest.raises(ckpt.CheckpointError):
        ac.submit(_state(0), 2)


def test_compression_obr_and_oscillation_states():
    """Gradient compression builds an "err" tree of f32 zeros shaped like
    the params (and no tree without it); OBR (w2a2's lambda) and
    oscillation tracking build a state, the latter with one oscillation
    state per quantized weight."""
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    gen = torch.Generator().manual_seed(0)
    st = init_state(cfg, get_preset("w4a4"), TrainConfig(compress_grads=True),
                    gen, "cpu")
    assert [p for p, _ in T.flatten(st["err"])] == [p for p, _ in T.flatten(st["params"])]
    for e, p in zip(T.leaves(st["err"]), T.leaves(st["params"])):
        assert e.dtype == torch.float32 and e.shape == p.shape and not e.any()
    assert init_state(cfg, get_preset("w4a4"), TrainConfig(), gen, "cpu")["err"] == ()
    assert init_state(cfg, get_preset("w2a2"), TrainConfig(), gen, "cpu")["osc"] == ()
    qcfg = get_preset("w4a4").replace(track_oscillation=True)
    st = init_state(cfg, qcfg, TrainConfig(), gen, "cpu")
    from repro_torch.models.model import quant_leaves
    leaves = quant_leaves(st["params"], qcfg)
    assert len(st["osc"]) == len(leaves) > 0
    for o, (w, _, _) in zip(st["osc"], leaves):
        assert o.prev_int.shape == w.shape and o.prev_int.dtype == torch.int8
        assert o.prev_dir.dtype == torch.int8 and o.freq.dtype == torch.float32


MOE_SMOKE = ["--arch", "granite-moe-1b-a400m", "--smoke", "--quant", "w3a3",
             "--batch", "2", "--seq", "8", "--device", "cpu"]


def test_moe_w3a3_smoke_run(tmp_path):
    """The CLI QAT-trains reduced granite-moe under w3a3 (OBR on) for two
    steps: finite losses, no health bit."""
    rep = L.main(MOE_SMOKE + ["--steps", "2", "--ckpt", str(tmp_path)])
    assert rep.steps_run == 2 and rep.healths == [0, 0]
    assert all(np.isfinite(rep.losses))


def test_moe_oscillation_state_round_trips(tmp_path):
    """run_training with track_oscillation (no CLI flag, as in the
    reference) saves at step 1 and a second call resumes from it; the
    checkpoint holds the oscillation state (int8 codes and directions, f32
    EMA) and restores it bit for bit."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.train.sentinel import SentinelConfig
    cfg = reduced_config(get_config("granite-moe-1b-a400m"))
    qcfg = get_preset("w3a3").replace(track_oscillation=True)
    tcfg = TrainConfig(total_steps=4, warmup_steps=1, kd="mckd",
                       sentinel=SentinelConfig())
    kw = dict(batch_size=2, seq_len=8, ckpt_dir=str(tmp_path), save_every=1,
              seed=0, device="cpu")
    first = L.run_training(cfg, qcfg, tcfg, DataConfig(), steps=2, **kw)
    assert first.healths == [0, 0]
    like = init_state(cfg, qcfg, tcfg, torch.Generator().manual_seed(1), "cpu")
    saved = ckpt.restore(str(tmp_path), like)
    assert len(saved["osc"]) == len(like["osc"]) > 0
    arrays = ckpt.to_arrays(saved)
    assert arrays["osc/0/prev_int"].dtype == np.int8
    assert arrays["osc/0/freq"].dtype == np.float32
    assert any(int((o.prev_dir != 0).sum()) for o in saved["osc"])  # codes moved
    second = L.run_training(cfg, qcfg, tcfg, DataConfig(), steps=3, **kw)
    assert second.start_step == 2 and second.steps_run == 1
    assert np.isfinite(second.final_loss)


class _FakeMgr:
    def __init__(self, restored):
        self.restored = restored
        self.calls = 0

    def rollback(self, like):
        self.calls += 1
        return self.restored


def _sent(lr_scale=1.0):
    from repro_torch.train.sentinel import init_sentinel_state
    return init_sentinel_state()._replace(lr_scale=torch.tensor(lr_scale))


def test_sentinel_runner_streak_rollback_and_abort():
    """Mirror of tests/test_sentinel.py::test_runner_streak_and_rollback and
    ::test_runner_retries_exhausted."""
    from repro_torch.train import sentinel as S
    scfg = S.SentinelConfig(k_consecutive=3, max_retries=1, lr_backoff=0.5)
    mgr = _FakeMgr(({"sent": _sent(1.0)}, 40))
    runner = S.SentinelRunner(scfg, mgr, like=None)
    assert not runner.observe(S.NONFINITE_LOSS)
    assert not runner.observe(S.NONFINITE_LOSS)
    assert not runner.observe(0)          # a healthy step resets the streak
    assert not runner.observe(S.NONFINITE_LOSS)
    assert not runner.observe(S.NONFINITE_LOSS)
    assert runner.observe(S.NONFINITE_LOSS)
    state, resume = runner.rollback({"sent": _sent(1.0)})
    assert resume == 41 and mgr.calls == 1
    assert float(state["sent"].lr_scale) == 0.5
    assert runner.rollbacks == 1 and runner.fatal_streak == 0
    with pytest.raises(S.SentinelAbort):
        runner.rollback(state)
    with pytest.raises(S.SentinelAbort):
        S.SentinelRunner(scfg, _FakeMgr(None), like=None).rollback(state)
