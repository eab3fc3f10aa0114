"""The checkpoint cases of tests/test_checkpoint_ft.py that no other port
test mirrors, on `repro_torch.train.checkpoint` and `CheckpointManager`
with the reference's state (reduced 2-layer qwen1.5-0.5b, 4-bit MDQ):
keep-last garbage collection, the shape-mismatch refusal, orphaned
manifests (payload deleted) and orphaned temp files, and the manager's
restore-or-init and save cadence. (The round trip, the manifest GC, the
fingerprint and CRC checks and the async writer are in
test_torch_train_cli.py; restoring onto new shardings waits for the
port's sharding, ROADMAP.md Queue 1.)
"""
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree as T  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.fault_tolerance import CheckpointManager  # noqa: E402
from repro_torch.train.state import TrainConfig, init_state  # noqa: E402

CFG = reduced_config(get_config("qwen1.5-0.5b")).replace(n_layers=2)
QCFG = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
TCFG = TrainConfig(total_steps=10)


def _state(seed=0, cfg=CFG):
    return init_state(cfg, QCFG, TCFG, torch.Generator().manual_seed(seed), "cpu")


def test_keep_last_gc(tmp_path):
    state = _state()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), state, s, keep_last=2)
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert sorted(files) == ["ckpt_00000004.npz", "ckpt_00000005.npz"]


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), _state(), 1)
    bad = _state(cfg=CFG.replace(d_model=32))
    with pytest.raises((ValueError, KeyError)):
        ckpt.restore(str(tmp_path), bad)


def test_manager_restore_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_every=2, async_io=False)
    state, start = mgr.restore_or_init(lambda: _state(0))
    assert start == 0
    assert mgr.maybe_save(state, 2)
    assert not mgr.maybe_save(state, 3)
    state2, start2 = mgr.restore_or_init(lambda: _state(1))
    assert start2 == 2
    for a, b in zip(T.leaves(state2), T.leaves(state)):
        assert torch.equal(a, b)
    mgr.finalize()
    mgr.guard.restore_handlers()


def test_latest_step_ignores_orphaned_manifest(tmp_path):
    """A surviving manifest whose .npz was deleted is not trusted, and the
    manager starts from the checkpoint before it."""
    state = _state()
    ckpt.save(str(tmp_path), state, 2, keep_last=5)
    ckpt.save(str(tmp_path), state, 4, keep_last=5)
    os.remove(tmp_path / "ckpt_00000004.npz")
    assert ckpt.latest_step(str(tmp_path)) == 2
    mgr = CheckpointManager(str(tmp_path), async_io=False)
    _, start = mgr.restore_or_init(lambda: _state(1))
    assert start == 2  # fell back instead of crashing
    mgr.guard.restore_handlers()


def test_latest_step_none_when_all_orphaned(tmp_path):
    ckpt.save(str(tmp_path), _state(), 1)
    os.remove(tmp_path / "ckpt_00000001.npz")
    assert ckpt.latest_step(str(tmp_path)) is None


def test_gc_removes_orphaned_tmp_files(tmp_path):
    """Crashed writers leave *.npz.tmp / *.manifest.tmp behind; the next
    save's GC sweeps them."""
    (tmp_path / "tmpabc123.npz.tmp").write_bytes(b"partial write")
    (tmp_path / "ckpt_00000009.npz.manifest.tmp").write_text("{}")
    ckpt.save(str(tmp_path), _state(), 1)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    assert ckpt.latest_step(str(tmp_path)) == 1
