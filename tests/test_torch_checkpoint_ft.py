"""The checkpoint cases of tests/test_checkpoint_ft.py that no other port
test mirrors, on `repro_torch.train.checkpoint` and `CheckpointManager`
with the reference's state (reduced 2-layer qwen1.5-0.5b, 4-bit MDQ):
keep-last garbage collection, the shape-mismatch refusal, orphaned
manifests (payload deleted) and orphaned temp files, and the manager's
restore-or-init and save cadence, restoring with explicit shardings, and
the elastic round trip between one process and a (2, 2) mesh of 4 gloo
ranks (tests/_torch_elastic_ranks.py). (The round trip, the manifest GC,
the fingerprint and CRC checks and the async writer are in
test_torch_train_cli.py.)
"""
import json
import os
import subprocess
import sys

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


def test_restore_with_shardings(tmp_path):
    """Elastic path: restore with explicit shardings of a world of one."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_host_mesh
    state = _state()
    ckpt.save(str(tmp_path), state, 1)
    mesh = make_host_mesh(1, "cpu")
    specs = sharding.state_pspecs(state, mesh, QCFG)
    like = _state(seed=1)
    restored = ckpt.restore(str(tmp_path), like, shardings=sharding.Layout(mesh, specs))
    for a, b in zip(T.leaves(state), T.leaves(restored)):
        assert torch.equal(a, b) and a.device == b.device


def test_elastic_round_trip_between_one_process_and_a_mesh(tmp_path):
    """A checkpoint saved by one process restores on a (2, 2) gloo mesh as
    each rank's slices bit for bit; slices saved on the mesh (gathered,
    rank 0 writing) restore in one process bit for bit."""
    sys.path.insert(0, os.path.dirname(__file__))
    import _torch_elastic_ranks as E
    full = E.full_state()
    ckpt.save(str(tmp_path / "single"), full, 1)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"))
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, E.__file__, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    assert all(r["restored_bit_equal"] for r in ranks), ranks
    assert all(r["split_leaves"] > 0 for r in ranks)
    assert ckpt.latest_step(str(tmp_path / "mesh"), verified=True) == 2
    back = ckpt.restore(str(tmp_path / "mesh"), E.full_state(), step=2)
    for (path, a), b in zip(T.flatten(full), T.leaves(back)):
        assert torch.equal(a, b) and a.dtype == b.dtype, path
