"""Checkpointing: atomic, async-capable, CRC-verified.

PyTorch counterpart of `repro.train.checkpoint`, with the port's own
on-disk format (not read by the JAX package): one .npz per step, its
leaves keyed by the tree path ("params/layers/0/wq/w"), plus one JSON
manifest per step (``ckpt_XXXXXXXX.manifest.json``) carrying the step, the
keys, a CRC32 per leaf and an optional config fingerprint. bf16 tensors are
stored as f32 (exact) and cast back on restore.

Integrity contract, as in the JAX package:
  * writes go to a temp file, then `os.replace`; the manifest is written
    only after its .npz landed, so a manifest implies a complete payload;
  * `latest_step` skips a manifest whose payload is missing or unparseable;
  * `restore` checks every leaf's CRC32 and, without an explicit step, falls
    back to the newest checkpoint that verifies;
  * keep-last garbage collection removes payload and manifest together, and
    orphaned temp files;
  * `AsyncCheckpointer` saves on a worker thread with retries and surfaces a
    terminal failure at the next `raise_if_failed()`.
Restore places each tensor on the device and in the dtype of the
corresponding leaf of `like` (a tree of tensors, e.g. a freshly built state).

Elastic reshard, as in the JAX package: a checkpoint always holds full
arrays. `restore(..., shardings=layout)` (a `dist.sharding.Layout` of this
rank's mesh and the state's specs) keeps each rank's slice of every leaf;
`CheckpointManager(layout=...)` gathers a sharded state to full arrays,
which rank 0 alone writes. So a state saved by one process restores on a
mesh and the reverse.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


class CheckpointError(RuntimeError):
    """A checkpoint write failed (after async retries, if any)."""


class CheckpointCorrupt(CheckpointError):
    """A checkpoint payload failed parsing or CRC verification."""


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(leaf)


def to_arrays(state: Any) -> dict:
    """{path key: numpy array} for every leaf of a state tree (a dict that
    is already in this form is returned as is)."""
    if isinstance(state, dict) and all(isinstance(v, np.ndarray)
                                       for v in state.values()):
        return state
    return {T.path_str(p): _to_numpy(v) for p, v in T.flatten(state)}


def _crc(arr: np.ndarray) -> int:
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def fingerprint(*objs: Any) -> str:
    """Stable config fingerprint (dataclass reprs are deterministic)."""
    h = hashlib.sha256()
    for o in objs:
        h.update(repr(o).encode())
    return h.hexdigest()[:16]


def _ckpt_name(step: int) -> str:
    return f"ckpt_{step:08d}.npz"


def _manifest_name(step: int) -> str:
    return f"ckpt_{step:08d}.manifest.json"


def save(path_dir: str, state: Any, step: int, *, meta: Optional[dict] = None,
         keep_last: int = 3) -> str:
    os.makedirs(path_dir, exist_ok=True)
    arrays = to_arrays(state)
    fname = os.path.join(path_dir, _ckpt_name(step))
    fd, tmp = tempfile.mkstemp(dir=path_dir, suffix=".npz.tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, fname)
    manifest = {"step": step, "file": os.path.basename(fname),
                "keys": sorted(arrays), "crc32": {k: _crc(v) for k, v in arrays.items()},
                **(meta or {})}
    mtmp = fname + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, os.path.join(path_dir, _manifest_name(step)))
    _gc(path_dir, keep_last)
    return fname


def _gc(path_dir: str, keep_last: int) -> None:
    ckpts = sorted(f for f in os.listdir(path_dir)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    for f in ckpts[:-keep_last]:
        for victim in (f, f[:-len(".npz")] + ".manifest.json"):
            try:
                os.remove(os.path.join(path_dir, victim))
            except OSError:
                pass
    # orphaned temp files of a crashed writer (the single writer replaces
    # its own before calling _gc)
    for f in os.listdir(path_dir):
        if f.endswith(".npz.tmp") or f.endswith(".manifest.tmp"):
            try:
                os.remove(os.path.join(path_dir, f))
            except OSError:
                pass


def _manifest_steps(path_dir: str) -> list:
    """Steps with a manifest on disk, newest first."""
    steps = []
    for f in os.listdir(path_dir):
        if f.startswith("ckpt_") and f.endswith(".manifest.json"):
            try:
                steps.append(int(f[len("ckpt_"):len("ckpt_") + 8]))
            except ValueError:
                pass
    return sorted(steps, reverse=True)


def read_manifest(path_dir: str, step: int) -> Optional[dict]:
    try:
        with open(os.path.join(path_dir, _manifest_name(step))) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _payload_parses(path_dir: str, manifest: dict) -> bool:
    """Cheap structural check: .npz exists, is a valid zip, members match."""
    path = os.path.join(path_dir, manifest.get("file", ""))
    if not os.path.exists(path):
        return False
    try:
        with zipfile.ZipFile(path) as z:
            names = {n[:-4] for n in z.namelist() if n.endswith(".npy")}
    except (zipfile.BadZipFile, OSError):
        return False
    return names == set(manifest.get("keys", []))


def verify(path_dir: str, step: int) -> bool:
    """Deep check: the payload parses AND every leaf matches its CRC32."""
    manifest = read_manifest(path_dir, step)
    if manifest is None or not _payload_parses(path_dir, manifest):
        return False
    digests = manifest.get("crc32")
    if digests is None:
        return True
    try:
        with np.load(os.path.join(path_dir, manifest["file"])) as data:
            for key in manifest["keys"]:
                if _crc(data[key]) != digests.get(key):
                    return False
    except (OSError, ValueError, zipfile.BadZipFile, KeyError):
        return False
    return True


def latest_step(path_dir: str, *, verified: bool = False) -> Optional[int]:
    """Newest step whose checkpoint exists and parses (and, with
    ``verified=True``, passes every CRC32)."""
    if not os.path.isdir(path_dir):
        return None
    for step in _manifest_steps(path_dir):
        if verified:
            if verify(path_dir, step):
                return step
        else:
            manifest = read_manifest(path_dir, step)
            if manifest is not None and _payload_parses(path_dir, manifest):
                return step
    return None


def restore(path_dir: str, like: Any, *, step: Optional[int] = None,
            shardings: Any = None, verify_crc: bool = True,
            expect_fingerprint: Optional[str] = None) -> Any:
    """Load into the structure, devices and dtypes of `like`.

    shardings: a `dist.sharding.Layout` whose specs mirror `like`; each
    leaf is then this rank's slice of the stored full array (`like` holds
    slices). With ``step=None`` the newest checkpoint that verifies is used;
    an explicit ``step`` that fails verification raises CheckpointCorrupt.
    ``expect_fingerprint`` rejects checkpoints of another config."""
    if step is None:
        step = latest_step(path_dir, verified=verify_crc)
        if step is None:
            raise FileNotFoundError(f"no (valid) checkpoint in {path_dir}")
    elif verify_crc and not verify(path_dir, step):
        raise CheckpointCorrupt(f"checkpoint step {step} in {path_dir} "
                                f"failed CRC/structure verification")
    manifest = read_manifest(path_dir, step)
    if expect_fingerprint is not None and manifest is not None:
        got = manifest.get("config_fingerprint")
        if got is not None and got != expect_fingerprint:
            raise CheckpointError(
                f"config fingerprint mismatch at step {step}: checkpoint "
                f"{got} vs expected {expect_fingerprint}")
    if shardings is not None:
        from repro_torch.dist.sharding import local_shape, local_shard, with_specs
        mesh = shardings.mesh
        leaves = list(with_specs(like, shardings.specs))
    else:
        leaves = [(path, ref, ()) for path, ref in T.flatten(like)]
    out = []
    with np.load(os.path.join(path_dir, _ckpt_name(step))) as data:
        for path, ref, spec in leaves:
            key = T.path_str(path)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r} "
                               f"(config mismatch? step {step})")
            arr = data[key]
            full = torch.from_numpy(arr)
            if spec:
                if local_shape(arr.shape, spec, mesh) != tuple(ref.shape):
                    raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                                     f"split by {spec} vs model {tuple(ref.shape)}")
                full = local_shard(full, spec, mesh, mesh.coords)
            elif arr.shape != tuple(ref.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} "
                                 f"vs model {tuple(ref.shape)}")
            out.append(full.to(device=ref.device, dtype=ref.dtype))
    return T.unflatten(like, out)


class AsyncCheckpointer:
    """Saves on a worker thread, off the step's critical path.

    Failed saves are retried `retries` times with exponential backoff; a
    terminal failure lands in `.errors` and is raised by
    `raise_if_failed()` (called at every `CheckpointManager.maybe_save`).
    """

    def __init__(self, path_dir: str, keep_last: int = 3, *,
                 retries: int = 3, backoff: float = 0.05):
        self.path_dir = path_dir
        self.keep_last = keep_last
        self.retries = retries
        self.backoff = backoff
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._stopped = False
        self.errors: list = []

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            arrays, step, meta = item
            for attempt in range(self.retries + 1):
                try:
                    save(self.path_dir, arrays, step, meta=meta,
                         keep_last=self.keep_last)
                    break
                except Exception as e:  # the worker must survive to report
                    if attempt == self.retries:
                        self.errors.append(e)
                    else:
                        time.sleep(self.backoff * (2 ** attempt))
            self._q.task_done()

    def submit(self, state: Any, step: int, meta: Optional[dict] = None):
        if self._stopped:
            raise CheckpointError("AsyncCheckpointer already drained (wait() "
                                  "was called); create a new one")
        # the device-to-host copy happens here, on the caller's thread, so
        # later in-place updates of the state cannot reach the saved copy
        self._q.put((to_arrays(state), step, meta))

    def flush(self):
        """Block until every submitted save has landed (or failed)."""
        self._q.join()

    def raise_if_failed(self):
        if self.errors:
            err = self.errors[0]
            raise CheckpointError(
                f"async checkpoint save failed after {self.retries + 1} "
                f"attempts: {err!r}") from err

    def wait(self):
        """Drain pending saves and stop the worker. Idempotent."""
        if self._stopped:
            return
        self._stopped = True
        self._q.put(None)
        self._worker.join()
