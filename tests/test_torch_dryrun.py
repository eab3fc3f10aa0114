"""The port's dry run (`repro_torch.launch.dryrun`) against the JAX package's.

* Memory. A rank's argument bytes are its slices of the train state and
  its batch rows: for every arch at full width, on both production meshes
  (16 x 16 and 2 x 16 x 16), they must equal the sum of the reference's
  local shard bytes, from `jax.eval_shape` and the reference's own rules.
* FLOPs. One train, one prefill and one decode cell of reduced
  qwen1.5-0.5b at SMOKE_SHAPES, one rank: the record's status is "ok" and
  its dot FLOPs are held against the reference's `hlo_cost.analyze` of the
  same program compiled on one CPU device. The tolerance is exact (both
  counts are integers); where the port runs other dots, the gap is pinned
  op by op:
  - train: `torch.utils.checkpoint` recomputes each block's whole forward
    in the backward, its output projection `w_out` too, whose output no
    gradient needs; JAX's partial evaluation of `jax.checkpoint` drops that
    one dot (the reference's HLO has 6 rematerialized linears a layer, the
    port 7). Gap: n_layers x 2 M d_ff d.
  - prefill: the port's serving prefill is `prefill_step` over the whole
    prompt into a fresh cache of seq_len rows; it equals the reference's
    `prefill_step` of the same inputs. (The reference's dry run traces
    `forward(collect_cache=True)` instead, whose attention differs.)
  - decode: the serving fallback (dequantize + einsum: K-side per-head
    `wo`, the tied head) runs in fixed 128-row blocks (`common._row_matmul`,
    so a row's bits do not depend on the batch): with `ROW_BLOCK` = 1 the
    rows are the reference's, and the padded count is 128 / B times that.
    And the chunk's own key (one key at decode) enters P.V as a broadcast
    multiply in `torch.einsum`, not a dot: n_layers x 2 B H D fewer.
"""
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import shapes as jshp
from repro.configs.registry import ARCH_IDS, get_config as j_get_config, \
    reduced_config as j_reduced
from repro.core.policy import get_preset as j_get_preset
from repro.dist import sharding as jshard
from repro.launch import hlo_cost
from repro.models import model as JM
from repro.models.common import convert_to_serving as j_convert
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.state import TrainConfig as JTrainConfig, init_state as j_init_state
from repro.train.train_step import make_train_step as j_make_train_step

torch = pytest.importorskip("torch")

from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import get_preset  # noqa: E402
from repro_torch.dist import spmd as S  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.models import common as C  # noqa: E402

from _torch_parity import one_torch_thread  # noqa: E402,F401 (autouse)

MESHES = {False: (("data", "model"), (16, 16)), True: (("pod", "data", "model"), (2, 16, 16))}
ARCH = "qwen1.5-0.5b"


def _ref_local_bytes(tree, specs, mesh_shape: dict) -> int:
    """Sum over the leaves of a reference shape tree of its local shard's
    bytes under `specs` (PartitionSpecs) on a mesh of `mesh_shape`."""
    total = 0
    for leaf, spec in zip(jax.tree.leaves(tree),
                          jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))):
        n = 1
        for i, dim in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            parts = 1
            for a in names:
                parts *= mesh_shape[a]
            assert dim % parts == 0, (leaf.shape, spec)
            n *= dim // parts
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_are_the_reference_shards(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shape = shp.get_shape("train_4k")
    jq = j_get_preset("w4a4")
    jt = JTrainConfig(total_steps=150_000, warmup_steps=750, grad_accum=8, kd="mckd",
                      kd_topk=16, adamw=JAdamWConfig())
    jstate = jax.eval_shape(lambda k: j_init_state(k, jcfg, jq, jt), jax.random.PRNGKey(0))
    jbatch = jshp.token_specs(jcfg, jshp.SHAPES["train_4k"], kd_topk=16)
    tcfg = D._train_cfg(cfg, shape, 8)
    for multi, (names, sizes) in MESHES.items():
        jmesh = AbstractMesh(sizes, names)
        mesh_shape = dict(zip(names, sizes))
        want_state = _ref_local_bytes(jstate, jshard.state_pspecs(jstate, jmesh, jq), mesh_shape)
        want_batch = _ref_local_bytes(jbatch, jshard.batch_pspecs(jbatch, jmesh), mesh_shape)
        with D.rank0_mesh(names, sizes, "meta") as mesh:
            state, batch, _ = D.train_inputs(cfg, shape, tcfg, get_preset("w4a4"), mesh, False,
                                             torch.Generator())
        assert S.tree_bytes(state) == want_state, (arch, multi)
        assert S.tree_bytes(batch) == want_batch, (arch, multi)


def _ref_flops(kind: str) -> float:
    """The reference's HLO dot FLOPs of the smoke cell, compiled on one CPU
    device (its train step as the reference's dry run builds it; prefill
    and decode through `prefill_step` / `decode_step` over int codes)."""
    jcfg = j_reduced(j_get_config(ARCH))
    key = jax.random.PRNGKey(0)
    q = j_get_preset("w4a4")
    if kind == "train":
        spec = jshp.get_shape("train_4k", smoke=True)
        t = JTrainConfig(total_steps=150_000, warmup_steps=750, grad_accum=1, kd="mckd",
                         kd_topk=16, adamw=JAdamWConfig())
        state = jax.eval_shape(lambda k: j_init_state(k, jcfg, q, t), key)
        lowered = jax.jit(j_make_train_step(jcfg, q, t)).lower(
            state, jshp.token_specs(jcfg, spec, kd_topk=16))
        return hlo_cost.analyze(lowered.compile().as_text())["flops"]
    qs = q.replace(kv_cache_bits=8)
    params = jax.eval_shape(lambda k: j_convert(JM.init_params(k, jcfg, qs), qs), key)
    if kind == "prefill":
        spec = jshp.get_shape("prefill_32k", smoke=True)
        batch = jshp.token_specs(jcfg, spec)
        batch.pop("labels")
        batch["pos"] = jax.ShapeDtypeStruct((spec.global_batch, spec.seq_len), jnp.int32)
        fn = lambda p, c, b: JM.prefill_step(p, c, b, jcfg, qs)[0][:, -1]  # noqa: E731
    else:
        spec = jshp.get_shape("decode_32k", smoke=True)
        batch = jshp.decode_token_specs(jcfg, spec)
        fn = lambda p, c, b: JM.decode_step(p, c, b, jcfg, qs)  # noqa: E731
    cache = jax.eval_shape(lambda: JM.init_cache(jcfg, qs, spec.global_batch, spec.seq_len))
    return hlo_cost.analyze(jax.jit(fn).lower(params, cache, batch).compile().as_text())["flops"]


def _port(kind: str, **kw) -> dict:
    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    rec = D.lower_cell(ARCH, name, multi_pod=False, preset="w4a4", grad_accum=8,
                       serve_kv_bits=8, mesh_sizes=(1, 1), cfg=reduced_config(get_config(ARCH)),
                       shape=shp.get_shape(name, smoke=True), **kw)
    assert rec["status"] == "ok"
    for key in ("per_device_bytes", "fits_80g", "collectives", "tokens_per_step", "trace_s"):
        assert key in rec
    for key in ("compute_s", "memory_s", "collective_s", "dominant", "useful_flops_ratio"):
        assert key in rec["roofline"]
    assert rec["chips"] == 1 and rec["collectives"]["total_count"] == 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    return rec


def test_train_cell_flops_against_the_reference():
    cfg = reduced_config(get_config(ARCH))
    rec = _port("train")
    spec = shp.get_shape("train_4k", smoke=True)
    m = spec.global_batch * spec.seq_len
    remat_w_out = cfg.n_layers * 2 * m * cfg.d_ff * cfg.d_model
    assert rec["cost"]["flops"] == _ref_flops("train") + remat_w_out
    assert rec["grad_accum"] == 1
    assert set(rec["cost"]["kernels"]) == {"quant_matmul", "quant_matmul_bwd"}


def test_prefill_cell_flops_against_the_reference():
    rec = _port("prefill")
    assert rec["cost"]["flops"] == _ref_flops("prefill")


def test_decode_cell_flops_against_the_reference(monkeypatch):
    cfg = reduced_config(get_config(ARCH))
    spec = shp.get_shape("decode_32k", smoke=True)
    padded, block = _port("decode"), C.ROW_BLOCK
    monkeypatch.setattr(C, "ROW_BLOCK", 1)
    rows = _port("decode")
    own_key_pv = cfg.n_layers * 2 * spec.global_batch * cfg.n_heads * cfg.head_dim_
    assert rows["cost"]["flops"] + own_key_pv == _ref_flops("decode")
    mm = lambda r: r["cost"]["by_op"]["aten::mm"]["flops"]  # noqa: E731
    assert mm(padded) == mm(rows) * block // spec.global_batch
    assert padded["cost"]["flops"] - mm(padded) == rows["cost"]["flops"] - mm(rows)


def test_sharded_cell_records_collectives():
    """A reduced cell on a (2, 2) mesh over a fake world of 4: rank 0's
    slices, its gathers and reductions recorded, the group torn down."""
    import torch.distributed as dist
    rec = D.lower_cell(ARCH, "train_4k", multi_pod=False, preset="w4a4", grad_accum=8,
                       serve_kv_bits=8, mesh_sizes=(2, 2), cfg=reduced_config(get_config(ARCH)),
                       shape=shp.get_shape("train_4k", smoke=True))
    assert rec["status"] == "ok" and rec["chips"] == 4
    by_op = rec["collectives"]["bytes_by_op"]
    assert by_op["all-gather"] > 0 and by_op["all-reduce"] > 0
    assert not dist.is_initialized()
    dec = D.lower_cell(ARCH, "decode_32k", multi_pod=False, preset="w4a4", grad_accum=8,
                       serve_kv_bits=8, mesh_sizes=(2, 2), cfg=reduced_config(get_config(ARCH)),
                       shape=shp.get_shape("decode_32k", smoke=True))
    assert dec["status"] == "ok" and dec["collectives"]["total_count"] > 0


def test_cli_records_and_resumes(tmp_path, capsys):
    out = tmp_path / "dr.jsonl"
    argv = ["--arch", ARCH, "--shape", "long_500k", "--mesh", "both", "--out", str(out)]
    D.main(argv)
    import json
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["multi_pod"], r["status"]) for r in recs] == [(False, "skipped"),
                                                             (True, "skipped")]
    assert all(r["arch"] == ARCH and r["preset"] == "w4a4" for r in recs)
    D.main(argv)  # resumes: both cells done
    assert len(out.read_text().splitlines()) == 2
    assert capsys.readouterr().out.count("[skip-done]") == 2
