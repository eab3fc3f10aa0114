"""The port's sharding rules (`repro_torch.dist.sharding`) against the JAX
package's (`repro.dist.sharding`).

The eight cases of tests/test_sharding_rules.py are twinned with their
literal expected specs. Then, for every registered arch at full width and
five meshes, the port's spec trees are held entry by entry against the
reference's: train params, serving params (codes / codes4), the train
state (mu, nu, osc, err, sent), decode caches with and without the batch
sharded, and batches. Both sides are built from shapes only: the
reference's through `jax.eval_shape` on an `AbstractMesh`, the port's on
torch's meta device. The reference stacks the layers of a pattern position
under "groups" (a leading scan axis, never sharded) and unrolls a "tail";
the port's layer i maps to groups[i % period] without the leading entry,
or to tail[i - n_groups * period].
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs.registry import ARCH_IDS, get_config as j_get_config
from repro.core.policy import QuantConfig as JQuantConfig
from repro.dist import sharding as jshard
from repro.models import model as JM
from repro.models.common import convert_to_serving as j_convert
from repro.train.sentinel import SentinelConfig as JSentinelConfig
from repro.train.state import TrainConfig as JTrainConfig, init_state as j_init_state

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.dist import sharding as shard  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.model import jax_leaf_groups, quant_leaf_paths  # noqa: E402
from repro_torch.train.sentinel import SentinelConfig  # noqa: E402
from repro_torch.train.state import TrainConfig, init_state  # noqa: E402

MESH = make_production_mesh()
QCFG = QuantConfig(w_bits=4, a_bits=4, mode="mdq")

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
          ((8, 1), ("data", "model"))]
B, T = 32, 64  # decode cache batch and length


def meta(tree_fn):
    return tree_fn(torch.Generator(), "meta")


# ---------------------------------------------------------------------------
# the reference's eight cases, with their literal specs
# ---------------------------------------------------------------------------

def test_weight_rules_head_sharding():
    assert shard.weight_pspec("wq", (8192, 64, 128), MESH) == ("data", "model", None)
    # kv heads 8 don't divide 16 -> replicate the model axis, keep FSDP
    assert shard.weight_pspec("wk", (8192, 8, 128), MESH) == ("data", None, None)
    # stacked shapes keep a leading None, as the reference's
    assert shard.weight_pspec("wq", (80, 8192, 64, 128), MESH) == \
        (None, "data", "model", None)
    assert shard.weight_pspec("w_in", (8192, 49152), MESH) == ("data", "model")
    assert shard.weight_pspec("w_out", (49152, 8192), MESH) == ("model", "data")


def test_moe_expert_vs_tp():
    assert shard.weight_pspec("moe_in", (32, 1024, 512), MESH) == \
        ("model", "data", None)
    assert shard.weight_pspec("moe_in", (8, 4096, 14336), MESH) == \
        (None, "data", "model")


def test_small_head_fallback_replicates():
    assert shard.weight_pspec("wq", (2304, 8, 256), MESH) == ("data", None, None)


def test_embed_lm_head():
    assert shard.weight_pspec("embed", (152064, 8192), MESH, fsdp=False) == \
        ("model", None)
    assert shard.weight_pspec("lm_head", (8192, 152064), MESH) == ("data", "model")


def test_param_pspecs_tree():
    cfg = get_config("qwen1.5-0.5b").replace(n_layers=2)
    specs = shard.param_pspecs(meta(functools.partial(M.init_params, cfg, QCFG)), MESH)
    g = specs["layers"][0]
    assert g["wq"]["w"] == ("data", "model", None)
    assert g["wq"]["w_scale"] == (None, "model", None)  # per-head scale
    assert g["wq"]["a_scale"] == ()
    assert specs["embed"]["w"] == ("model", None)


def test_state_pspecs_mirror():
    from repro_torch import tree as T
    cfg = reduced_config(get_config("granite-8b")).replace(n_layers=2)
    qc = QCFG.replace(track_oscillation=True)
    state = meta(lambda g, d: init_state(cfg, qc, TrainConfig(), g, d))
    specs = shard.state_pspecs(state, MESH, qc)
    assert [p for p, _, _ in shard.with_specs(state["mu"], specs["mu"])] == \
        [p for p, _ in T.flatten(state["params"])]
    assert specs["step"] == ()
    assert len(specs["osc"]) == len(state["osc"]) > 0


def test_batch_pspecs_divisibility():
    batch = {"tokens": np.zeros((256, 128), np.int32),
             "one": np.zeros((1, 128), np.int32)}
    specs = shard.batch_pspecs(batch, MESH)
    assert specs["tokens"] == (("data",), None)
    assert specs["one"] == (None, None)


def test_cache_pspecs_seq_sharding():
    cfg = reduced_config(get_config("granite-8b"))
    cache = M.init_cache(cfg, QCFG, 32, 64, "meta")
    kv = shard.cache_pspecs(cache, MESH)["layers"][0]["kv"]
    # (B, T, Hkv, D): batch on data, the sequence on model
    assert kv.k == (("data",), "model", None, None)
    assert kv.pos == (("data",), "model")


# ---------------------------------------------------------------------------
# every arch x mesh x tree against the reference
# ---------------------------------------------------------------------------

def _ref_layer(tree, cfg, i: int):
    """Layer i's subtree of a reference tree with "groups" / "tail", and
    whether its leaves carry the stacked leading axis."""
    n_scan = cfg.n_groups * cfg.period
    if i < n_scan:
        return tree["groups"][i % cfg.period], True
    return tree["tail"][i - n_scan], False


def _norm(spec) -> tuple:
    """A spec with one-axis tuple entries as the bare axis name (JAX's
    PartitionSpec stores P(("data",)) as P("data"))."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _same(ref, port, stacked: bool, where: str):
    """Walk a reference spec tree beside the port's, spec by spec."""
    if isinstance(ref, P):
        want = _norm(ref)
        port = _norm(port)
        if stacked and want:
            assert want[0] is None, (where, want)
            want = want[1:]
        if where.endswith("/w_scale") and port == () and set(want) <= {None}:
            # a per-tensor serving scale: 0-d in the port, (1, 1) in the
            # reference's unstacked tree; both replicate
            want = ()
        assert port == want, (where, port, want)
    elif ref is None:
        assert port is None, where
    elif isinstance(ref, dict):
        assert set(ref) == set(port), (where, sorted(ref), sorted(port))
        for k in ref:
            _same(ref[k], port[k], stacked, f"{where}/{k}")
    elif isinstance(ref, (tuple, list)):
        assert len(ref) == len(port), (where, len(ref), len(port))
        for j, (a, b) in enumerate(zip(ref, port)):
            _same(a, b, stacked, f"{where}/{j}")
    else:
        raise AssertionError(f"{where}: unexpected {type(ref)}")


def _same_layered(ref, port, cfg, where: str, key: str = "layers"):
    """A params-like tree: the top-level leaves as they are, the layers by
    the groups / tail mapping."""
    assert set(ref) - {"groups", "tail"} == set(port) - {key}, where
    for k in port:
        if k != key:
            _same(ref[k], port[k], False, f"{where}/{k}")
    assert len(port[key]) == cfg.n_layers
    for i, lay in enumerate(port[key]):
        node, stacked = _ref_layer(ref, cfg, i)
        _same(node, lay, stacked, f"{where}/{key}/{i}")


@functools.lru_cache(maxsize=1)
def _trees(arch: str):
    """(reference shape trees, port meta trees) of `arch` at full width."""
    jcfg, cfg = j_get_config(arch), get_config(arch)
    jq = JQuantConfig(w_bits=4, a_bits=4, mode="mdq", track_oscillation=True)
    tq = QCFG.replace(track_oscillation=True)
    jt = JTrainConfig(compress_grads=True, sentinel=JSentinelConfig())
    tt = TrainConfig(compress_grads=True, sentinel=SentinelConfig())
    key = jax.random.PRNGKey(0)
    ref = {"params": jax.eval_shape(lambda k: JM.init_params(k, jcfg, jq), key),
           "state": jax.eval_shape(lambda k: j_init_state(k, jcfg, jq, jt), key),
           "cache": jax.eval_shape(lambda: JM.init_cache(jcfg, jq, B, T))}
    ref["serving"] = jax.eval_shape(lambda p: j_convert(p, jq), ref["params"])
    port = {"state": meta(lambda g, d: init_state(cfg, tq, tt, g, d)),
            "serving": meta(lambda g, d: M.init_serving_params(cfg, tq, g, d)),
            "cache": M.init_cache(cfg, tq, B, T, "meta")}
    port["params"] = port["state"]["params"]
    return cfg, (jq, tq), ref, port


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_match_reference(arch):
    cfg, (jq, tq), ref, port = _trees(arch)
    checked = 0
    for sizes, names in MESHES:
        jmesh = AbstractMesh(sizes, names)
        mesh = shard.AxisSizes(names, sizes)
        tag = f"{arch} {dict(zip(names, sizes))}"
        # train and serving params
        for kind in ("params", "serving"):
            _same_layered(jshard.param_pspecs(ref[kind], jmesh),
                          shard.param_pspecs(port[kind], mesh), cfg, f"{tag} {kind}")
            checked += 1
        # the train state
        js = jshard.state_pspecs(ref["state"], jmesh, jq)
        ts = shard.state_pspecs(port["state"], mesh, tq)
        for k in ("params", "mu", "nu", "err"):
            _same_layered(js[k], ts[k], cfg, f"{tag} state/{k}")
        _same(js["step"], ts["step"], False, f"{tag} step")
        _same(js["sent"], ts["sent"], False, f"{tag} sent")
        paths = [p for p, _, _, _ in quant_leaf_paths(port["state"]["params"], tq)]
        groups = jax_leaf_groups(paths, cfg)
        assert len(js["osc"]) == len(groups) and len(ts["osc"]) == len(paths)
        for j, (gkey, members) in enumerate(groups):
            for idx in members:
                _same(js["osc"][j], ts["osc"][idx], gkey[0] == "groups",
                      f"{tag} osc/{paths[idx]}")
        checked += 1
        # decode caches, the batch sharded or not
        for sb in (True, False):
            jc = jshard.cache_pspecs(ref["cache"], jmesh, shard_batch=sb)
            tc = shard.cache_pspecs(port["cache"], mesh, shard_batch=sb)
            for i, lay in enumerate(tc["layers"]):
                node, stacked = _ref_layer(jc, cfg, i)
                _same(node, lay, stacked, f"{tag} cache(shard_batch={sb})/{i}")
            checked += 1
        # batches
        batch = {"tokens": np.zeros((256, 128), np.int32),
                 "labels": np.zeros((B, 128), np.int32),
                 "one": np.zeros((1, 128), np.int32),
                 "odd": np.zeros((6, 7, 3), np.float32)}
        jbatch = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in batch.items()}
        for extra in (False, True):
            jb = jshard.batch_pspecs(jbatch, jmesh, extra_model_dp=extra)
            tb = shard.batch_pspecs(batch, mesh, extra_model_dp=extra)
            for k in batch:
                _same(jb[k], tb[k], False, f"{tag} batch/{k}")
        checked += 1
    assert checked == 6 * len(MESHES)
