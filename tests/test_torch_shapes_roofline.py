"""The port's assigned shapes (`repro_torch.configs.shapes`) and roofline
(`repro_torch.launch.roofline`) against the JAX package's.

The tables, the applicability rule and the input specs' shapes and dtypes
must equal the reference's for every arch; `model_flops_per_step` must give
the reference's numbers exactly. The roofline's constants are the H100's
(not the reference's TPU figures), so its terms are checked against their
definitions.
"""
import jax
import pytest

from repro.configs import shapes as jshp
from repro.configs.registry import ARCH_IDS, get_config as j_get_config
from repro.launch import roofline as jrl

torch = pytest.importorskip("torch")

from repro_torch.configs import shapes as shp  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

_JDT = {"int32": torch.int32, "float32": torch.float32, "bfloat16": torch.bfloat16}


def test_shape_tables_equal_the_reference():
    for table, jtable in ((shp.SHAPES, jshp.SHAPES),
                          (shp.SMOKE_SHAPES, jshp.SMOKE_SHAPES)):
        assert list(table) == list(jtable)
        for name, spec in table.items():
            j = jtable[name]
            assert (spec.name, spec.seq_len, spec.global_batch, spec.kind) == \
                (j.name, j.seq_len, j.global_batch, j.kind)
    for smoke in (False, True):
        got, want = shp.get_shape("decode_32k", smoke), jshp.get_shape("decode_32k", smoke)
        assert (got.seq_len, got.global_batch) == (want.seq_len, want.global_batch)
    with pytest.raises(KeyError):
        shp.get_shape("nope")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicability_and_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for smoke in (False, True):
        for name in shp.SHAPES:
            spec, jspec = shp.get_shape(name, smoke), jshp.get_shape(name, smoke)
            assert shp.shape_applicable(cfg, spec) == jshp.shape_applicable(jcfg, jspec)
            for kd in (0, 16):
                got = shp.token_specs(cfg, spec, kd_topk=kd)
                want = jshp.token_specs(jcfg, jspec, kd_topk=kd)
                assert list(got) == list(want)
                for k, t in got.items():
                    assert t.device.type == "meta"
                    assert tuple(t.shape) == want[k].shape, (k, t.shape)
                    assert t.dtype == _JDT[str(want[k].dtype)], (k, t.dtype)
            got = shp.decode_token_specs(cfg, spec)
            want = jshp.decode_token_specs(jcfg, jspec)
            assert list(got) == list(want)
            for k, t in got.items():
                assert tuple(t.shape) == want[k].shape
                assert t.dtype == _JDT[str(want[k].dtype)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    for spec in shp.SHAPES.values():
        for train in (True, False):
            tokens = spec.global_batch * (spec.seq_len if spec.kind != "decode" else 1)
            assert rl.model_flops_per_step(cfg, tokens, train=train) == \
                jrl.model_flops_per_step(jcfg, tokens, train=train)


def test_roofline_terms_use_the_h100_data_sheet():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 50e9)
    r = rl.roofline(2 * 989e12, 3.35e12, 25e9, chips=4, model_flops=989e12)
    assert r["compute_s"] == 2.0 and r["memory_s"] == 1.0 and r["collective_s"] == 0.5
    assert r["dominant"] == "compute_s"
    assert r["useful_flops_ratio"] == 989e12 / (2 * 989e12 * 4)
    assert r["roofline_fraction"] == pytest.approx((989e12 / (4 * 989e12)) / 2.0)
    # the reference's keys, so its report tooling reads either record
    j = jrl.roofline(1.0, 1.0, 1.0, chips=4, model_flops=1.0)
    assert set(r) == set(j)
    hc = {"flops": 1e12, "bytes": 3.35e9, "collective_bytes": 0.0}
    assert rl.roofline_from_cost(hc, chips=1) == rl.roofline(1e12, 3.35e9, 0.0, chips=1)


def test_reference_shapes_need_no_device():
    # the reference's specs are ShapeDtypeStructs; the port's are meta
    # tensors: neither allocates
    spec = shp.get_shape("train_4k")
    batch = shp.token_specs(get_config("qwen1.5-0.5b"), spec, kd_topk=16)
    assert sum(t.numel() for t in batch.values()) > 10 ** 7
    assert all(t.is_meta for t in batch.values())
    assert isinstance(jshp.token_specs(j_get_config("qwen1.5-0.5b"), jshp.SHAPES["train_4k"])
                      ["tokens"], jax.ShapeDtypeStruct)
