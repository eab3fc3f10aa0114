"""The nibble-packed serving embedding on the port (edge_bits <= 4): the
twin of tests/test_embed_pack.py.

convert_to_serving packs the embedding table two codes a byte ALONG
d_model (axis -1, unlike linears, which pack the contraction axis), so a
token gather fetches contiguous half-byte rows and embed_lookup
dequantizes only the gathered slice; the sharding rules split this table
by vocab over the model axis (a packed row stays whole on its rank).
Parity is exact against the unpacked int-code path and the QAT fake-quant
path; an odd d_model falls back to byte codes; quantized_weight unpacks
codes4 for the tied lm_head.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policy import QuantConfig, weight_spec  # noqa: E402
from repro_torch.core.quantizer import pack_int4, quantize_int, unpack_int4  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import common as C  # noqa: E402

VOCAB, D = 64, 32


def _qcfg(edge_bits):
    return QuantConfig(w_bits=4, a_bits=32, mode="mdq", edge_bits=edge_bits)


def _embed(qcfg, d=D, seed=0):
    return C.embed_init(torch.Generator().manual_seed(seed), qcfg, VOCAB, d, "cpu")


def _toks():
    return torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB, (2, 9)))


def test_serving_embed_packs_nibbles_at_edge4():
    qcfg = _qcfg(4)
    p = _embed(qcfg)
    sp = C.convert_to_serving({"embed": p}, qcfg)["embed"]
    assert set(sp) == {"codes4", "w_scale"}
    assert tuple(sp["codes4"].shape) == (VOCAB, D // 2)
    assert sp["codes4"].dtype == torch.int8
    spec = weight_spec(qcfg, "embed")
    codes = quantize_int(p["w"], p["w_scale"], spec)
    ref = C.embed_lookup({"codes": codes, "w_scale": p["w_scale"]}, _toks(), qcfg,
                         torch.float32)
    got = C.embed_lookup(sp, _toks(), qcfg, torch.float32)
    assert torch.equal(got, ref)
    qat = C.embed_lookup(p, _toks(), qcfg, torch.float32)
    assert torch.equal(got, qat)
    # the rules split the packed table by vocab over the model axis only
    assert sharding.param_pspecs({"embed": sp}, make_production_mesh())["embed"] == \
        {"codes4": ("model", None), "w_scale": ()}


def test_edge8_keeps_byte_codes():
    qcfg = _qcfg(8)
    sp = C.convert_to_serving({"embed": _embed(qcfg)}, qcfg)["embed"]
    assert "codes" in sp and "codes4" not in sp
    assert tuple(sp["codes"].shape) == (VOCAB, D)


def test_odd_d_model_falls_back_to_byte_codes():
    qcfg = _qcfg(4)
    sp = C.convert_to_serving({"embed": _embed(qcfg, d=33)}, qcfg)["embed"]
    assert "codes" in sp and "codes4" not in sp


def test_quantized_weight_unpacks_codes4():
    qcfg = _qcfg(4)
    p = _embed(qcfg)
    sp = C.convert_to_serving({"embed": p}, qcfg)["embed"]
    w4 = C.quantized_weight(sp, "embed", qcfg)
    codes = quantize_int(p["w"], p["w_scale"], weight_spec(qcfg, "embed"))
    want = codes.to(torch.float32) * p["w_scale"].to(torch.float32)
    assert torch.equal(w4, want)


def test_pack_unpack_roundtrip_covers_full_int4_range():
    codes = torch.from_numpy(np.random.default_rng(0).integers(-8, 8, (6, 10))
                             .astype(np.int8))
    for ax in (0, 1, -1):
        packed = pack_int4(codes, ax)
        assert packed.shape[ax % 2] == codes.shape[ax % 2] // 2
        assert torch.equal(unpack_int4(packed, ax), codes)
    with pytest.raises(ValueError, match="odd"):
        pack_int4(torch.zeros((3, 4), dtype=torch.int8), 0)
