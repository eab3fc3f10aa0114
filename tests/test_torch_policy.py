"""Module-dependent policy of the port (`repro_torch.core.policy`,
`repro_torch.core.sensitivity`): twin of tests/test_policy.py, case for
case — granularity per kind, edge pins, sensitivity overrides."""
import pytest

pytest.importorskip("torch")

from repro_torch.core.policy import (ALL_KINDS, QuantConfig, act_spec,  # noqa: E402
                                     get_preset, kv_cache_spec, weight_spec)
from repro_torch.core.sensitivity import (leave_one_out_configs,  # noqa: E402
                                          quantize_one_only_configs)


def test_mdq_attention_per_head():
    cfg = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    for kind in ("attn_q", "attn_k", "attn_v", "attn_o", "cross_q"):
        spec = weight_spec(cfg, kind)
        assert spec.granularity == "per_head" and spec.bits == 4
        assert spec.grad_scale_mode == "module_l1"
    assert weight_spec(cfg, "ffn_in").granularity == "per_tensor"
    assert weight_spec(cfg, "moe_in").granularity == "per_expert"


def test_lsq_baseline_per_tensor_everywhere():
    cfg = QuantConfig(w_bits=4, a_bits=4, mode="lsq")
    for kind in ("attn_q", "ffn_in", "moe_in"):
        spec = weight_spec(cfg, kind)
        assert spec.granularity == "per_tensor"
        assert spec.grad_scale_mode == "lsq"


def test_edge_pins_8bit():
    cfg = QuantConfig(w_bits=2, a_bits=2, mode="mdq")
    assert weight_spec(cfg, "embed").bits == 8
    assert weight_spec(cfg, "lm_head").bits == 8
    assert weight_spec(cfg, "router").bits == 8
    assert weight_spec(cfg, "xlstm_gates").bits == 8
    assert weight_spec(cfg, "attn_q").bits == 2


def test_activation_specs_asymmetric():
    cfg = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    spec = act_spec(cfg, "ffn_in")
    assert spec.offset and not spec.signed and spec.bits == 4


def test_fp_mode_disables():
    cfg = QuantConfig(mode="off")
    assert weight_spec(cfg, "attn_q") is None
    assert act_spec(cfg, "attn_q") is None


def test_leave_one_out_override():
    base = QuantConfig(w_bits=3, a_bits=3, mode="mdq")
    rows = dict(leave_one_out_configs(base))
    assert weight_spec(rows["All, except MHSA"], "attn_v") is None
    assert weight_spec(rows["All, except MHSA"], "ffn_in") is not None
    assert weight_spec(rows["All, except value"], "attn_v") is None
    assert weight_spec(rows["All, except value"], "attn_q") is not None


def test_quantize_one_only_override():
    base = QuantConfig(w_bits=3, a_bits=3, mode="mdq")
    rows = dict(quantize_one_only_configs(base))
    assert weight_spec(rows["value only"], "attn_v") is not None
    assert weight_spec(rows["value only"], "ffn_in") is None


def test_kv_cache_spec():
    assert kv_cache_spec(QuantConfig(w_bits=4, a_bits=4)) is None
    spec = kv_cache_spec(QuantConfig(w_bits=4, a_bits=4, kv_cache_bits=8))
    assert spec.bits == 8 and spec.granularity == "per_head"


def test_presets():
    assert get_preset("w2a2").obr_lambda > 0
    assert get_preset("w4a4").obr_lambda == 0
    assert get_preset("w4a4_lsq").mode == "lsq"
    with pytest.raises(KeyError):
        get_preset("nope")


def test_all_kinds_have_specs():
    cfg = QuantConfig(w_bits=4, a_bits=4, mode="mdq")
    for kind in ALL_KINDS:
        weight_spec(cfg, kind)
        act_spec(cfg, kind)
