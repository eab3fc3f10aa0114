"""Reduced recurrentgemma-9b (two RG-LRU blocks and a local-attention block
with MQA in one scanned period, then an RG-LRU tail layer; tied head) in
the port against the JAX package: the forward at f32 and at bf16 and one
train step, with the checks and bars of tests/test_torch_recurrent_model.py
(its docstring states them)."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_recurrent_model import (check_bf16_forward,  # noqa: E402
                                        check_fp32_forward, check_step_gradients,
                                        check_step_metrics, stepped)

ARCH = "recurrentgemma-9b"


def test_fp32_forward_logits_match_jax():
    check_fp32_forward(ARCH)


def test_bf16_forward_logits_match_jax():
    check_bf16_forward(ARCH)


@pytest.fixture(scope="module")
def rg_step():
    return stepped(ARCH)


def test_train_step_metrics_match_jax(rg_step):
    check_step_metrics(rg_step)


def test_train_step_gradients_match_jax(rg_step):
    """The RG-LRU leaves carry gradients, the tail's too; the block's outer
    ln1 is read by nothing and gets a zero gradient on both sides."""
    check_step_gradients(rg_step, ("/rg/g_a/w", "/rg/g_a/b", "/rg/g_x/w",
                                   "/rg/lam", "/rg/conv_w", "/rg/g_out/w"))
    for k, g in rg_step["j_grads"].items():
        if "/ln1/" in k and k.split("/")[1] in ("0", "1"):
            assert not g.any() and not rg_step["t_grads"][k].any(), k
    assert any(k.startswith("tail/0/rg/") for k in rg_step["j_grads"])
