"""Reduced llama-3.2-vision-11b (four attention blocks and a cross-attention
block over 8 stub patch embeddings, GQA, untied head) in the port against
the JAX package: the forward at f32 and at bf16 and one train step, with
the checks and bars of tests/test_torch_recurrent_model.py (its docstring
states them); the cross gates at 0.5, so the sublayer is live."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_recurrent_model import (check_bf16_forward,  # noqa: E402
                                        check_fp32_forward, check_step_gradients,
                                        check_step_metrics, stepped)

ARCH = "llama-3.2-vision-11b"


def test_fp32_forward_logits_match_jax():
    check_fp32_forward(ARCH)


def test_bf16_forward_logits_match_jax():
    check_bf16_forward(ARCH)


@pytest.fixture(scope="module")
def cross_step():
    return stepped(ARCH)


def test_train_step_metrics_match_jax(cross_step):
    check_step_metrics(cross_step)


def test_train_step_gradients_match_jax(cross_step):
    check_step_gradients(cross_step, ("/xq/w", "/xk/w", "/xv/w", "/xo/w",
                                      "/xgate", "/ln_x/g"))
