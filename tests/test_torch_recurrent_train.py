"""One train step of reduced xlstm-350m (7 mLSTM : 1 sLSTM blocks, tied
head) in the port against the JAX package, with the checks and bars of
tests/test_torch_recurrent_model.py (its docstring states them): loss,
health bits and osc_frac with oscillation tracked, and every gradient."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_recurrent_model import (check_step_gradients,  # noqa: E402
                                        check_step_metrics, stepped)

ARCH = "xlstm-350m"


@pytest.fixture(scope="module")
def xlstm_step():
    return stepped(ARCH)


def test_train_step_metrics_match_jax(xlstm_step):
    check_step_metrics(xlstm_step)


def test_train_step_gradients_match_jax(xlstm_step):
    """The mLSTM's and sLSTM's own leaves carry gradients: projections,
    gate biases, the conv, the head norms, the recurrent mix."""
    check_step_gradients(xlstm_step, ("/mq/w", "/m_i/w", "/m_i/b", "/conv_w",
                                      "/hn_g", "/s_r/w", "/s_f/b", "/f_bias",
                                      "/gn_g"))
