"""Shared set-up for the port's parity tests against the JAX package (not a
test module).

Latent parameters come from numpy, shaped like the JAX package's
`init_params` tree (`jax.eval_shape`, no compile), with the LSQ scale init
computed in numpy; the JAX package's own `convert_to_serving` (jitted) then
freezes them. The port receives the very same serving tree through
`repro_torch.bridge`. The JAX step runs jitted with
`xla_allow_excess_precision=False`, so XLA rounds every bf16 op as written
(by default its fusions may keep f32 intermediates), which is what the port,
running op by op, does.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.registry import get_config, reduced_config
from repro.core.policy import get_preset
from repro.models import model as JM
from repro.models.common import convert_to_serving as j_convert
from repro_torch import bridge
from repro_torch.configs import registry as treg

EXACT_BF16 = {"xla_allow_excess_precision": False}


def configs(arch: str, dtype: str = "bfloat16"):
    """(JAX cfg, port cfg) at reduced size; granite keeps GQA (kv heads 2),
    which reduced_config drops by setting kv heads = heads."""
    jc = reduced_config(get_config(arch)).replace(dtype=dtype)
    tc = treg.reduced_config(treg.get_config(arch)).replace(dtype=dtype)
    if arch == "granite-8b":
        jc = dataclasses.replace(jc, n_kv_heads=2)
        tc = dataclasses.replace(tc, n_kv_heads=2)
    return jc, tc


def latent_params(jcfg, jqcfg):
    """Numpy latent params in the layout of JM.init_params(key, jcfg, jqcfg),
    with its standard deviations (embedding 0.02, every other weight
    fan_in**-0.5), LSQ scales 2*mean|w|/sqrt(Q_P) over each scale group,
    activation scales 1 and offsets 0, norms 1."""
    shapes = jax.eval_shape(functools.partial(JM.init_params, cfg=jcfg,
                                              qcfg=jqcfg), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def fill(node, name="", parent=""):
        if isinstance(node, dict):
            out = {k: fill(v, k, name) for k, v in node.items()}
            if "w" in out and "w_scale" in out:
                w, sc = out["w"], out["w_scale"]
                if sc.ndim == w.ndim:  # grouped: reduce where the scale is 1
                    axes = tuple(i for i, n in enumerate(sc.shape) if n == 1)
                else:                  # per tensor, stacked over layers or not
                    axes = tuple(range(sc.ndim, w.ndim))
                m = np.mean(np.abs(w), axis=axes, keepdims=sc.ndim == w.ndim)
                bits = 8 if name in ("embed", "lm_head") else jqcfg.w_bits
                q_p = 2 ** (bits - 1) - 1
                out["w_scale"] = (2.0 * m / np.sqrt(q_p)).astype(np.float32)
            return out
        if isinstance(node, tuple):
            return tuple(fill(v, name, parent) for v in node)
        if name in ("a_scale", "g", "w_scale"):  # w_scale: set from "w" above
            return np.ones(node.shape, np.float32)
        if name in ("a_offset", "b", "xgate"):
            return np.zeros(node.shape, np.float32)
        if parent == "embed":
            std = 0.02
        elif parent in ("wq", "wk", "wv"):      # (d, heads, head_dim)
            std = node.shape[-3] ** -0.5
        elif parent == "wo":                    # (heads, head_dim, d)
            std = (node.shape[-3] * node.shape[-2]) ** -0.5
        else:                                   # (fan_in, fan_out)
            std = node.shape[-2] ** -0.5
        return (rng.standard_normal(node.shape) * std).astype(np.float32)

    return fill(shapes)


@functools.lru_cache(maxsize=None)
def serving_params(arch: str, quant: str, a_bits: int = 32):
    """(JAX serving tree, the port's bridged params) for reduced `arch`
    under preset `quant`; a_bits=32 leaves activations unquantized, as the
    serving CLI sets."""
    jc, tc = configs(arch)
    jq = get_preset(quant).replace(a_bits=a_bits)
    latent = latent_params(jc, jq)
    jparams = jax.jit(j_convert, static_argnums=(1,))(latent, jq)
    return jparams, bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                           tc, "cpu")


def train_states(arch: str, quant: str = "w4a4", *, dtype: str = "float32",
                 fused: str = "off", sentinel: bool = True,
                 unrolled: bool = False, **tcfg_kw):
    """The reference's train state built from `latent_params` (f32 latent
    weights, zero AdamW moments, step 0, a fresh sentinel state) and the
    port's bridged copy of it, for reduced `arch` under preset `quant`.

    Returns (cfgs, qcfgs, tcfgs, jax_state, port_state) with each of cfgs /
    qcfgs / tcfgs a (JAX, port) pair; `fused` is the reference's
    fused_matmul ("off" or "on"; the port's kernel route is "auto").
    unrolled=True repeats the (one-block) pattern three times, so the
    reference keeps its two layers in its unrolled "tail" instead of a
    lax.scan: the same model, computed as written (see
    test_torch_train_step.py on what XLA's scan changes)."""
    from repro.optim import adamw as j_adamw
    from repro.train import sentinel as j_sent
    from repro.train.state import TrainConfig as JTrainConfig
    from repro_torch.core.policy import get_preset as t_get_preset
    from repro_torch.train import sentinel as t_sent
    from repro_torch.train.state import TrainConfig as TTrainConfig

    jc, tc = configs(arch, dtype)
    if unrolled:
        jc, tc = (c.replace(pattern=c.pattern * 3) for c in (jc, tc))
    jq = get_preset(quant).replace(fused_matmul=fused)
    tq = t_get_preset(quant).replace(fused_matmul="off" if fused == "off"
                                     else "auto")
    jt = JTrainConfig(sentinel=j_sent.SentinelConfig() if sentinel else None,
                      **tcfg_kw)
    tt = TTrainConfig(sentinel=t_sent.SentinelConfig() if sentinel else None,
                      **tcfg_kw)
    params = jax.tree.map(jnp.asarray, latent_params(jc, jq))
    opt = j_adamw.init(params, jt.adamw)
    jstate = {"params": params, "mu": opt.mu, "nu": opt.nu,
              "step": jnp.zeros((), jnp.int32), "osc": (), "err": (),
              "sent": j_sent.init_sentinel_state() if sentinel else ()}
    tstate = bridge.state_from_jax(jax.tree.map(np.asarray, jstate), tc, "cpu")
    return (jc, tc), (jq, tq), (jt, tt), jstate, tstate


def train_batch(cfg, batch: int = 2, seq: int = 16, k: int = 16, step: int = 0):
    """A numpy batch for both sides: `sample_batch` tokens and labels, and
    top-k MCKD labels from one numpy generator (the two packages' own
    synthetic label makers draw from different generators)."""
    from repro_torch.data.synthetic import DataConfig, sample_batch
    b = sample_batch(cfg, DataConfig(), step, batch, seq)
    rng = np.random.default_rng(100 + step)
    alt = rng.integers(0, cfg.vocab_size, size=(batch, seq, k - 1))
    b["kd_idx"] = np.concatenate([b["labels"][..., None], alt], -1).astype(np.int32)
    p = rng.random((batch, seq, k)).astype(np.float32) + 0.05
    b["kd_p"] = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    return b


def bf16_ulp(v) -> np.ndarray:
    """The spacing of bf16 values at |v| (0 where v is 0), f64."""
    a = np.abs(np.asarray(v, np.float64))
    e = np.floor(np.log2(np.where(a > 0, a, 1.0)))
    return np.where(a > 0, 2.0 ** (e - 7), 0.0)
