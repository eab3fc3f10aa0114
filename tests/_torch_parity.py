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
