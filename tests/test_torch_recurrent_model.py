"""The recurrent families and cross-attention in the port, model by model,
against the JAX package on the same inputs. This file holds the shared
checks and runs the forward ones on reduced xlstm-350m (7 mLSTM : 1 sLSTM
blocks, one period, no tail, tied head), plus the checks that need no
reference on all three models and the CLIs;
tests/test_torch_recurrent_train.py runs xlstm-350m's train step,
tests/test_torch_recurrent_hybrid.py runs the
same checks on reduced recurrentgemma-9b (two RG-LRU blocks and a
local-attention block with MQA, then an RG-LRU tail layer, tied head),
tests/test_torch_recurrent_cross.py on reduced llama-3.2-vision-11b (four
attention blocks and a cross-attention block over 8 stub patch
embeddings), and tests/test_torch_recurrent_serving.py the serving steps
of all three (one file each keeps each under a minute: XLA takes most of
it compiling the reference).

Both sides take the same latent params (`latent`: the reference's
`init_params` layout and distributions drawn in numpy, carried over by
`bridge.state_from_jax`), with the activation quantizers at scale 1 and
offset -0.03 as the other parity tests set them (offsets of 0 put exact
ties on the clip edge, ROADMAP Queue 3) and the cross-attention gates at
0.5 (init's 0 shuts the sublayer).

Bars (each stated where it is used):
  * forward at f32 with fp weights: the head's input within 1e-5 of its
    largest value (only summation orders differ), the logits within what
    the head's bf16 operands allow (`check_fp32_forward`); at bf16
    under w4a4 MDQ (XLA compiled with excess precision off): the bar of
    tests/test_fused_qat_matmul.py:396-403;
  * one train step at f32, w4a4, fused_matmul off on both sides,
    oscillation tracked, sentinel on (`stepped`): loss within 1e-5
    relative, health bits equal (0), osc_frac within 0.01; the gradients
    each within 1e-4 of their largest |g| (tests/test_torch_train_step.py's
    bars: a weight scale's normalized by its sum of |summands|, the scalar
    activation quantizers and cross gates pooled per name, the head's dW
    allowed one bf16 ulp on up to 1% of its elements; a leaf below 1e-6
    of the model's largest |g| held within 1e-8 of it,
    `check_step_gradients`);
  * decode from a bridged reference cache at f32: logits within 1e-4 and
    the new recurrent states within 1e-4 of their largest value;
  * decode matches forward (the twin of tests/test_arch_smoke.py:57-91):
    the reference's bars, rtol 0.1, atol 0.6, top-1 agreement > 0.9;
  * serving conversion (the twin of test_arch_smoke.py:103): rtol 0.05,
    atol 0.3;
  * greedy_generate at f32 with an fp KV cache: the same token streams as
    the reference's.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import EXACT_BF16, bf16_ulp, configs, train_batch  # noqa: E402
from test_torch_train_step import (HEAD_LEAVES, _leaves_jax,  # noqa: E402
                                   _leaves_jax_layout, _normalized_close,
                                   _torch_batch)
from repro.core import kd as j_kd  # noqa: E402
from repro.core.oscillation import (init_osc_state,  # noqa: E402
                                    oscillation_fraction, update_osc_state)
from repro.core.policy import get_preset  # noqa: E402
from repro.core.policy import weight_spec as j_weight_spec  # noqa: E402
from repro.launch.serve import greedy_generate as j_greedy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.common import NAME2KIND  # noqa: E402
from repro.models.common import convert_to_serving as j_convert  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import schedule as j_schedule  # noqa: E402
from repro.train import sentinel as j_sent  # noqa: E402
from repro.train.state import TrainConfig as JTrainConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.policy import get_preset as t_get_preset  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import sentinel as t_sent  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402
from repro_torch.train.state import TrainConfig as TTrainConfig  # noqa: E402

ARCH = "xlstm-350m"
ARCHS = ["xlstm-350m", "recurrentgemma-9b", "llama-3.2-vision-11b"]
TRAIN = dict(kd="mckd", total_steps=10, warmup_steps=0)
SEQ = 12

# fan-in of a weight by its linear's name: the leading axes it contracts
_FAN_IN_AXES = dict.fromkeys(("wq", "wk", "wv", "xq", "xk", "xv", "mq", "mk",
                              "mv", "s_z", "s_i", "s_f", "s_o"), (-3,))
_FAN_IN_AXES.update(wo=(-3, -2), xo=(-3, -2))


@functools.lru_cache(maxsize=None)
def latent(arch, quant, dtype):
    """Numpy latent params in the layout of the reference's init_params
    (`jax.eval_shape`, no compile) with its distributions: weights normal
    with std fan_in**-0.5 (the embedding 0.02), LSQ scales 2 mean|w| /
    sqrt(Q_P) over each scale group at the leaf's own bit width, norms,
    hn_g and gn_g 1, f_bias 3, conv_w 0.1 N(0, 1), Lambda uniform in
    [0.38, 0.8], biases 0; activation scales 1, offsets -0.03, cross gates
    0.5 (module docstring)."""
    jc, _ = configs(arch, dtype)
    jq = get_preset(quant)
    shapes = jax.eval_shape(functools.partial(JM.init_params, cfg=jc, qcfg=jq),
                            jax.random.PRNGKey(0))
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
                q_p = 2 ** (j_weight_spec(jq, NAME2KIND[name]).bits - 1) - 1
                out["w_scale"] = (2.0 * m / np.sqrt(q_p)).astype(np.float32)
            return out
        if isinstance(node, tuple):
            return tuple(fill(v, name, parent) for v in node)
        shape = node.shape
        const = {"a_scale": 1.0, "g": 1.0, "w_scale": 1.0, "hn_g": 1.0,
                 "gn_g": 1.0, "f_bias": 3.0, "a_offset": -0.03, "b": 0.0,
                 "xgate": 0.5}.get(name)
        if const is not None:
            return np.full(shape, const, np.float32)
        if name == "lam":
            return rng.uniform(0.38, 0.8, shape).astype(np.float32)
        if name == "conv_w":
            std = 0.1
        elif parent == "embed":
            std = 0.02
        else:
            std = float(np.prod([shape[a] for a in _FAN_IN_AXES.get(parent, (-2,))])) ** -0.5
        return (rng.standard_normal(shape) * std).astype(np.float32)

    return fill(shapes)


def states(arch, quant="w4a4", dtype="float32", track=False):
    """(cfgs, qcfgs, tcfgs, jax state, port state): `latent`, zero
    moments, a fresh sentinel state and, with `track`, the oscillation
    state; fused_matmul off on both sides."""
    jc, tc = configs(arch, dtype)
    kw = dict(fused_matmul="off", track_oscillation=track)
    jq, tq = get_preset(quant).replace(**kw), t_get_preset(quant).replace(**kw)
    jt = JTrainConfig(sentinel=j_sent.SentinelConfig(), **TRAIN)
    tt = TTrainConfig(sentinel=t_sent.SentinelConfig(), **TRAIN)
    params = jax.tree.map(jnp.asarray, latent(arch, quant, dtype))
    opt = j_adamw.init(params, jt.adamw)
    osc = (tuple(init_osc_state(w, s, spec) for w, s, spec in
                 JM.quant_leaves(params, jq)) if track else ())
    jstate = {"params": params, "mu": opt.mu, "nu": opt.nu,
              "step": jnp.asarray(0, jnp.int32), "osc": osc, "err": (),
              "sent": j_sent.init_sentinel_state()}
    tstate = bridge.state_from_jax(jax.tree.map(np.asarray, jstate), tc, "cpu",
                                   qcfg=tq)
    return (jc, tc), (jq, tq), (jt, tt), jstate, tstate


def batch_of(cfg, seq=SEQ):
    """`train_batch` (tokens, labels, top-16 MCKD labels), with the vision
    patches scaled to unit deviation: at the sampler's 0.02 the cross
    attention's K / V, and so its query-side gradients (~1e-13), vanish."""
    b = train_batch(cfg, seq=seq)
    if "frontend_embeds" in b and cfg.frontend == "vision_patches":
        b["frontend_embeds"] = b["frontend_embeds"] * 50.0
    return b


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _bf16_bar(lg_t, lg_j, v):
    """tests/test_fused_qat_matmul.py:396-403's bar."""
    d = np.abs(lg_t - lg_j)
    assert np.isfinite(lg_t).all()
    assert np.quantile(d, 0.9) < 1e-3, np.quantile(d, 0.9)
    assert d.mean() < 0.05, d.mean()
    p_t = torch.softmax(torch.from_numpy(np.array(lg_t[..., :v])), -1)
    p_j = torch.softmax(torch.from_numpy(np.array(lg_j[..., :v])), -1)
    assert float((p_t - p_j).abs().max()) < 0.02
    assert (lg_t[..., :v].argmax(-1) == lg_j[..., :v].argmax(-1)).all()


def close(got, want, tol, what=""):
    """Every array of `want` (dicts and tuples walked, None skipped) within
    tol of its largest |value|."""
    if isinstance(want, dict):
        for k in want:
            close(got[k], want[k], tol, f"{what}/{k}")
        return
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            if w is not None:
                close(g, w, tol, f"{what}/{i}")
        return
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# shared checks (run on the other models by the sibling files)
# ---------------------------------------------------------------------------

def _bf16(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).float().numpy()


def check_fp32_forward(arch):
    """The head's input (the final norm's output, recorded by wrapping each
    package's lm_head_apply) within 1e-5 of its largest value. The head
    contracts bf16 operands, so an input an f32 ulp apart now and then
    rounds to the neighbouring bf16 value: the logits are held within
    1e-5 of their largest |value| plus what those roundings can move them,
    |bf16(x_port) - bf16(x_ref)| @ |W_head|."""
    (jc, tc), (jq, tq), _, jstate, tstate = states(arch, "fp")
    b = batch_of(jc)
    j_head, t_head, seen = JM.lm_head_apply, TM.lm_head_apply, {}

    def jfwd(p, bb):
        def head(hp, x, *a, **kw):
            seen["j"] = x
            return j_head(hp, x, *a, **kw)
        JM.lm_head_apply = head
        try:
            return JM.forward(p, bb, jc, jq)[0], seen.pop("j")
        finally:
            JM.lm_head_apply = j_head

    def thead(hp, x, *a, **kw):
        seen["t"] = x
        return t_head(hp, x, *a, **kw)

    lg_j, x_j = (np.asarray(a) for a in jax.jit(jfwd)(jstate["params"],
                                                      jax_batch(b)))
    TM.lm_head_apply = thead
    try:
        with torch.no_grad():
            lg_t = TM.forward(tstate["params"], _torch_batch(b), tc, tq)[0].numpy()
    finally:
        TM.lm_head_apply = t_head
    x_t = seen["t"].numpy()
    close(x_t, x_j, 1e-5, "head input")
    p = jstate["params"]
    w = np.asarray(p["embed"]["w"]).T if jc.tie_embeddings else np.asarray(p["lm_head"]["w"])
    flips = np.abs(_bf16(x_t) - _bf16(x_j)) @ np.abs(_bf16(w))
    v = tc.vocab_size
    d = np.abs(lg_t[..., :v] - lg_j[..., :v])
    scale = np.abs(lg_j[..., :v]).max()
    assert np.all(d <= flips[..., :v] + 1e-5 * scale), (d - flips[..., :v]).max()


def check_bf16_forward(arch):
    (jc, tc), (jq, tq), _, jstate, tstate = states(arch, "w4a4", "bfloat16")
    b = batch_of(jc)
    fwd = jax.jit(lambda p, bb: JM.forward(p, bb, jc, jq)[0])
    jb = jax_batch(b)
    lg_j = np.asarray(fwd.lower(jstate["params"], jb).compile(EXACT_BF16)(
        jstate["params"], jb))
    with torch.no_grad():
        lg_t = TM.forward(tstate["params"], _torch_batch(b), tc, tq)[0].numpy()
    _bf16_bar(lg_t, lg_j, tc.vocab_size)


def _w_scale_norms(params: dict, grads: dict, qcfg) -> dict:
    """tests/test_torch_train_step.py's normalizer of a w_scale gradient
    (the sum over its group of |summands|), each leaf at its own kind's
    bit width (the recurrent gates are pinned to 8 bits)."""
    out = {}
    for k, s in params.items():
        if not k.endswith("/w_scale"):
            continue
        base = k[:-len("w_scale")]
        w, dw = params[base + "w"], grads[base + "w"]
        bits = j_weight_spec(qcfg, NAME2KIND[k.split("/")[-2]]).bits
        q_n, q_p = 2 ** (bits - 1), 2 ** (bits - 1) - 1
        stacked = k.startswith("groups/")
        sb = s.reshape(s.shape + (1,) * (w.ndim - s.ndim)) if s.ndim < w.ndim else s
        axes = tuple(i for i in range(int(stacked), w.ndim) if sb.shape[i] == 1)
        u = w / np.maximum(sb, 1e-9)
        q = np.clip(np.round(u), -q_n, q_p)
        g = 1.0 / np.sqrt(q_p * np.sum(np.abs(w), axis=axes, keepdims=True))
        out[k] = (g * np.sum(np.abs(dw * (q - u)), axis=axes,
                             keepdims=True)).reshape(s.shape)
    return out


def _j_step_tail(jq, jt):
    """The reference train_step's lines after its gradients on a healthy
    step (train_step.py:125-166): the health check, AdamW at the scheduled
    rate, the Eq. 12 update on the new weights and osc_frac. Jitted apart
    from the model, which XLA then compiles once (for the gradients)."""
    def tail(state, loss, grads):
        params = state["params"]
        osc_prev = jnp.mean(jnp.stack([oscillation_fraction(st, jq.osc_threshold)
                                       for st in state["osc"]]))
        health, _, _ = j_sent.health_check(loss, grads, JM.quant_leaves(params, jq),
                                           osc_prev, state["sent"], jt.sentinel)
        lr = j_schedule.warmup_cosine(state["step"], peak=jt.adamw.lr_peak,
                                      warmup_steps=jt.warmup_steps,
                                      total_steps=jt.total_steps) * state["sent"].lr_scale
        new_params, _, _ = j_adamw.update(grads, j_adamw.AdamWState(state["mu"], state["nu"]),
                                          params, state["step"], lr, jt.adamw)
        new_osc = [update_osc_state(st, w, s, spec, momentum=jq.osc_momentum)
                   for st, (w, s, spec) in zip(state["osc"],
                                               JM.quant_leaves(new_params, jq))]
        return health, jnp.mean(jnp.stack([oscillation_fraction(st, jq.osc_threshold)
                                           for st in new_osc]))
    return jax.jit(tail)


def stepped(arch):
    """One train step on both sides from one state and batch: the
    reference's loss and gradients (its loss_fn without remat, jitted), its
    step's health bits and osc_frac (`_j_step_tail`); the port's
    `make_grad_fn` gradients and `make_train_step` metrics."""
    (jc, tc), (jq, tq), (jt, tt), jstate, tstate = states(arch, track=True)
    b = batch_of(jc)
    jb = jax_batch(b)

    def j_loss_fn(params):
        logits, aux = JM.forward(params, jb, jc, jq, remat=False)
        return (j_kd.sparse_soft_ce(logits, jb["kd_idx"], jb["kd_p"])
                + jt.lb_coef * aux["lb_loss"])

    j_loss, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(jstate["params"])
    j_health, j_osc = _j_step_tail(jq, jt)(jstate, j_loss, j_grads)
    _, _, t_grads = TT.make_grad_fn(tc, tq, tt)(tstate["params"],
                                                _torch_batch(b), tstate["step"])
    _, t_m = TT.make_train_step(tc, tq, tt)(tstate, _torch_batch(b))
    j_grads = _leaves_jax(j_grads)
    t_flat = _leaves_jax_layout(t_grads, tc)
    norms = _w_scale_norms(_leaves_jax(jstate["params"]), j_grads, jq)
    for name in ("a_scale", "a_offset", "xgate"):  # scalars, pooled per name
        keys = [k for k in j_grads if k.endswith("/" + name) or k == name]
        if keys:
            pooled = max(float(np.abs(j_grads[k]).max()) for k in keys)
            norms.update({k: np.full(j_grads[k].shape, pooled, np.float32)
                          for k in keys})
    return dict(arch=arch, j_loss=float(j_loss), j_health=int(j_health),
                j_osc=float(j_osc), t_m=t_m, j_grads=j_grads, t_grads=t_flat,
                norms=norms, head_ulps={
                    k: bf16_ulp(np.maximum(np.abs(j_grads[k]), np.abs(t_flat[k])))
                    for k in HEAD_LEAVES if k in j_grads})


def check_step_metrics(st):
    t = st["t_m"]
    assert abs(float(t["loss"]) - st["j_loss"]) <= 1e-5 * abs(st["j_loss"])
    assert int(t["health"]) == st["j_health"] == 0
    assert abs(float(t["osc_frac"]) - st["j_osc"]) <= 0.01, (
        float(t["osc_frac"]), st["j_osc"])


def check_step_gradients(st, live: tuple):
    """Every leaf at the bars; the leaves named in `live` (the new blocks'
    weights) carry a gradient. A leaf whose largest |g| is below 1e-6 of
    the model's largest is cancellation residue (xlstm's sLSTM input-gate
    bias: ~1e-10 against 0.05), held within 1e-8 of the model's largest
    |g|."""
    got, want = st["t_grads"], st["j_grads"]
    for name in live:
        keys = [k for k in want if k.endswith(name)]
        assert keys and all(np.abs(want[k]).max() > 0 for k in keys), name
    floor = 1e-6 * max(float(np.abs(g).max()) for g in want.values())
    norms = dict(st["norms"])
    for k, g in want.items():
        if k not in norms and np.abs(g).max() < floor:
            norms[k] = np.full(g.shape, 100.0 * floor, np.float32)
    _normalized_close(got, want, 1e-4, "grads", norms, st["head_ulps"])


# ---------------------------------------------------------------------------
# xlstm-350m against the reference
# ---------------------------------------------------------------------------

def test_fp32_forward_logits_match_jax():
    check_fp32_forward(ARCH)


def test_bf16_forward_logits_match_jax():
    check_bf16_forward(ARCH)


# ---------------------------------------------------------------------------
# the port alone, all three models
# ---------------------------------------------------------------------------

def test_cross_attention_reads_the_patches():
    """llama-3.2-vision's tokens stay the input and its patches reach the
    logits through the cross layer only: other patches, other logits;
    with the gate at 0 (init), none."""
    (_, tc), (_, tq), _, _, tstate = states("llama-3.2-vision-11b", "fp")
    b = _torch_batch(batch_of(tc))
    other = dict(b, frontend_embeds=b["frontend_embeds"] * -1.0)
    with torch.no_grad():
        base = TM.forward(tstate["params"], b, tc, tq)[0]
        moved = TM.forward(tstate["params"], other, tc, tq)[0]
        shut = {**tstate["params"], "layers": [
            dict(lay, xgate=torch.zeros(())) if "xgate" in lay else lay
            for lay in tstate["params"]["layers"]]}
        a = TM.forward(shut, b, tc, tq)[0]
        c = TM.forward(shut, other, tc, tq)[0]
    assert base.shape[1] == SEQ
    assert not torch.equal(base, moved) and torch.equal(a, c)


def test_osc_groups_follow_the_reference():
    """osc_frac is a mean over the reference's stacked leaves: xlstm-350m
    (period 8, 24 layers) 3 groups and no tail, recurrentgemma-9b (period
    3, 38 layers) 12 groups and a tail of 2; built at reduced widths with
    the full depth. The RG-LRU's nested "rg" leaves group by their path."""
    q = t_get_preset("w4a4")
    for arch, n_groups, n_tail in (("xlstm-350m", 3, 0), ("recurrentgemma-9b", 12, 2)):
        cfg = treg.reduced_config(treg.get_config(arch))
        cfg = cfg.replace(n_layers=treg.get_config(arch).n_layers)
        params = TM.init_params(cfg, q, torch.Generator().manual_seed(0), "cpu")
        paths = [p for p, _, _, _ in TM.quant_leaf_paths(params, q)]
        groups = TM.jax_leaf_groups(paths, cfg)
        sizes = {len(members) for k, members in groups if k[0] == "groups"}
        assert sizes == {n_groups}, (arch, sizes)
        assert len({k[1] for k, _ in groups if k[0] == "tail"}) == n_tail
        keys = [k for k, _ in groups]
        assert keys == sorted(keys)
        if arch == "recurrentgemma-9b":
            assert ("groups", 0, "rg", "g_a") in keys and ("tail", 1, "rg", "g_x") in keys


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The twin of tests/test_arch_smoke.py:57-91 on the port: token by
    token decode against the cache == the full forward (teacher forcing),
    bf16, w4a4 MDQ, the port's own init (cross gates 0)."""
    cfg = treg.reduced_config(treg.get_config(arch))
    q = t_get_preset("w4a4").replace(fused_matmul="off", fused_attention="off")
    params = TM.init_params(cfg, q, torch.Generator().manual_seed(0), "cpu")
    b, s = 2, 12
    batch = _torch_batch(train_batch(cfg, batch=b, seq=s))
    with torch.no_grad():
        full, _ = TM.forward(params, batch, cfg, q)
    cache = TM.init_cache(cfg, q, b, s, "cpu")
    got = []
    for t in range(s):
        db = {"tokens": batch["tokens"][:, t:t + 1], "pos": torch.full((b,), t)}
        lg, cache = TM.decode_step(params, cache, db, cfg, q)
        got.append(lg[:, 0])
    got = torch.stack(got, 1).float().numpy()
    full = full.float().numpy()
    np.testing.assert_allclose(got, full, rtol=0.1, atol=0.6)
    assert np.mean(got.argmax(-1) == full.argmax(-1)) > 0.9


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_conversion_matches_qat(arch):
    """The twin of tests/test_arch_smoke.py:103 on the port: int-code
    serving logits == fake-quant QAT logits (weights only), every new
    leaf converted: the gates' biases kept (bf16), s_r as int codes, the
    f32 leaves (conv_w, lam, hn_g, gn_g, f_bias, xgate) cast to bf16, as
    the reference's convert_to_serving casts them."""
    cfg = treg.reduced_config(treg.get_config(arch))
    q = t_get_preset("w4a4").replace(a_bits=32)
    params = TM.init_params(cfg, q, torch.Generator().manual_seed(0), "cpu")
    batch = _torch_batch(train_batch(cfg, batch=2, seq=8))
    sp = TC.convert_to_serving(params, q)
    with torch.no_grad():
        lq, _ = TM.forward(params, batch, cfg, q)
        ls, _ = TM.forward(sp, batch, cfg, q)
    np.testing.assert_allclose(ls.float().numpy(), lq.float().numpy(),
                               rtol=0.05, atol=0.3)
    lay0 = sp["layers"][0]
    if arch == "xlstm-350m":
        assert "codes" in lay0["m_i"] and lay0["m_i"]["b"].dtype == torch.bfloat16
        assert "codes4" in sp["layers"][7]["s_r"] and "codes4" in lay0["mq"]
        assert lay0["conv_w"].dtype == lay0["hn_g"].dtype == torch.bfloat16
        assert sp["layers"][7]["f_bias"].dtype == torch.bfloat16
    elif arch == "recurrentgemma-9b":
        assert "codes4" in lay0["rg"]["g_a"]
        assert lay0["rg"]["g_a"]["b"].dtype == lay0["rg"]["lam"].dtype == torch.bfloat16
    else:
        assert "codes4" in sp["layers"][4]["xq"]
        assert sp["layers"][4]["xgate"].dtype == torch.bfloat16


def test_failed_step_leaves_the_recurrent_cache_unchanged(monkeypatch):
    """A step that raises after the last layer (here: in the lm head)
    commits nothing: every recurrent state and K/V row stays as it was."""
    from repro_torch import tree as T
    cfg = treg.reduced_config(treg.get_config("recurrentgemma-9b"))
    q = t_get_preset("w4a4").replace(a_bits=32)
    sp = TM.init_serving_params(cfg, q, torch.Generator().manual_seed(0), "cpu")
    cache = TM.init_cache(cfg, q, 2, 12, "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(0))
    TM.prefill_step(sp, cache, {"tokens": toks, "pos": torch.arange(6)[None].expand(2, -1)},
                    cfg, q)
    before = TM.cache_clone(cache)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(TM, "lm_head_apply", boom)
    with pytest.raises(RuntimeError, match="injected"):
        TM.decode_step(sp, cache, {"tokens": toks[:, :1], "pos": torch.full((2,), 6)},
                       cfg, q)
    pairs = [(p, a, b) for (p, a), (_, b) in zip(T.flatten(before), T.flatten(cache))
             if a is not None]
    assert any("rglru" in p for p, _, _ in pairs)
    for p, a, b in pairs:
        assert torch.equal(a, b), p


def test_slot_ops_carry_recurrent_states():
    """cache_slot_insert copies a batch-1 cache's recurrent states and cross
    K / V into one slot of a pool, in place, and cache_slot_reset puts the
    initial states back (the stabilizers' -1e9 included)."""
    from repro_torch import tree as T
    q = t_get_preset("w4a4").replace(a_bits=32)
    for arch in ("xlstm-350m", "llama-3.2-vision-11b"):
        cfg = treg.reduced_config(treg.get_config(arch))
        sp = TM.init_serving_params(cfg, q, torch.Generator().manual_seed(0), "cpu")
        one = TM.init_cache(cfg, q, 1, 8, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (1, 4),
                             generator=torch.Generator().manual_seed(1))
        TM.prefill_step(sp, one, {"tokens": toks, "pos": torch.arange(4)[None]}, cfg, q)
        for lay in one["layers"]:  # give the (never written) cross K / V a value
            for t in lay.get("xkv", ()):
                t.fill_(0.5)
        pool, fresh = (TM.init_cache(cfg, q, 3, 8, "cpu") for _ in range(2))
        TM.cache_slot_insert(pool, one, 1)
        row, got, init = (dict(T.flatten(c)) for c in (one, pool, fresh))
        for path, t in got.items():
            if t is None:
                continue
            assert torch.equal(t[1], row[path][0]), path
            assert torch.equal(t[0], init[path][0]) and torch.equal(t[2], init[path][2])
        assert any("mlstm" in p or "xkv" in p for p in got)
        TM.cache_slot_reset(pool, TM.init_cache(cfg, q, 1, 8, "cpu"), 1)
        for path, t in dict(T.flatten(pool)).items():
            if t is not None:
                assert torch.equal(t, init[path]), path


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_runs_xlstm(tmp_path):
    from repro_torch.launch import train
    rep = train.main(["--device", "cpu", "--smoke", "--arch", "xlstm-350m",
                      "--quant", "w4a4", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--ckpt", str(tmp_path / "ck")])
    assert rep.steps_run == 2 and all(np.isfinite(rep.losses))
    assert not any(rep.healths)


def test_serve_cli_refuses_xlstm():
    """As the reference's: the engine refuses a recurrent pattern."""
    with pytest.raises(ValueError, match="attention-only patterns"):
        t_serve.main(["--device", "cpu", "--smoke", "--arch", "xlstm-350m",
                      "--quant", "w4a4"])
