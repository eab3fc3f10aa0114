"""Learned positions and the audio / vision-patch frontends in the port,
against the JAX package on the same inputs: reduced paper-bert-base (learned
positions), paper-deit-t (an encoder over vision patches with learned
positions) and musicgen-medium (learned positions, audio frames added to
the token embeddings), all three with layernorm, gelu and a non-gated FFN.

Bars (each stated where it is used):
  * forward logits at bf16 (XLA compiled with excess precision off): the
    bar of tests/test_fused_qat_matmul.py:396-403, 90th percentile
    |dlogit| < 1e-3, mean < 0.05, max |dp| < 0.02, equal argmax;
  * one QAT train step at f32, fused_matmul off on both sides, the
    reference unrolled without remat, the offsets at -0.03 and the
    reference's head cotangent fed to the port's backward (the `stepped`
    fixture says why): tests/test_torch_train_step.py's bars
    (loss within 1e-5 relative; every gradient leaf, pos_embed and the
    embedding included, within 1e-4 of its largest |g|, weight scales
    normalized by their sum of |summands|, the head's dW allowed one bf16
    ulp on up to 1% of its elements; a scalar activation scale or offset,
    a sum over every element of its input with much cancellation, within
    1e-4 of the largest |g| among the model's leaves of its name, pooled
    as chip_smoke.py's route check pools them);
  * make_eval_step at f32: ce within 1e-5 relative, acc equal;
  * serving prefill / decode: tests/test_torch_serving_model.py's bars (f32
    at fp KV: 1e-4 absolute; int8 KV at bf16: the distribution part of the
    bf16 bar); padding rows (pos -1) read pos_embed row 0 on both sides;
  * engine streams: equal to the reference's greedy_generate (f32,
    unfused, one-chunk prefill) and to the port's own (bf16, the kernel
    route's plain versions, chunked).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import (EXACT_BF16, bf16_ulp, configs,  # noqa: E402
                           serving_params, train_batch, train_states)
from test_torch_train_step import (HEAD_LEAVES, _leaves_jax,  # noqa: E402
                                   _leaves_jax_layout, _normalized_close,
                                   _torch_batch, _w_scale_norms)
from repro.core import kd as j_kd  # noqa: E402
from repro.core.policy import get_preset  # noqa: E402
from repro.launch.serve import greedy_generate as j_greedy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.train.train_step import make_eval_step as j_eval_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core.policy import get_preset as t_get_preset  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import ModelExecutor, SamplingParams, Scheduler, ServeEngine  # noqa: E402
from repro_torch.train import train_step as TT  # noqa: E402

ARCHS = ["paper-bert-base", "paper-deit-t", "musicgen-medium"]
TRAIN = dict(kd="mckd", total_steps=10, warmup_steps=0)


def _seq(cfg, default: int = 12) -> int:
    """DeiT's logits are per patch: its labels run over the patches."""
    return cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else default


def _jax_batch(b: dict) -> dict:
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


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["fp", "w4a4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_logits_match_jax(arch, quant):
    (jc, tc), (jq, tq), _, jstate, tstate = train_states(
        arch, quant, dtype="bfloat16", sentinel=False)
    b = train_batch(jc, seq=_seq(jc))
    fwd = jax.jit(lambda p, bb: JM.forward(p, bb, jc, jq)[0])
    jb = _jax_batch(b)
    lg_j = np.asarray(fwd.lower(jstate["params"], jb).compile(EXACT_BF16)(
        jstate["params"], jb))
    with torch.no_grad():
        lg_t = TM.forward(tstate["params"], _torch_batch(b), tc, tq)[0].numpy()
    _bf16_bar(lg_t, lg_j, tc.vocab_size)


@pytest.mark.parametrize("arch", ARCHS)
def test_encoder_mode_matches_jax(arch):
    """cfg.replace(causal=False) (the configs keep the reference's default
    causal=True): the bf16 bar above."""
    (jc, tc), (jq, tq), _, jstate, tstate = train_states(
        arch, "w4a4", dtype="bfloat16", sentinel=False)
    jc, tc = jc.replace(causal=False), tc.replace(causal=False)
    b = train_batch(jc, seq=_seq(jc))
    fwd = jax.jit(lambda p, bb: JM.forward(p, bb, jc, jq)[0])
    jb = _jax_batch(b)
    lg_j = np.asarray(fwd.lower(jstate["params"], jb).compile(EXACT_BF16)(
        jstate["params"], jb))
    with torch.no_grad():
        lg_t = TM.forward(tstate["params"], _torch_batch(b), tc, tq)[0].numpy()
        causal = TM.forward(tstate["params"], _torch_batch(b),
                            tc.replace(causal=True), tq)[0].numpy()
    _bf16_bar(lg_t, lg_j, tc.vocab_size)
    assert not np.array_equal(lg_t, causal)  # the mask did change something


def test_positions_and_frames_move_the_logits():
    """pos_embed and the audio frames both reach the logits (so the parity
    above is not vacuous): zeroing either changes them."""
    (_, tc), (_, tq), _, _, tstate = train_states(
        "musicgen-medium", "fp", dtype="float32", sentinel=False)
    b = _torch_batch(train_batch(tc, seq=12))
    with torch.no_grad():
        base = TM.forward(tstate["params"], b, tc, tq)[0]
        no_fe = TM.forward(tstate["params"], {**b, "frontend_embeds":
                                              torch.zeros_like(b["frontend_embeds"])},
                           tc, tq)[0]
        params = dict(tstate["params"],
                      pos_embed=torch.zeros_like(tstate["params"]["pos_embed"]))
        no_pos = TM.forward(params, b, tc, tq)[0]
    assert not torch.equal(base, no_fe) and not torch.equal(base, no_pos)


# ---------------------------------------------------------------------------
# one train step, and make_eval_step
# ---------------------------------------------------------------------------

def _offsets_shifted(latent):
    """Every activation quantizer given an offset of -0.03, as
    tests/test_torch_moe_train_step.py does: at init the offsets are 0 and
    an attention output that is a sum of small-integer multiples of one
    scale cancels to exactly 0 in one summation order and to an ulp beside
    it in the other (reduced paper-deit-t at w4a4: one element of layer
    1's wo input), a clip-edge tie in one framework only (ROADMAP Queue
    3)."""
    def shift(node, name=""):
        if isinstance(node, dict):
            return {k: shift(v, k) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(shift(v, name) for v in node)
        return np.full(np.shape(node), -0.03, np.float32) if name == "a_offset" else node
    return shift(latent)


@pytest.fixture(scope="module", params=ARCHS)
def stepped(request):
    """Loss and grads on both sides, f32, unfused, the reference unrolled
    without remat (tests/test_torch_train_step.py's docstring), offsets
    shifted (`_offsets_shifted`).

    The lm head's einsum takes bf16 operands on both sides, so its dX (the
    cotangent of the final norm's output) is a bf16 rounding of f32 sums
    taken in two orders: where one lands on the other side of a rounding
    boundary the two differ by one bf16 ulp, and every gradient upstream
    inherits that (reduced paper-deit-t: one element of 1,024, moving the
    final norm's bias gradient by 1.7e-4 of its largest |g|). So the
    reference's head dX is recorded, held against the port's own (one ulp
    on at most 1% of the elements), and fed to the port's backward in place
    of its own; the upstream gradients are then held to the 1e-4 bars."""
    arch = request.param
    (jc, tc), (jq, tq), (jt, tt), jstate, tstate = train_states(
        arch, unrolled=True, params_fn=_offsets_shifted, **TRAIN)
    b = train_batch(jc, seq=_seq(jc))
    jb = _jax_batch(b)
    j_head = JM.lm_head_apply

    def j_loss_fn(params, probe):  # probe: zeros added to the head's input
        def head(p, x, *a, **kw):
            return j_head(p, x + probe, *a, **kw)
        JM.lm_head_apply = head
        try:
            logits, aux = JM.forward(params, jb, jc, jq, remat=False)
        finally:
            JM.lm_head_apply = j_head
        return (j_kd.sparse_soft_ce(logits, jb["kd_idx"], jb["kd_p"])
                + jt.lb_coef * aux["lb_loss"])

    probe = jnp.zeros((b["tokens"].shape[0], b["tokens"].shape[1], jc.d_model),
                      jnp.float32)
    j_loss, (j_grads, j_head_dx) = jax.jit(jax.value_and_grad(
        j_loss_fn, argnums=(0, 1)))(jstate["params"], probe)
    j_head_dx = np.asarray(j_head_dx)

    t_head, own = TM.lm_head_apply, {}

    def head(p, x, *a, **kw):
        def swap(g):
            own["dx"] = g.detach().numpy().copy()
            return torch.from_numpy(np.array(j_head_dx)).to(g.dtype)
        if x.requires_grad:
            x.register_hook(swap)
        return t_head(p, x, *a, **kw)

    TM.lm_head_apply = head
    try:
        t_loss, _, t_grads = TT.make_grad_fn(tc, tq, tt)(
            tstate["params"], _torch_batch(b), tstate["step"])
    finally:
        TM.lm_head_apply = t_head
    j_grads = _leaves_jax(j_grads)
    t_flat = _leaves_jax_layout(t_grads, tc)
    norms = _w_scale_norms(_leaves_jax(jstate["params"]), j_grads, jq)
    for name in ("a_scale", "a_offset"):  # the module docstring's pooled scalars
        keys = [k for k in j_grads if k.endswith("/" + name)]
        pooled = max(float(np.abs(j_grads[k]).max()) for k in keys)
        norms.update({k: np.full(j_grads[k].shape, pooled, np.float32)
                      for k in keys})
    return dict(arch=arch, jc=jc, tc=tc, jq=jq, tq=tq, j_loss=float(j_loss),
                t_loss=float(t_loss), j_grads=j_grads, t_grads=t_flat,
                norms=norms, j_head_dx=j_head_dx, t_head_dx=own["dx"],
                head_ulps={k: bf16_ulp(np.maximum(np.abs(j_grads[k]),
                                                  np.abs(t_flat[k])))
                           for k in HEAD_LEAVES if k in j_grads},
                jstate=jstate, tstate=tstate, batch=b)


def test_head_cotangent_within_one_bf16_ulp(stepped):
    """The head's dX on both sides: equal but for one bf16 ulp on at most
    1% of the elements (the fixture's docstring)."""
    j, t = stepped["j_head_dx"], stepped["t_head_dx"]
    assert j.shape == t.shape
    d = np.abs(t - j)
    assert np.mean(d > 0) <= 0.01, np.mean(d > 0)
    assert np.all(d <= bf16_ulp(np.maximum(np.abs(j), np.abs(t))))


def test_train_step_loss_matches_jax(stepped):
    assert abs(stepped["t_loss"] - stepped["j_loss"]) <= 1e-5 * abs(stepped["j_loss"])


def test_train_step_gradients_match_jax(stepped):
    got, want = stepped["t_grads"], stepped["j_grads"]
    assert "pos_embed" in want and "embed/w" in want
    if stepped["arch"] == "paper-deit-t":  # the patches replace the tokens
        assert not np.any(want["embed/w"]) and not np.any(got["embed/w"])
    else:
        assert np.abs(want["embed/w"]).max() > 0
    # rows past the sequence get no gradient; the first S do
    s = stepped["batch"]["tokens"].shape[1]
    assert np.abs(want["pos_embed"][:s]).max() > 0
    assert not np.any(want["pos_embed"][s:]) and not np.any(got["pos_embed"][s:])
    _normalized_close(got, want, 1e-4, "grads", stepped["norms"],
                      stepped["head_ulps"])


def test_eval_step_matches_jax(stepped):
    jc, tc, jq, tq = (stepped[k] for k in ("jc", "tc", "jq", "tq"))
    b = stepped["batch"]
    j = jax.jit(j_eval_step(jc, jq))(stepped["jstate"]["params"], _jax_batch(b))
    t = TT.make_eval_step(tc, tq)(stepped["tstate"]["params"], _torch_batch(b))
    assert abs(float(t["ce"]) - float(j["ce"])) <= 1e-5 * abs(float(j["ce"]))
    assert float(t["acc"]) == float(j["acc"])


def test_train_step_runs_on_the_kernel_route(stepped):
    """The port's whole step (remat, the fused route's plain versions,
    AdamW, the sentinel) on the three models: finite loss, health 0,
    pos_embed updated and decayed as a weight."""
    (_, tc), (_, tq), (_, tt), _, tstate = train_states(
        stepped["arch"], "w4a4", dtype="bfloat16", fused="on", **TRAIN)
    before = tstate["params"]["pos_embed"].clone()
    new, m = TT.make_train_step(tc, tq, tt)(tstate, _torch_batch(stepped["batch"]))
    assert np.isfinite(float(m["loss"])) and int(m["health"]) == 0
    s = stepped["batch"]["tokens"].shape[1]
    moved = new["params"]["pos_embed"] != before
    assert moved[:s].any() and moved[s:].any()  # the tail by weight decay only


# ---------------------------------------------------------------------------
# serving: prefill / decode, and the engine
# ---------------------------------------------------------------------------

B, P, CACHE = 2, 7, 16


def _serving_qcfgs(quant, kv_bits, route):
    jf = "on" if route == "kernel" else "off"
    tf = "auto" if route == "kernel" else "off"
    jq = get_preset(quant).replace(kv_cache_bits=kv_bits, a_bits=32,
                                   fused_matmul=jf, fused_attention=jf)
    tq = t_get_preset(quant).replace(kv_cache_bits=kv_bits, a_bits=32,
                                     fused_matmul=tf, fused_attention=tf)
    return jq, tq


def _far_pos_params(arch, quant):
    """The serving trees with pos_embed's last row set far out (10.0), so
    that a padding row (pos -1) reading it instead of row 0 would show."""
    jparams, tparams = serving_params(arch, quant)
    jp = dict(jparams, pos_embed=jparams["pos_embed"].at[-1].set(10.0))
    tp = dict(tparams, pos_embed=tparams["pos_embed"].clone())
    tp["pos_embed"][-1] = 10.0
    return jp, tp


def _run_both(arch, quant, kv_bits, route, dtype, frames: bool):
    """Prefill (row 1 padded with pos -1 from position 5; audio frames when
    asked) then two decode steps on both sides; [(jax logits, port logits,
    pos, jax head input, port head input)] per step, padding rows
    included. The head inputs (the final norm's output) are recorded by
    wrapping each package's lm_head_apply."""
    jc, tc = configs(arch, dtype)
    jq, tq = _serving_qcfgs(quant, kv_bits, route)
    jparams, tparams = _far_pos_params(arch, quant)
    j_head, t_head, seen = JM.lm_head_apply, TM.lm_head_apply, {}

    def j_step(p, c, b):
        def head(hp, x, *a, **kw):
            seen["j"] = x
            return j_head(hp, x, *a, **kw)
        JM.lm_head_apply = head
        try:
            lg, c = JM.prefill_step(p, c, b, jc, jq)
        finally:
            JM.lm_head_apply = j_head
        return lg, c, seen.pop("j")

    def t_recording(hp, x, *a, **kw):
        seen["t"] = x.float().numpy().copy()
        return t_head(hp, x, *a, **kw)

    step = jax.jit(j_step)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    pos = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    pos[1, 5:] = -1
    jcache = JM.init_cache(jc, jq, B, CACHE)
    tcache = TM.init_cache(tc, tq, B, CACHE, "cpu")
    batches = [(toks, pos)]
    for s in range(2):
        batches.append((rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32),
                        np.array([[P + s], [5 + s]], np.int32)))
    out, compiled = [], {}
    for i, (tk, ps) in enumerate(batches):
        jb = {"tokens": jnp.asarray(tk), "pos": jnp.asarray(ps)}
        tb = {"tokens": torch.from_numpy(tk), "pos": torch.from_numpy(ps)}
        if frames and i == 0:
            fe = (rng.standard_normal((B, P, jc.d_model)) * 0.02).astype(np.float32)
            jb["frontend_embeds"] = jnp.asarray(fe)
            tb["frontend_embeds"] = torch.from_numpy(fe)
        key = (tk.shape, "frontend_embeds" in jb)
        if key not in compiled:
            compiled[key] = step.lower(jparams, jcache, jb).compile(EXACT_BF16)
        jl, jcache, jx = compiled[key](jparams, jcache, jb)
        TM.lm_head_apply = t_recording
        try:
            tl, tcache = TM.prefill_step(tparams, tcache, tb, tc, tq)
        finally:
            TM.lm_head_apply = t_head
        v = jc.vocab_size
        out.append((np.asarray(jl)[..., :v], tl.float().numpy()[..., :v], ps,
                    np.asarray(jx, np.float32), seen.pop("t")))
    return out


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("arch,quant,frames", [
    ("musicgen-medium", "w4a4", True), ("musicgen-medium", "w8a8", False),
    ("paper-bert-base", "w4a4", False)])
def test_serving_logits_match_jax_float32(arch, quant, frames):
    """f32 at fp KV, unfused, every row, padding rows included (the same
    pos_embed row 0 on both sides; a padding row attends to nothing on
    both). The head's input (the final norm's output) within 1e-5 on every
    element. The head's einsum rounds that input to bf16 even at f32 (as
    the reference's does), so where an element's two f32 values lie on
    either side of a bf16 rounding boundary the row's logits move by that
    bf16 step times the head's weights (reduced paper-bert-base: 1.2e-3 at
    one row): each logit within 1e-4 plus sum_j |bf16(x_j) - bf16(x'_j)| x
    |W_jv|, with W the dequantized head, and rows with no such element
    within 1e-4 alone."""
    _, tparams = serving_params(arch, quant)
    head = tparams["lm_head"]
    w = (TC.unpack_int4(head["codes4"], -2) if "codes4" in head
         else head["codes"]).float() * head["w_scale"].float()
    w = np.abs(w.numpy())[:, :configs(arch)[1].vocab_size]
    for jl, tl, _, jx, tx in _run_both(arch, quant, 0, "off", "float32", frames):
        assert np.isfinite(tl).all()
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-5)
        step = np.abs(_bf16(tx) - _bf16(jx))
        assert np.all(np.abs(tl - jl) <= 1e-4 + 1.01 * (step @ w))


@pytest.mark.parametrize("arch,quant,kv_bits", [
    ("musicgen-medium", "w4a4", 8), ("musicgen-medium", "w4a4", 0),
    ("paper-bert-base", "w8a8", 8)])
def test_serving_logits_match_jax_bf16(arch, quant, kv_bits):
    """bf16 on the serving kernel route (the plain versions here):
    tests/test_torch_serving_model.py's bars on the valid rows."""
    decided_rows = []
    for jl, tl, ps, _, _ in _run_both(arch, quant, kv_bits, "kernel",
                                      "bfloat16", frames=False):
        valid = ps >= 0
        j, t = jl[valid], tl[valid]
        d = np.abs(t - j)
        assert np.isfinite(t).all()
        if kv_bits == 0:
            assert np.quantile(d, 0.9) < 1e-3, np.quantile(d, 0.9)
        assert d.mean() < 0.05, d.mean()
        assert np.abs(_softmax(t) - _softmax(j)).max() < 0.02
        same = t.argmax(-1) == j.argmax(-1)
        if kv_bits == 0:
            assert same.all()
        else:
            top2 = np.sort(j, -1)[:, -2:]
            decided = (top2[:, 1] - top2[:, 0]) > 2 * d.max(-1)
            assert same[decided].all()
            decided_rows.extend(decided)
    assert kv_bits == 0 or np.mean(decided_rows) >= 0.5  # not vacuous


def test_padding_rows_read_position_zero():
    """A pos -1 row gathers pos_embed row 0: its logits are those of the
    same token with pos_embed's last row moved or not (the far row is never
    read), and differ when row 0 moves."""
    _, tc = configs("musicgen-medium", "float32")
    _, tq = _serving_qcfgs("w8a8", 0, "off")
    _, tparams = serving_params("musicgen-medium", "w8a8")
    _, far = _far_pos_params("musicgen-medium", "w8a8")
    moved0 = dict(tparams, pos_embed=tparams["pos_embed"].clone())
    moved0["pos_embed"][0] = 10.0
    batch = {"tokens": torch.tensor([[3, 4]], dtype=torch.int32),
             "pos": torch.tensor([[0, -1]], dtype=torch.int32)}
    out = [TM.prefill_step(p, TM.init_cache(tc, tq, 1, 4, "cpu"), batch, tc, tq)[0]
           for p in (tparams, far, moved0)]
    assert torch.equal(out[0], out[1])
    assert not torch.equal(out[0][0, 1], out[2][0, 1])


MAX_LEN = 24
SAME_LEN, SAME_NEW = 9, 5


def _engine_streams(tc, tq, tparams, prompts, chunk, new):
    ex = ModelExecutor(tparams, tc, tq, n_slots=2, max_len=MAX_LEN, chunk=chunk)
    eng = ServeEngine(ex, Scheduler(max_len=MAX_LEN))
    for i, prompt in enumerate(prompts):
        eng.submit(prompt, SamplingParams(max_new_tokens=new), rid=f"r{i}")
    eng.run_until_idle()
    return [eng.results[f"r{i}"].tokens for i in range(len(prompts))]


def test_engine_streams_match_jax_greedy():
    """Reduced musicgen-medium, w4a4 weights, f32, unfused, fp KV: the
    port's greedy_generate and its engine (one-chunk prefill, 2 slots for
    3 requests: slot recycling) equal the reference's greedy_generate."""
    jc, tc = configs("musicgen-medium", "float32")
    jq, tq = _serving_qcfgs("w4a4", 0, "off")
    jparams, tparams = serving_params("musicgen-medium", "w4a4")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 250, SAME_LEN).astype(np.int32) for _ in range(3)]
    step = jax.jit(lambda p, c, b: JM.prefill_step(p, c, b, jc, jq))
    toks, _ = j_greedy(step, jparams, JM.init_cache(jc, jq, 3, MAX_LEN),
                       jnp.asarray(np.stack(prompts)), SAME_NEW)
    j_refs = [[int(t) for t in row] for row in np.asarray(toks)]
    t_step = lambda p, c, b: TM.prefill_step(p, c, b, tc, tq)
    toks, _ = t_serve.greedy_generate(
        t_step, tparams, TM.init_cache(tc, tq, 3, MAX_LEN, "cpu"),
        torch.from_numpy(np.stack(prompts)), SAME_NEW)
    assert [[int(t) for t in row] for row in toks] == j_refs
    assert _engine_streams(tc, tq, tparams, prompts, SAME_LEN, SAME_NEW) == j_refs


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_engine_matches_own_greedy_chunked(kv_bits):
    """bf16, the kernel route (plain versions on the CPU), chunk 4 with a
    partial last chunk: each engine stream equals its own greedy_generate."""
    _, tc = configs("musicgen-medium", "bfloat16")
    _, tq = _serving_qcfgs("w4a4", kv_bits, "kernel")
    _, tparams = serving_params("musicgen-medium", "w4a4")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n in (9, 5, 11)]
    step = lambda p, c, b: TM.prefill_step(p, c, b, tc, tq)
    refs = []
    for prompt in prompts:
        toks, _ = t_serve.greedy_generate(
            step, tparams, TM.init_cache(tc, tq, 1, MAX_LEN, "cpu"),
            torch.from_numpy(prompt)[None], 4)
        refs.append([int(t) for t in toks[0]])
    assert _engine_streams(tc, tq, tparams, prompts, 4, 4) == refs


# ---------------------------------------------------------------------------
# params: the bridge, serving init, refusals, the frontend batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["paper-bert-base", "musicgen-medium"])
def test_bridge_round_trip_carries_pos_embed(arch):
    """params, mu and nu (non-zero moments) cross from the JAX layout into
    the port and back unchanged, pos_embed included."""
    (jc, tc), _, _, jstate, _ = train_states(arch, sentinel=False)
    np_state = jax.tree.map(np.asarray, jstate)
    rng = np.random.default_rng(3)
    for k in ("mu", "nu"):
        np_state[k] = jax.tree.map(
            lambda a: rng.random(a.shape).astype(np.float32), np_state[k])
    tstate = bridge.state_from_jax(np_state, tc, "cpu")
    for k in ("params", "mu", "nu"):
        assert tstate[k]["pos_embed"].shape == (tc.max_seq, tc.d_model)
        got = dict(_leaves_jax_layout(tstate[k], tc))
        want = _leaves_jax(np_state[k])
        assert set(got) == set(want) and "pos_embed" in want
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_init_equals_converted_training_init(arch):
    """init_serving_params draws pos_embed where init_params does, so it
    equals convert_to_serving(init_params(...)) from the same seed, bit for
    bit (pos_embed cast to bf16)."""
    tc = treg.reduced_config(treg.get_config(arch))
    tq = t_get_preset("w4a4")
    a = TM.init_serving_params(tc, tq, torch.Generator().manual_seed(4), "cpu")
    b = TC.convert_to_serving(
        TM.init_params(tc, tq, torch.Generator().manual_seed(4), "cpu"), tq)
    from repro_torch import tree as T
    fa, fb = T.flatten(a), T.flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    assert a["pos_embed"].dtype == torch.bfloat16
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), p


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "xlstm-350m",
                                  "recurrentgemma-9b"])
def test_cross_attention_and_recurrent_blocks_still_refused(arch):
    tc = treg.reduced_config(treg.get_config(arch))
    tq = t_get_preset("w4a4")
    with pytest.raises(NotImplementedError, match="Queue 1"):
        TM.init_params(tc, tq, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(NotImplementedError, match="Queue 1"):
        TM.init_serving_params(tc, tq, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("arch", ["paper-deit-t", "musicgen-medium"])
def test_frontend_batch_equals_jax_after_bf16_cast(arch):
    """The port's sample_batch keeps f32 frames; the reference's are bf16
    made from f64. After the port's bf16 cast (the model's) they are equal,
    at full width (DeiT: 64 x 197 patches of 192, 2.4 M elements)."""
    from repro.configs.registry import get_config as j_get_config
    from repro.data.synthetic import DataConfig as JD, sample_batch as j_sample
    from repro_torch.data.synthetic import DataConfig, sample_batch
    jc, tc = j_get_config(arch), treg.get_config(arch)
    batch, seq = (64, 197) if arch == "paper-deit-t" else (4, 128)
    j = j_sample(jc, JD(), 3, batch, seq)
    t = sample_batch(tc, DataConfig(), 3, batch, seq)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(t[k], np.asarray(j[k]))
    fe = torch.from_numpy(t["frontend_embeds"]).to(torch.bfloat16)
    want = bridge.to_torch(np.asarray(j["frontend_embeds"]), "cpu")
    assert fe.shape == want.shape and torch.equal(fe, want)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

def test_train_cli_runs_musicgen_on_cpu(tmp_path):
    from repro_torch.launch import train
    rep = train.main(["--arch", "musicgen-medium", "--smoke", "--device", "cpu",
                      "--quant", "w4a4", "--steps", "2", "--batch", "2",
                      "--seq", "16", "--ckpt", str(tmp_path / "ck")])
    assert rep.steps_run == 2 and all(np.isfinite(rep.losses))
    assert rep.healths == [0, 0]


def test_serve_cli_runs_musicgen_on_cpu():
    run = t_serve.main(["--arch", "musicgen-medium", "--smoke", "--device",
                        "cpu", "--quant", "w4a4", "--batch", "3",
                        "--prompt-len", "6", "--new-tokens", "3", "--chunk", "4"])
    assert run.summary["requests"]["finished"] == 3
    assert run.params["pos_embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,quant", [("paper-bert-base", "w2a2"),
                                        ("paper-deit-t", "w3a3")])
def test_run_training_on_paper_backbones(arch, quant, tmp_path):
    """The paper backbones are reached through run_training (ARCH_IDS
    leaves the paper-* configs out of --arch, as the reference does): OBR
    on, oscillation tracked, on the CPU."""
    from repro_torch.data.synthetic import DataConfig
    from repro_torch.launch import train
    from repro_torch.train.sentinel import SentinelConfig
    from repro_torch.train.state import TrainConfig
    assert arch not in treg.ARCH_IDS
    tc = treg.reduced_config(treg.get_config(arch))
    tq = t_get_preset(quant).replace(track_oscillation=True)
    tt = TrainConfig(total_steps=2, warmup_steps=1, kd="none",
                     sentinel=SentinelConfig())
    rep = train.run_training(tc, tq, tt, DataConfig(), steps=2, batch_size=2,
                             seq_len=_seq(tc, 16), ckpt_dir=str(tmp_path),
                             save_every=10, log_every=0, device="cpu")
    assert rep.steps_run == 2 and all(np.isfinite(rep.losses))
    assert not any(h & SentinelConfig().fatal_bits for h in rep.healths)
    assert all("osc_frac" in m and m["loss_obr"] > 0 for m in rep.metrics)


# ---------------------------------------------------------------------------
# chip_smoke.py's launch formula against the dispatcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget,head_split,all_split", [
    (None, False, False), (600_000, True, False), (400_000, True, True)])
def test_launch_formula_follows_the_dispatcher(budget, head_split, all_split,
                                               monkeypatch):
    """chip_smoke.py's qat_launches_per_step counts, from the config, the
    calls a train step makes into the QAT kernels' wrappers (counted here
    on the CPU, where the wrappers run their plain versions): forwards,
    combined backwards, and split dx / dw where `bwd_route` on the padded
    shape takes them. Reduced musicgen-medium (untied head, non-gated FFN)
    at its own scratch budget, and at budgets that send the head (padded N
    384), then every linear (padded N 128), to the split route; and the
    full-width counts of phases 6, 8 and 14."""
    import importlib.util
    import pathlib
    from repro_torch.kernels import quant_matmul as qmm
    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke_formula",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    if budget is not None:
        monkeypatch.setattr(qmm, "BWD_SCRATCH_BUDGET_BYTES", budget)
    calls = {"fwd": 0, "bwd": 0, "split": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    for key, name in (("fwd", "quant_matmul"), ("bwd", "quant_matmul_bwd"),
                      ("split", "_split_bwd")):
        monkeypatch.setattr(qmm, name, counting(key, getattr(qmm, name)))
    (_, tc), (_, tq), (_, tt), _, tstate = train_states(
        "musicgen-medium", "w4a4", dtype="bfloat16", fused="on", **TRAIN)
    b = _torch_batch(train_batch(tc, batch=2, seq=16))
    TT.make_grad_fn(tc, tq, tt)(tstate["params"], b, tstate["step"])
    want = cs.qat_launches_per_step(tc, tq, 32)
    assert calls["fwd"] == want["quant_matmul"]
    assert calls["split"] == want["quant_matmul_dx"] == want["quant_matmul_dw"]
    assert calls["bwd"] - calls["split"] == want["quant_matmul_bwd"]
    n = tc.n_layers
    assert want["quant_matmul_dx"] == (6 * n + 1 if all_split else int(head_split))
    if budget is None:
        full = {("qwen1.5-0.5b", "w4a4", 4096): (337, 168, 1, 0),
                ("granite-moe-1b-a400m", "w3a3", 4096): (193, 96, 1, 72),
                ("musicgen-medium", "w4a4", 4096): (577, 241, 48, 0),
                ("paper-bert-base", "w2a2", 4096): (145, 72, 1, 0),
                ("paper-deit-t", "w3a3", 64 * 197): (145, 73, 0, 0)}
        for (arch, quant, tokens), (f, bwd, dx, bb) in full.items():
            got = cs.qat_launches_per_step(treg.get_config(arch),
                                           t_get_preset(quant), tokens)
            assert (got["quant_matmul"], got["quant_matmul_bwd"],
                    got["quant_matmul_dx"], got["quant_matmul_bwd_batched"]) \
                == (f, bwd, dx, bb), arch
