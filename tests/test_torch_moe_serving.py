"""The port's MoE serving (prefill_step / decode_step over int-coded experts)
against the JAX package on the same serving weights: reduced
granite-moe-1b-a400m (4 experts top 2, w3a3: 3-bit nibble-packed experts,
an 8-bit router, tied head) and reduced mixtral-8x7b (4 experts top 2,
ring-buffered local layers, w4a4, untied head), at fp, int8 and int4 KV, on
the kernel route and the unfused one.

Bars (those of tests/test_torch_serving_model.py):
  * float32 dtype, fp KV: max |dlogit| <= 1e-4 (summation order only).
  * bfloat16 (XLA compiled with excess precision off): 90th percentile
    |dlogit| < 1e-3, mean < 0.05, max |dp| < 0.02, equal argmax.
  * Quantized KV: the distribution part (mean < 0.05, max |dp| < 0.02, equal
    argmax where the top-2 gap exceeds twice the row's largest |dlogit|).

Routing. The router is an f32 product of the input with 8-bit codes times
an f32 scale; the two frameworks sum it in other orders. Where the port
routes a token to another expert than the reference, the reference's k-th
and (k+1)-th probabilities must tie within two f32 ulps
(tests/test_torch_moe.py's rule), held on every layer's serving router.

Row independence and streams (the port alone): a token's MoE output has the
same bits at M 1, 4 and 32, and a slot's decode logits the same bits alone,
in a pool of 4 and beside idle (pos = -1) rows; the engine's streams equal
single-request greedy_generate at capacity_factor = n_experts / top_k,
where no (token, slot) pair can drop whatever a step's row count. At the
configs' own 1.25 a chunked prefill changes the capacity of each step, and
padding and idle rows take capacity, so streams are not held there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import EXACT_BF16, configs, serving_params  # noqa: E402
from repro.core.policy import get_preset  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core.policy import get_preset as t_get_preset  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoe  # noqa: E402
from repro_torch.serve import ModelExecutor, SamplingParams, Scheduler, ServeEngine  # noqa: E402

QUANT = {"granite-moe-1b-a400m": "w3a3", "mixtral-8x7b": "w4a4"}
B, P, CACHE = 2, 7, 16


def _qcfgs(quant, kv_bits, route):
    jf = "on" if route == "kernel" else "off"
    tf = "auto" if route == "kernel" else "off"
    jq = get_preset(quant).replace(kv_cache_bits=kv_bits, a_bits=32,
                                   fused_matmul=jf, fused_attention=jf)
    tq = t_get_preset(quant).replace(kv_cache_bits=kv_bits, a_bits=32,
                                     fused_matmul=tf, fused_attention=tf)
    return jq, tq


def _ties_explain(jp, ji, ti, k):
    """Tokens whose top-k expert sets differ hold a tie at the k-th place of
    the reference's probabilities (equal or two f32 ulps apart)."""
    differ = np.where((np.sort(ji, -1) != np.sort(ti, -1)).any(-1))[0]
    srt = -np.sort(-jp, -1)
    tied = srt[:, k - 1] - srt[:, k] <= 2 * np.spacing(srt[:, k - 1])
    return differ, bool(np.all(tied[differ]))


def _router_pair(jparams, tparams, layer, x, jc, jq, tq):
    """Both sides' router probabilities and top-k indices on x (t, d) f32,
    with layer `layer`'s serving router."""
    n_scan = jc.n_groups * jc.period
    key, pos, g = (("groups", layer % jc.period, layer // jc.period)
                   if layer < n_scan else ("tail", layer - n_scan, None))
    jr = jparams[key][pos]["moe"]["router"]
    if g is not None:
        jr = jax.tree.map(lambda a: a[g], jr)
    lg = JC.qlinear(jr, jnp.asarray(x), "router", jq, "td,de->te",
                    cdtype=jnp.float32)
    jp = np.asarray(jax.nn.softmax(lg, -1))
    ji = np.asarray(jax.lax.top_k(jp, jc.moe_top_k)[1])
    tr = tparams["layers"][layer]["moe"]["router"]
    tp = torch.softmax(TC.qlinear(tr, torch.from_numpy(x), "router", tq,
                                  "td,de->te", cdtype=torch.float32), -1)
    ti = torch.sort(tp, dim=-1, descending=True, stable=True).indices[:, :jc.moe_top_k]
    return jp, ji, tp.numpy(), ti.numpy()


def _run_both(arch, kv_bits, route, dtype):
    """Prefill (one row padded with pos = -1) then two decode steps on both
    sides; returns [(jax logits, port logits, valid-row mask)] per step."""
    jc, tc = configs(arch, dtype)
    jq, tq = _qcfgs(QUANT[arch], kv_bits, route)
    jparams, tparams = serving_params(arch, QUANT[arch])
    step = jax.jit(lambda p, c, b: JM.prefill_step(p, c, b, jc, jq))
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
    for tk, ps in batches:
        jb = {"tokens": jnp.asarray(tk), "pos": jnp.asarray(ps)}
        if tk.shape not in compiled:
            compiled[tk.shape] = step.lower(jparams, jcache, jb).compile(EXACT_BF16)
        jl, jcache = compiled[tk.shape](jparams, jcache, jb)
        tl, tcache = TM.prefill_step(
            tparams, tcache, {"tokens": torch.from_numpy(tk),
                              "pos": torch.from_numpy(ps)}, tc, tq)
        v = jc.vocab_size
        out.append((np.asarray(jl)[..., :v], tl.numpy()[..., :v], ps >= 0))
    return out


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


# granite-moe's kernel route is held at bf16 only (BF16_CASES): kernels 8
# and 9 round to bf16 inside (the dequantized codes, P), so at f32 an ulp of
# summation order can cross a rounding boundary; on these inputs one decode
# row then moves by 3.1e-4, while either kernel alone stays within 6e-8.
F32_CASES = [("granite-moe-1b-a400m", "off"), ("mixtral-8x7b", "off"),
             ("mixtral-8x7b", "kernel")]


@pytest.mark.parametrize("arch,route", F32_CASES)
def test_logits_match_jax_float32(arch, route):
    for jl, tl, valid in _run_both(arch, 0, route, "float32"):
        assert np.isfinite(tl[valid]).all()
        np.testing.assert_allclose(tl[valid], jl[valid], rtol=0, atol=1e-4)


# (arch, kv_bits, route); "kernel" = the serving route. int4 KV is held on
# mixtral: on these inputs reduced granite-moe's top-2 logits sit closer
# than twice the int4 code-step gap (0.05-0.06) on 9 of 16 rows, so the
# distribution bar would decide fewer than half of them.
BF16_CASES = [
    ("granite-moe-1b-a400m", 0, "kernel"),
    ("granite-moe-1b-a400m", 8, "off"),
    ("granite-moe-1b-a400m", 8, "kernel"),
    ("mixtral-8x7b", 0, "off"),
    ("mixtral-8x7b", 8, "kernel"),
    ("mixtral-8x7b", 4, "off"),
    ("mixtral-8x7b", 4, "kernel"),
]


@pytest.mark.parametrize("arch,kv_bits,route", BF16_CASES)
def test_logits_match_jax_bf16(arch, kv_bits, route):
    decided_rows = []
    for jl, tl, valid in _run_both(arch, kv_bits, route, "bfloat16"):
        j, t = jl[valid], tl[valid]
        assert np.isfinite(t).all()
        d = np.abs(t - j)
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


@pytest.mark.parametrize("arch", list(QUANT))
def test_router_matches_jax_up_to_ties(arch):
    """Every layer's serving router (8-bit codes, f32 products) on 64 rows:
    probabilities within 1e-6 of the reference's, and every token routed
    otherwise holds a tie at the k-th place in the reference."""
    jc, tc = configs(arch, "bfloat16")
    jq, tq = _qcfgs(QUANT[arch], 8, "off")
    jparams, tparams = serving_params(arch, QUANT[arch])
    x = np.random.default_rng(3).standard_normal((64, jc.d_model)).astype(np.float32)
    for layer in range(jc.n_layers):
        jp, ji, tp, ti = _router_pair(jparams, tparams, layer, x, jc, jq, tq)
        assert "codes" in tparams["layers"][layer]["moe"]["router"]
        assert np.abs(tp - jp).max() <= 1e-6
        differ, explained = _ties_explain(jp, ji, ti, jc.moe_top_k)
        assert explained, differ


def test_serving_tree_matches_the_reference():
    """The port's own serving init and the bridged reference tree hold the
    same layout: packed (E, K/2, N) expert codes with (E, 1, 1) scales and
    an unpacked 8-bit router; the router's per-tensor scale crosses the
    bridge as a 0-d tensor, as the port's init makes it, and both compute
    f32(code) x f32(scale)."""
    arch = "granite-moe-1b-a400m"
    _, tc = configs(arch)
    _, tq = _qcfgs("w3a3", 8, "off")
    _, bridged = serving_params(arch, "w3a3")
    own = TM.init_serving_params(tc, tq, torch.Generator().manual_seed(0), "cpu")
    e, d, f = tc.n_experts, tc.d_model, tc.d_ff
    for params in (bridged, own):
        moe = params["layers"][0]["moe"]
        assert set(moe) == {"router", "moe_in", "moe_gate", "moe_out"}
        for name, shape in (("moe_in", (e, d // 2, f)), ("moe_gate", (e, d // 2, f)),
                            ("moe_out", (e, f // 2, d))):
            assert tuple(moe[name]["codes4"].shape) == shape
            assert moe[name]["codes4"].dtype == torch.int8
            assert tuple(moe[name]["w_scale"].shape) == (e, 1, 1)
        assert tuple(moe["router"]["codes"].shape) == (d, e)
        assert tuple(moe["router"]["w_scale"].shape) == ()
    r = bridged["layers"][0]["moe"]["router"]
    x = torch.randn((5, d), generator=torch.Generator().manual_seed(1))
    want = x @ (r["codes"].float() * r["w_scale"].float())
    got = TC.qlinear(r, x, "router", tq, "td,de->te", cdtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# row independence and the engine's streams (the port alone)
# ---------------------------------------------------------------------------

def _port(arch="granite-moe-1b-a400m", kv_bits=8, no_drop=True):
    _, tc = configs(arch)
    if no_drop:
        tc = tc.replace(capacity_factor=tc.n_experts / tc.moe_top_k)
    _, tq = _qcfgs(QUANT[arch], kv_bits, "kernel")
    return tc, tq, serving_params(arch, QUANT[arch])[1]


@pytest.mark.parametrize("arch", list(QUANT))
def test_moe_output_same_bits_at_m_1_4_32(arch):
    """Token 0's MoE output (router, experts, combine) is the same bits at
    M 1, 4 and 32 (capacities 8, 8 and 24 at the config's own factor): the
    router runs in fixed 128-row blocks, the experts in 8-row blocks, and
    token 0 is first in every expert's capacity order."""
    tc, tq, params = _port(arch, no_drop=False)
    p = params["layers"][0]["moe"]
    x = torch.randn((1, 32, tc.d_model),
                    generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    outs = [TMoe.moe_ffn(p, x[:, :m], tc, tq, torch.bfloat16)[0][0, 0]
            for m in (1, 4, 32)]
    assert [TMoe.capacity(m, tc) for m in (1, 4, 32)] == [8, 8, 24]
    for o in outs[1:]:
        assert torch.equal(o.view(torch.int16), outs[0].view(torch.int16))


@pytest.mark.parametrize("kv_bits", [0, 8, 4], ids=["fp", "int8", "int4"])
def test_decode_row_same_bits_alone_pooled_and_beside_idle_rows(kv_bits):
    """A slot's decode logits are the same bits alone (B 1), in a pool of 4
    active slots, and beside 3 idle slots (pos = -1, routed and taking
    capacity), after the same one-chunk prefill: the mirror of
    chip_smoke.py's check at the model's level, at the config's own
    capacity factor (c = 8 holds a decode step's 4 tokens)."""
    tc, tq, params = _port(kv_bits=kv_bits, no_drop=False)
    rng = np.random.default_rng(4)
    prompts = torch.from_numpy(rng.integers(1, 250, (4, 9)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(1, 250, (4, 1)).astype(np.int32))
    pos = torch.arange(9, dtype=torch.int32)[None]

    def run(rows, idle=()):
        cache = TM.init_cache(tc, tq, rows, 16, "cpu")
        for r in range(rows):  # each row's own prefill: the slot insert's cache
            one = TM.init_cache(tc, tq, 1, 16, "cpu")
            TM.prefill_step(params, one, {"tokens": prompts[r:r + 1], "pos": pos},
                            tc, tq)
            TM.cache_slot_insert(cache, one, r)
        dpos = torch.full((rows, 1), 9, dtype=torch.int32)
        for r in idle:
            dpos[r] = -1
        lg, _ = TM.decode_step(params, cache, {"tokens": nxt[:rows], "pos": dpos},
                               tc, tq)
        return lg[0, 0]

    alone, pooled, beside_idle = run(1), run(4), run(4, idle=(1, 2, 3))
    assert torch.isfinite(alone).all()
    assert torch.equal(pooled, alone) and torch.equal(beside_idle, alone)


def _prompts(lens):
    rng = np.random.default_rng(11)
    return [rng.integers(1, 250, n).astype(np.int32) for n, _ in lens]


STREAM_LENS = [(5, 4), (13, 6), (3, 5), (9, 4)]  # (prompt_len, max_new)


@pytest.mark.parametrize("route,chunk", [("off", 6), ("kernel", 16)])
@pytest.mark.parametrize("kv_bits", [0, 8], ids=["fp", "int8"])
def test_engine_streams_match_greedy_at_no_drop_capacity(kv_bits, route, chunk):
    """Reduced granite-moe at capacity_factor = E / k: each request's engine
    stream (2 slots, partial chunks padded with pos = -1 rows, slots
    recycled, up front and staggered arrivals) equals its own
    single-request greedy_generate stream. On the unfused route with chunk
    6; on the kernel route with a one-chunk prefill (16 >= every prompt),
    as chip_smoke.py holds it: there a chunked prefill rounds otherwise
    than a one-shot one (ROADMAP Queue 3)."""
    tc, tq, params = _port(kv_bits=kv_bits)
    tq = tq.replace(fused_matmul="off" if route == "off" else "auto",
                    fused_attention="off" if route == "off" else "auto")
    max_len = 40
    prompts = _prompts(STREAM_LENS)
    step = lambda p, c, b: TM.prefill_step(p, c, b, tc, tq)
    refs = []
    for prompt, (_, max_new) in zip(prompts, STREAM_LENS):
        toks, _ = serve.greedy_generate(step, params,
                                        TM.init_cache(tc, tq, 1, max_len, "cpu"),
                                        torch.from_numpy(prompt)[None], max_new)
        refs.append([int(t) for t in toks[0]])
    for staggered in (False, True):
        eng = ServeEngine(ModelExecutor(params, tc, tq, n_slots=2,
                                        max_len=max_len, chunk=chunk),
                          Scheduler(max_len=max_len))
        idx = steps = 0
        while idx < len(prompts) or eng.has_work:
            if idx < len(prompts) and (not staggered or steps % 3 == 0):
                eng.submit(prompts[idx],
                           SamplingParams(max_new_tokens=STREAM_LENS[idx][1]),
                           rid=f"r{idx}")
                idx += 1
                continue
            eng.step()
            steps += 1
        assert [eng.results[f"r{i}"].tokens for i in range(4)] == refs


def test_cli_serves_moe_on_cpu_only_when_asked():
    argv = ["--arch", "mixtral-8x7b", "--quant", "w4a4", "--smoke", "--batch",
            "2", "--prompt-len", "6", "--new-tokens", "3", "--chunk", "4"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(argv)
    run = serve.main(argv + ["--device", "cpu"])
    assert run.cfg.n_experts and run.device.type == "cpu"
    assert all(len(run.engine.results[f"req-{i}"].tokens) == 3 for i in range(2))
