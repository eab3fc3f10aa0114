"""The port's serving engine: each request's stream equals its own
single-request greedy_generate (fp / int8 / packed-int4 KV, up-front and
staggered arrivals, chunked prefill, slot recycling, gemma2's ring-buffered
local layers), and at fp and int8 KV equals the JAX package's streams on the
same weights. Mirrors tests/test_serve_engine.py's real-model tests."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import configs, serving_params  # noqa: E402
from repro.core.policy import QuantConfig as JQuantConfig  # noqa: E402
from repro.launch.serve import greedy_generate as j_greedy  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.core.policy import QuantConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import ModelExecutor, SamplingParams, Scheduler, ServeEngine  # noqa: E402

ARCH = "gemma2-2b"  # (local ring, global) pattern
MAX_LEN = 40
# prompt 13 > window 8 exercises the ring buffer; 4 requests on 2 slots
# exercise recycle + mid-flight refill; chunk 6 leaves partial last chunks
PROMPTS = [(5, 4), (13, 6), (3, 5), (9, 4)]  # (prompt_len, max_new)
KV_IDS = {0: "fp", 8: "int8", 4: "int4"}


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 250, n).astype(np.int32) for n, _ in PROMPTS]


def _setup(kv_bits, dtype="bfloat16", fused="auto"):
    """Serving weights (w8a8, fp activations) shared by both sides."""
    jcfg, tcfg = configs(ARCH, dtype)
    jq = JQuantConfig(w_bits=8, a_bits=32, mode="mdq", kv_cache_bits=kv_bits,
                      fused_matmul="off", fused_attention="off")
    tq = QuantConfig(w_bits=8, a_bits=32, mode="mdq", kv_cache_bits=kv_bits,
                     fused_matmul=fused, fused_attention=fused)
    jparams, tparams = serving_params(ARCH, "w8a8")
    return jcfg, jq, jparams, tcfg, tq, tparams


def _port_greedy(tcfg, tq, tparams, prompts):
    step = lambda p, c, b: TM.prefill_step(p, c, b, tcfg, tq)
    refs = []
    for prompt, (_, max_new) in zip(prompts, PROMPTS):
        cache = TM.init_cache(tcfg, tq, 1, MAX_LEN, "cpu")
        toks, _ = serve.greedy_generate(step, tparams, cache,
                                        torch.from_numpy(prompt)[None], max_new)
        refs.append([int(t) for t in toks[0]])
    return refs


def _run_engine(tcfg, tq, tparams, prompts, *, chunk, staggered):
    ex = ModelExecutor(tparams, tcfg, tq, n_slots=2, max_len=MAX_LEN,
                       chunk=chunk)
    eng = ServeEngine(ex, Scheduler(max_len=MAX_LEN))
    if staggered:
        # drip-feed arrivals so admission interleaves with decode steps
        idx = 0
        steps = 0
        while idx < len(prompts) or eng.has_work:
            if idx < len(prompts) and steps % 3 == 0:
                eng.submit(prompts[idx],
                           SamplingParams(max_new_tokens=PROMPTS[idx][1]),
                           rid=f"r{idx}")
                idx += 1
            eng.step()
            steps += 1
    else:
        for i, prompt in enumerate(prompts):
            eng.submit(prompt, SamplingParams(max_new_tokens=PROMPTS[i][1]),
                       rid=f"r{i}")
        eng.run_until_idle()
    return [eng.results[f"r{i}"].tokens for i in range(len(prompts))]


@pytest.mark.parametrize("kv_bits", [0, 8, 4], ids=KV_IDS.get)
def test_engine_matches_own_greedy(kv_bits):
    """bf16 (the model dtype), kernel route (plain versions on the CPU):
    the engine's streams equal greedy_generate's, up front and staggered."""
    _, _, _, tcfg, tq, tparams = _setup(kv_bits)
    prompts = _prompts()
    refs = _port_greedy(tcfg, tq, tparams, prompts)
    assert _run_engine(tcfg, tq, tparams, prompts, chunk=6,
                       staggered=False) == refs
    assert _run_engine(tcfg, tq, tparams, prompts, chunk=6,
                       staggered=True) == refs


def test_chunked_prefill_equals_single_chunk():
    _, _, _, tcfg, tq, tparams = _setup(0)
    prompts = _prompts()
    refs = _port_greedy(tcfg, tq, tparams, prompts)
    assert _run_engine(tcfg, tq, tparams, prompts, chunk=16,
                       staggered=False) == refs


# JAX comparison: four prompts of one length (13 > window 8: the ring wraps;
# chunk 6 leaves a partial last chunk), so the JAX side runs one batched
# greedy_generate (one compile per step shape) instead of one per length
SAME_LEN, SAME_NEW = 13, 5


def _jax_greedy_batched(jcfg, jq, jparams, prompts):
    step = jax.jit(lambda p, c, b: JM.prefill_step(p, c, b, jcfg, jq))
    cache = JM.init_cache(jcfg, jq, len(prompts), MAX_LEN)
    toks, _ = j_greedy(step, jparams, cache, jnp.asarray(np.stack(prompts)),
                       SAME_NEW)
    return [[int(t) for t in row] for row in np.asarray(toks)]


@pytest.mark.parametrize("kv_bits", [0, 8, 4], ids=KV_IDS.get)
def test_streams_match_jax(kv_bits):
    """f32 dtype, the unfused composition on both sides: the port's
    greedy_generate and engine streams equal the JAX package's
    greedy_generate streams on the same weights (int4 KV against JAX's
    fused_attention="off", as the JAX package's own int4 engine parity
    holds only there)."""
    jcfg, jq, jparams, tcfg, tq, tparams = _setup(kv_bits, "float32", "off")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 250, SAME_LEN).astype(np.int32)
               for _ in range(4)]
    j_refs = _jax_greedy_batched(jcfg, jq, jparams, prompts)
    step = lambda p, c, b: TM.prefill_step(p, c, b, tcfg, tq)
    toks, _ = serve.greedy_generate(
        step, tparams, TM.init_cache(tcfg, tq, 4, MAX_LEN, "cpu"),
        torch.from_numpy(np.stack(prompts)), SAME_NEW)
    assert [[int(t) for t in row] for row in toks] == j_refs
    ex = ModelExecutor(tparams, tcfg, tq, n_slots=2, max_len=MAX_LEN, chunk=6)
    eng = ServeEngine(ex, Scheduler(max_len=MAX_LEN))
    for i, prompt in enumerate(prompts):
        eng.submit(prompt, SamplingParams(max_new_tokens=SAME_NEW), rid=f"r{i}")
    eng.run_until_idle()
    assert [eng.results[f"r{i}"].tokens for i in range(4)] == j_refs


def test_cli_runs_on_cpu_only_when_asked():
    argv = ["--smoke", "--batch", "2", "--prompt-len", "6", "--new-tokens", "3",
            "--chunk", "4"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(argv)
    run = serve.main(argv + ["--device", "cpu"])
    assert run.device.type == "cpu"
    assert all(len(run.engine.results[f"req-{i}"].tokens) == 3 for i in range(2))
    assert run.summary["requests"]["finished"] == 2
