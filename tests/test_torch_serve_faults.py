"""The port's serving sentinel: detect -> fault -> quarantine, retry ->
rebuild -> replay, deadlines / cancel, graceful drain, and the stuck
watchdog, on the port's engine (`repro_torch.serve`), simulation and fault
injectors (`repro_torch.testing.faultinject`). Mirrors every test of
tests/test_serve_faults.py: the fast ones drive ServeEngine over
SimExecutor with the same deterministic chaos wrappers and the same
assertions.

The reference's real-model chaos tests (marked slow there) run here, on
the torch ModelExecutor, at a size that takes seconds: reduced gemma2-2b
(ring-buffered local layers) and reduced granite-moe-1b-a400m (w3a3 experts
at capacity_factor = n_experts / top_k, where no token can drop, so a
step's other rows, a NaN one included, cannot move a row's bits). Every
non-faulted stream is held bit-identical to the port's own single-request
greedy_generate (no JAX compile is needed): through a NaN logits row and a
crashed executor rebuilt from scratch with its in-flight work replayed over
`scratch_reset` clones of the cache template; through `corrupt_slot`'s NaN
written into the real in-place pool, healed by `cache_slot_reset`; and
through a SIGTERM drain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import (EngineAbort, EngineStuck, FaultPolicy,  # noqa: E402
                               MetricsCollector, ModelExecutor, NonFiniteLogits,
                               SamplingParams, Scheduler, ServeEngine, SimClock,
                               SimExecutor, sample_token)
from repro_torch.serve.metrics import _pct, _stats  # noqa: E402
from repro_torch.testing import faultinject as fi  # noqa: E402

# ---------------------------------------------------------------------------
# sampling: a non-finite row can never emit a "valid" token (satellite)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "temp"])
def test_sample_token_refuses_nonfinite_rows(bad, temperature):
    row = np.zeros(16, np.float32)
    row[3] = bad
    sp = SamplingParams(temperature=temperature, seed=1)
    with pytest.raises(NonFiniteLogits):
        sample_token(row, sp, 0)


def test_sample_token_finite_rows_unaffected():
    row = np.arange(16, dtype=np.float32)
    assert sample_token(row, SamplingParams(), 0) == 15
    assert sample_token(row, SamplingParams(temperature=0.7, top_k=4,
                                            seed=3), 2) in range(12, 16)


# ---------------------------------------------------------------------------
# metrics: stable schema on degenerate runs (satellite)
# ---------------------------------------------------------------------------


def test_pct_and_stats_degenerate_inputs():
    assert _pct([], 95) == 0.0
    assert _pct([3.0], 50) == 3.0
    assert _pct([1.0, 2.0, 3.0, 4.0], 95) == 4.0
    assert _stats([]) == {"p50": 0.0, "p95": 0.0, "mean": 0.0, "max": 0.0}
    s = _stats([2.0, 4.0])
    assert s["mean"] == 3.0 and s["max"] == 4.0


def _assert_schema(s):
    for key in ("schema", "requests", "ttft_s", "itl_s", "queue_wait_s",
                "throughput", "occupancy", "tokens", "wall_s", "faults"):
        assert key in s
    assert set(s["faults"]) == set(
        ("nonfinite_rows", "faulted", "quarantined_slots", "executor_retries",
         "executor_rebuilds", "replayed", "deadline", "cancelled", "drained",
         "shed_queued"))


def test_summary_empty_run():
    s = MetricsCollector().summary()
    _assert_schema(s)
    assert s["requests"] == {"submitted": 0, "admitted": 0, "rejected": 0,
                             "expired": 0, "finished": 0}
    assert s["wall_s"] == 0.0
    assert s["throughput"]["total_tok_s"] == 0.0
    assert all(v == 0 for v in s["faults"].values())


def test_summary_all_rejected():
    m = MetricsCollector()
    for i in range(3):
        m.on_reject(f"r{i}", "queue_full", float(i))
    s = m.summary()
    _assert_schema(s)
    assert s["requests"]["submitted"] == 3
    assert s["requests"]["rejected"] == 3
    assert s["requests"]["finished"] == 0
    assert s["ttft_s"]["p95"] == 0.0 and s["itl_s"]["mean"] == 0.0


def test_summary_all_expired():
    m = MetricsCollector()
    for i in range(2):
        m.on_submit(f"r{i}", 5, float(i))
        m.on_expire(f"r{i}", 10.0 + i)
    s = m.summary()
    _assert_schema(s)
    assert s["requests"]["expired"] == 2
    assert s["requests"]["finished"] == 0
    assert s["wall_s"] == 0.0  # nothing ever finished with a result
    assert s["tokens"]["generated"] == 0


def test_expired_request_record_not_recreated():
    """Regression (satellite): the expire loop used to call on_submit again,
    replacing the RequestRecord made at submit time and wiping its state;
    expired requests must only get on_expire."""
    clk = SimClock()
    ex = SimExecutor(clk, n_slots=1, max_len=64, chunk=8, vocab=1000)
    eng = ServeEngine(ex, Scheduler(max_len=64, max_wait=0.05),
                      clock=clk.now)
    eng.submit(np.arange(1, 40), SamplingParams(max_new_tokens=20),
               rid="busy")
    eng.submit(np.arange(1, 5), SamplingParams(max_new_tokens=4), rid="late")
    rec_before = eng.metrics.records["late"]
    eng.run_until_idle()
    assert eng.metrics.records["late"] is rec_before  # same object, updated
    assert rec_before.finish_reason == "expired"
    assert eng.metrics.summary()["requests"]["expired"] == 1


# ---------------------------------------------------------------------------
# engine helpers
# ---------------------------------------------------------------------------


def _sim_engine(n_slots=3, max_len=64, chunk=8, vocab=1000, wrap=None,
                faults=None, factory=None, guard=None, **sched_kw):
    clk = SimClock()
    ex = SimExecutor(clk, n_slots=n_slots, max_len=max_len, chunk=chunk,
                     vocab=vocab)
    if wrap is not None:
        ex = wrap(ex)
    sched_kw.setdefault("max_len", max_len)
    eng = ServeEngine(ex, Scheduler(**sched_kw), clock=clk.now,
                      faults=faults, executor_factory=factory, guard=guard,
                      sleep=clk.advance)
    return eng, clk


LENS = [(5, 6), (7, 6), (3, 6), (9, 6), (4, 6), (6, 6)]  # (prompt, max_new)


def _submit_all(eng, lens=LENS):
    rng = np.random.default_rng(0)
    for i, (n, m) in enumerate(lens):
        ok, reason = eng.submit(rng.integers(1, 100, n),
                                SamplingParams(max_new_tokens=m),
                                rid=f"r{i}")
        assert ok, reason


def _ref_stream(i, lens=LENS):
    # sim model: argmax at position p is p+1 -> solo stream == positions
    n, m = lens[i]
    return list(range(n, n + m))


# ---------------------------------------------------------------------------
# health checks: non-finite rows fault ONE request, never the pool
# ---------------------------------------------------------------------------


def test_nonfinite_decode_row_faults_only_offender():
    eng, _ = _sim_engine(
        wrap=lambda ex: fi.NaNLogitsInjector(ex, rows=[(1, 0)]))
    _submit_all(eng)
    s = eng.run_until_idle()
    faulted = [r for r in eng.results.values() if r.finish_reason == "fault"]
    assert len(faulted) == 1
    i = int(faulted[0].rid[1:])
    ref = _ref_stream(i)
    # the partial stream is a bit-exact PREFIX of the solo run
    assert faulted[0].tokens == ref[:len(faulted[0].tokens)]
    assert len(faulted[0].tokens) < len(ref)
    for j, (n, m) in enumerate(LENS):
        if j != i:
            assert eng.results[f"r{j}"].tokens == _ref_stream(j)
            assert eng.results[f"r{j}"].finish_reason == "length"
    assert s["faults"]["nonfinite_rows"] == 1
    assert s["faults"]["faulted"] == 1
    assert s["faults"]["quarantined_slots"] == 0  # single strike only
    assert eng.quarantined == {}


def test_nonfinite_prefill_row_faults_without_slot_strike():
    eng, _ = _sim_engine(
        wrap=lambda ex: fi.NaNLogitsInjector(ex, prefill_calls=[0]))
    _submit_all(eng)
    s = eng.run_until_idle()
    assert eng.results["r0"].finish_reason == "fault"
    assert eng.results["r0"].tokens == []  # died before its first token
    for j in range(1, len(LENS)):
        assert eng.results[f"r{j}"].tokens == _ref_stream(j)
    # prefill rows run in the scratch cache: no pool-slot quarantine strike
    assert s["faults"]["quarantined_slots"] == 0 and eng.quarantined == {}


def test_persistent_nonfinite_slot_is_quarantined():
    eng, _ = _sim_engine(
        wrap=lambda ex: fi.NaNLogitsInjector(ex, persist_slots=[0]))
    _submit_all(eng)
    s = eng.run_until_idle()
    assert list(eng.quarantined) == [0]
    assert eng.healthy_slots == 2
    faulted = sorted(r.rid for r in eng.results.values()
                     if r.finish_reason == "fault")
    # quarantine_after=2 consecutive bad requests sacrifice on slot 0
    assert len(faulted) == 2
    assert s["faults"]["quarantined_slots"] == 1
    assert s["faults"]["faulted"] == 2
    ok = [r for r in eng.results.values() if r.finish_reason == "length"]
    assert len(ok) == len(LENS) - 2  # everything else finished on slots 1-2
    for r in ok:
        assert r.tokens == _ref_stream(int(r.rid[1:]))


def test_all_slots_quarantined_raises_engine_stuck():
    pol = FaultPolicy(quarantine_after=1, stuck_after=5)
    eng, _ = _sim_engine(
        n_slots=2, faults=pol,
        wrap=lambda ex: fi.NaNLogitsInjector(ex, persist_slots=[0, 1]))
    _submit_all(eng, LENS[:4])
    with pytest.raises(EngineStuck) as ei:
        eng.run_until_idle()
    diag = ei.value.diagnostics
    assert diag["queue_depth"] == 2  # two requests can never be served
    assert sorted(diag["quarantined"]) == [0, 1]
    assert diag["free_slots"] == [] and diag["slots"] == {}


def test_stuck_on_max_steps_with_work_remaining():
    eng, _ = _sim_engine()
    _submit_all(eng, LENS[:2])
    with pytest.raises(EngineStuck):
        eng.run_until_idle(max_steps=1)


# ---------------------------------------------------------------------------
# executor fault recovery: retry (transient) / rebuild + replay (persistent)
# ---------------------------------------------------------------------------


def _clean_streams():
    eng, _ = _sim_engine()
    _submit_all(eng)
    eng.run_until_idle()
    return {rid: r.tokens for rid, r in eng.results.items()}


def test_transient_decode_failure_absorbed_by_retry():
    pol = FaultPolicy(executor_retries=2, retry_backoff_s=0.01)
    eng, _ = _sim_engine(
        faults=pol, wrap=lambda ex: fi.flaky_executor(ex, "decode", 2))
    _submit_all(eng)
    s = eng.run_until_idle()
    assert {rid: r.tokens for rid, r in eng.results.items()} \
        == _clean_streams()
    assert s["faults"]["executor_retries"] == 2
    assert s["faults"]["executor_rebuilds"] == 0
    assert s["faults"]["replayed"] == 0


def test_persistent_crash_rebuilds_and_replays_losslessly():
    clk = SimClock()

    def make_clean():
        return SimExecutor(clk, n_slots=3, max_len=64, chunk=8, vocab=1000)

    pol = FaultPolicy(executor_retries=1, retry_backoff_s=0.0)
    crashed = fi.crashing_executor(make_clean(), "decode", at_call=3)
    eng = ServeEngine(crashed, Scheduler(max_len=64), clock=clk.now,
                      faults=pol, executor_factory=make_clean,
                      sleep=clk.advance)
    _submit_all(eng)
    s = eng.run_until_idle()
    # every stream survives the crash bit-identically: replay re-prefilled
    # prompt + emitted tokens into the fresh executor
    assert {rid: r.tokens for rid, r in eng.results.items()} \
        == _clean_streams()
    assert s["faults"]["executor_rebuilds"] == 1
    assert s["faults"]["replayed"] >= 1
    assert all(r.finish_reason == "length" for r in eng.results.values())


def test_crash_during_prefill_restarts_prompt():
    clk = SimClock()

    def make_clean():
        return SimExecutor(clk, n_slots=2, max_len=64, chunk=4, vocab=1000)

    pol = FaultPolicy(executor_retries=1, retry_backoff_s=0.0)
    # prompt 9 needs 3 chunks at chunk=4; the second chunk call crashes
    crashed = fi.crashing_executor(make_clean(), "prefill_chunk", at_call=1)
    eng = ServeEngine(crashed, Scheduler(max_len=64), clock=clk.now,
                      faults=pol, executor_factory=make_clean,
                      sleep=clk.advance)
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(1, 100, 9), SamplingParams(max_new_tokens=5),
               rid="r0")
    s = eng.run_until_idle()
    assert eng.results["r0"].tokens == list(range(9, 14))
    assert s["faults"]["executor_rebuilds"] == 1


def test_rebuild_budget_exhausted_aborts():
    clk = SimClock()

    def make_crashed():
        return fi.crashing_executor(
            SimExecutor(clk, n_slots=2, max_len=64, chunk=8, vocab=1000),
            "decode", at_call=0)

    pol = FaultPolicy(executor_retries=1, retry_backoff_s=0.0,
                      max_rebuilds=2)
    eng = ServeEngine(make_crashed(), Scheduler(max_len=64), clock=clk.now,
                      faults=pol, executor_factory=make_crashed,
                      sleep=clk.advance)
    _submit_all(eng, LENS[:2])
    with pytest.raises(EngineAbort):
        eng.run_until_idle()
    assert eng.metrics.faults["executor_rebuilds"] == 2


def test_no_factory_aborts_after_retries():
    pol = FaultPolicy(executor_retries=1, retry_backoff_s=0.0)
    eng, _ = _sim_engine(
        faults=pol, wrap=lambda ex: fi.crashing_executor(ex, "decode", 0))
    _submit_all(eng, LENS[:1])
    with pytest.raises(EngineAbort):
        eng.run_until_idle()


# ---------------------------------------------------------------------------
# deadlines + cancel
# ---------------------------------------------------------------------------


def test_inflight_deadline_cuts_partial():
    eng, _ = _sim_engine(n_slots=1)
    rng = np.random.default_rng(0)
    # ~4e-3 s/decode in SimCost: a 0.05 s deadline lands mid-generation
    eng.submit(rng.integers(1, 100, 5), SamplingParams(max_new_tokens=20),
               rid="tight", deadline_s=0.05)
    s = eng.run_until_idle()
    r = eng.results["tight"]
    assert r.finish_reason == "deadline"
    assert 1 <= len(r.tokens) < 20
    assert r.tokens == list(range(5, 5 + len(r.tokens)))  # prefix intact
    assert s["faults"]["deadline"] == 1


def test_queued_deadline_shed_at_admission():
    eng, _ = _sim_engine(n_slots=1)
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(1, 100, 10), SamplingParams(max_new_tokens=20),
               rid="busy")
    eng.submit(rng.integers(1, 100, 5), SamplingParams(max_new_tokens=4),
               rid="late", deadline_s=0.01)
    s = eng.run_until_idle()
    assert eng.results["busy"].finish_reason == "length"
    assert "late" not in eng.results  # never held a slot
    assert eng.metrics.records["late"].finish_reason == "deadline"
    assert s["faults"]["deadline"] == 1 and s["faults"]["shed_queued"] == 1


def test_nonpositive_deadline_rejected_at_submit():
    eng, _ = _sim_engine()
    assert eng.submit(np.arange(1, 5), SamplingParams(),
                      deadline_s=0.0) == (False, "deadline")
    assert eng.metrics.summary()["requests"]["rejected"] == 1


def test_clock_jump_triggers_deadline_shedding():
    clk = SimClock()
    ex = SimExecutor(clk, n_slots=1, max_len=64, chunk=8, vocab=1000)
    jumpy = fi.ClockJumper(clk.now, at_time=0.02, jump_s=1000.0)
    eng = ServeEngine(ex, Scheduler(max_len=64), clock=jumpy,
                      sleep=clk.advance)
    rng = np.random.default_rng(0)
    eng.submit(rng.integers(1, 100, 5), SamplingParams(max_new_tokens=20),
               rid="a", deadline_s=5.0)
    eng.submit(rng.integers(1, 100, 5), SamplingParams(max_new_tokens=4),
               rid="b", deadline_s=5.0)
    eng.run_until_idle()
    # the 1000 s skew blows both deadlines: in-flight cut, queued shed
    assert eng.results["a"].finish_reason == "deadline"
    assert eng.metrics.records["b"].finish_reason == "deadline"


def test_cancel_queued_and_inflight():
    eng, _ = _sim_engine(n_slots=1)
    _submit_all(eng, LENS[:3])
    for _ in range(3):
        eng.step()  # r0 in flight, r1/r2 queued
    assert eng.cancel("r2")       # queued: shed, no result
    assert eng.cancel("r0")       # in-flight: partial result
    assert not eng.cancel("nope")
    s = eng.run_until_idle()
    assert eng.results["r0"].finish_reason == "cancelled"
    assert eng.results["r0"].tokens == \
        _ref_stream(0)[:len(eng.results["r0"].tokens)]
    assert "r2" not in eng.results
    assert eng.metrics.records["r2"].finish_reason == "cancelled"
    assert eng.results["r1"].tokens == _ref_stream(1)  # untouched
    assert s["faults"]["cancelled"] == 2 and s["faults"]["shed_queued"] == 1
    assert not eng.cancel("r0")   # already finished


# ---------------------------------------------------------------------------
# graceful drain + preemption guard
# ---------------------------------------------------------------------------


def test_drain_finishes_inflight_and_sheds_queue():
    eng, _ = _sim_engine(n_slots=1)
    _submit_all(eng, LENS[:3])
    for _ in range(3):
        eng.step()
    s = eng.drain(timeout_s=60.0)  # generous: in-flight finishes naturally
    assert eng.results["r0"].finish_reason == "length"
    assert eng.results["r0"].tokens == _ref_stream(0)
    for rid in ("r1", "r2"):  # queued: shed, recorded, never admitted
        assert rid not in eng.results
        assert eng.metrics.records[rid].finish_reason == "drained"
    assert s["faults"]["drained"] == 2 and s["faults"]["shed_queued"] == 2
    assert eng.submit(np.arange(1, 4), SamplingParams()) \
        == (False, "draining")


def test_drain_timeout_cuts_partial_results():
    eng, _ = _sim_engine(n_slots=2)
    _submit_all(eng, LENS[:2])
    for _ in range(4):
        eng.step()
    s = eng.drain(timeout_s=0.0)
    for i in range(2):
        r = eng.results[f"r{i}"]
        assert r.finish_reason == "drained"
        assert r.tokens == _ref_stream(i)[:len(r.tokens)]  # prefix intact
    assert s["faults"]["drained"] == 2
    assert not eng.has_work  # nothing silently lost or left behind


def test_sigterm_guard_triggers_drain():
    from repro_torch.train.fault_tolerance import PreemptionGuard
    guard = PreemptionGuard()
    try:
        eng, _ = _sim_engine(
            n_slots=1, guard=guard,
            faults=FaultPolicy(drain_timeout_s=0.0),
            wrap=lambda ex: fi.sigterm_executor(ex, "decode", at_call=2))
        _submit_all(eng, LENS[:3])
        s = eng.run_until_idle()
        assert guard.requested
        r0 = eng.results["r0"]
        assert r0.finish_reason == "drained"
        assert r0.tokens == _ref_stream(0)[:len(r0.tokens)]
        # accounted end to end: 1 drained in-flight + 2 shed from the queue
        assert s["faults"]["drained"] == 3 and s["faults"]["shed_queued"] == 2
        assert s["requests"]["finished"] == 1
    finally:
        guard.restore_handlers()


# ---------------------------------------------------------------------------
# fault-free pass-through: the armed sentinel changes nothing
# ---------------------------------------------------------------------------


def test_sentinel_is_pass_through_when_healthy():
    def run(faults):
        eng, _ = _sim_engine(faults=faults)
        _submit_all(eng)
        s = eng.run_until_idle()
        return s, {rid: r.tokens for rid, r in eng.results.items()}

    armed, streams_a = run(FaultPolicy())
    off, streams_b = run(FaultPolicy(nonfinite_fault=False))
    assert streams_a == streams_b
    assert armed == off  # identical timings, occupancy, zeroed faults
    assert all(v == 0 for v in armed["faults"].values())


# ---------------------------------------------------------------------------
# real-model chaos e2e, on the torch ModelExecutor
# ---------------------------------------------------------------------------

from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.policy import QuantConfig, get_preset  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

MAX_LEN = 40
PROMPTS = [(5, 4), (13, 6), (3, 5), (9, 4)]  # (prompt_len, max_new)
ARCHS = ["gemma2-2b", "granite-moe-1b-a400m"]


def _cfg_qcfg(arch, kv_bits, fused):
    """Reduced gemma2-2b (the reference's fixture: w8, fp activations) or
    reduced granite-moe (w3a3's 3-bit packed experts and 8-bit router, fp
    activations) at a capacity without drops."""
    cfg = reduced_config(get_config(arch))
    if cfg.n_experts:
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.moe_top_k)
        qcfg = get_preset("w3a3").replace(a_bits=32)
    else:
        qcfg = QuantConfig(w_bits=8, a_bits=32, mode="mdq")
    return cfg, qcfg.replace(kv_cache_bits=kv_bits, fused_matmul=fused,
                             fused_attention=fused)


def _setup(arch, kv_bits, fused="off"):
    """Random serving weights and each request's single-request
    greedy_generate stream: the bit-identical baseline every non-faulted
    engine stream must match even under chaos."""
    cfg, qcfg = _cfg_qcfg(arch, kv_bits, fused)
    params = M.init_serving_params(cfg, qcfg, torch.Generator().manual_seed(0),
                                   "cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 250, n).astype(np.int32) for n, _ in PROMPTS]
    step = lambda p, c, b: M.prefill_step(p, c, b, cfg, qcfg)
    refs = []
    for prompt, (_, max_new) in zip(prompts, PROMPTS):
        cache = M.init_cache(cfg, qcfg, 1, MAX_LEN, "cpu")
        toks, _ = greedy_generate(step, params, cache,
                                  torch.from_numpy(prompt)[None], max_new)
        refs.append([int(t) for t in toks[0]])
    return cfg, qcfg, params, prompts, refs


def _submit_prompts(eng, prompts):
    for i, prompt in enumerate(prompts):
        ok, reason = eng.submit(
            prompt, SamplingParams(max_new_tokens=PROMPTS[i][1]),
            rid=f"r{i}")
        assert ok, reason


# (arch, route): the MoE model runs on the unfused route only. On the kernel
# route a chunked prefill (chunk 6 < prompt 9) is not bit-equal to
# greedy_generate's one-shot prefill (ROADMAP Queue 3: the decode kernel
# rounds P against each partial's running max), and reduced granite-moe's
# w3a3 logits are flat enough that this flips a token of r3 at fp KV with
# or without a fault; its kernel route holds streams with a one-chunk
# prefill (tests/test_torch_moe_serving.py).
CHAOS_ROUTES = [("gemma2-2b", "off"), ("gemma2-2b", "auto"),
                ("granite-moe-1b-a400m", "off")]


@pytest.mark.parametrize("arch,fused", CHAOS_ROUTES,
                         ids=["gemma2-off", "gemma2-kernel", "moe-off"])
@pytest.mark.parametrize("kv_bits", [0, 8, 4], ids=["fp", "int8", "int4"])
def test_chaos_nan_and_crash_streams_bit_identical(kv_bits, arch, fused):
    """The acceptance scenario: a NaN logits row at (decode call 1, slot 0)
    AND a persistently crashing executor at decode call 4: the engine must
    fault exactly one request (its partial stream a bit-exact reference
    prefix), rebuild a fresh torch ModelExecutor and replay through the
    crash (re-prefilling prompt + emitted tokens into scratch caches cloned
    from its template), and deliver every other request's stream
    bit-identical to single-request greedy_generate."""
    cfg, qcfg, params, prompts, refs = _setup(arch, kv_bits, fused)

    def make_clean():
        return ModelExecutor(params, cfg, qcfg, n_slots=2, max_len=MAX_LEN,
                             chunk=6)

    chaotic = fi.crashing_executor(
        fi.NaNLogitsInjector(make_clean(), rows=[(1, 0)]),
        "decode", at_call=4)
    eng = ServeEngine(chaotic, Scheduler(max_len=MAX_LEN),
                      faults=FaultPolicy(executor_retries=1,
                                         retry_backoff_s=0.0),
                      executor_factory=make_clean)
    _submit_prompts(eng, prompts)
    s = eng.run_until_idle()

    assert set(eng.results) == {f"r{i}" for i in range(4)}  # none lost
    faulted = [r for r in eng.results.values() if r.finish_reason == "fault"]
    assert len(faulted) == 1
    i = int(faulted[0].rid[1:])
    assert faulted[0].tokens == refs[i][:len(faulted[0].tokens)]
    assert 0 < len(faulted[0].tokens) < len(refs[i])
    for j in range(4):
        if j != i:
            assert eng.results[f"r{j}"].tokens == refs[j]
            assert eng.results[f"r{j}"].finish_reason == "length"
    assert s["faults"]["nonfinite_rows"] == 1
    assert s["faults"]["executor_rebuilds"] == 1
    assert s["faults"]["replayed"] >= 1
    assert s["faults"]["quarantined_slots"] == 0  # one strike only
    assert eng.quarantined == {}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_bits", [0, 8], ids=["fp", "int8"])
def test_corrupt_slot_faults_request_then_heals(kv_bits, arch):
    """Corrupt the REAL in-place pool cache of slot 0 mid-flight (NaN K/V
    values, or NaN dequant scales for the int8 cache): detection fires on
    genuine attention-path garbage, only the occupying request faults (row
    independence fences the blast radius; in the MoE model the NaN token is
    routed too and takes capacity no other token needed), and the slot-reset
    template re-insert heals the row: the next request recycled onto slot 0
    must match its reference bit for bit."""
    cfg, qcfg, params, prompts, refs = _setup(arch, kv_bits)
    ex = ModelExecutor(params, cfg, qcfg, n_slots=2, max_len=MAX_LEN, chunk=6)
    eng = ServeEngine(ex, Scheduler(max_len=MAX_LEN))
    _submit_prompts(eng, prompts)
    guard = 0
    while 0 not in eng._generating:  # run until slot 0 is decoding
        eng.step()
        guard += 1
        assert guard < 100, "slot 0 never reached the generating state"
    victim = eng.slots[0].req.rid
    fi.corrupt_slot(ex, 0)
    poisoned = [t for lay in ex.pool["layers"] for t in lay["kv"]
                if t is not None and t.is_floating_point()]
    assert poisoned and all(bool(torch.isnan(t[0]).all()) for t in poisoned)
    assert not any(bool(torch.isnan(t[1]).any()) for t in poisoned)
    eng.run_until_idle()

    r = eng.results[victim]
    v = int(victim[1:])
    assert r.finish_reason == "fault"
    assert r.tokens == refs[v][:len(r.tokens)]
    assert len(r.tokens) < len(refs[v])
    for i in range(4):
        if f"r{i}" != victim:  # incl. later requests recycled onto slot 0
            assert eng.results[f"r{i}"].tokens == refs[i]
            assert eng.results[f"r{i}"].finish_reason == "length"
    assert eng.quarantined == {}  # single strike; the reset healed the row
    assert eng.metrics.faults["nonfinite_rows"] == 1
    assert not any(bool(torch.isnan(t).any()) for lay in ex.pool["layers"]
                   for t in lay["kv"] if t is not None and t.is_floating_point())


@pytest.mark.parametrize("arch", ARCHS)
def test_sigterm_mid_serve_drains_with_partial_prefixes(arch):
    """SIGTERM mid-run on the model: run_until_idle hands off to the
    graceful drain: finished requests match their references, cut requests
    keep bit-exact partial prefixes, queued requests are shed and recorded.
    No rid is silently lost."""
    from repro_torch.train.fault_tolerance import PreemptionGuard

    cfg, qcfg, params, prompts, refs = _setup(arch, 0)
    guard = PreemptionGuard()
    try:
        ex = fi.sigterm_executor(
            ModelExecutor(params, cfg, qcfg, n_slots=2, max_len=MAX_LEN,
                          chunk=6),
            "decode", at_call=2)
        eng = ServeEngine(ex, Scheduler(max_len=MAX_LEN), guard=guard,
                          faults=FaultPolicy(drain_timeout_s=0.0))
        _submit_prompts(eng, prompts)
        s = eng.run_until_idle()
        assert guard.requested
        accounted = set()
        for i in range(4):
            rid = f"r{i}"
            if rid in eng.results:
                r = eng.results[rid]
                assert r.tokens == refs[i][:len(r.tokens)]
                assert r.finish_reason in ("length", "drained")
            else:  # never held a slot: shed from the queue, still recorded
                assert eng.metrics.records[rid].finish_reason == "drained"
            accounted.add(rid)
        assert accounted == {f"r{i}" for i in range(4)}
        assert s["faults"]["drained"] >= 1
    finally:
        guard.restore_handlers()


def test_serving_bench_smoke_passes_every_gate(capsys):
    """The port's twin of benchmarks/serving_bench.py --smoke passes every
    gate: monotone streams, exact replay, continuous batching beats static
    admission, a degraded 3-slot engine equals a 2-slot one."""
    from repro_torch.launch import serving_bench
    assert serving_bench.main(["--smoke"]) == 0
    out = capsys.readouterr().out
    assert "replay exact" in out and "== 2-slot" in out


def test_serving_bench_sweep_equals_the_reference(tmp_path):
    """The twin's sweep is the reference's, number for number (the same
    seeded workload through the same engine and simulation), and the full
    run writes its JSON to --out only."""
    import json

    from benchmarks import serving_bench as ref_bench
    from repro_torch.launch import serving_bench
    kw = dict(n_requests=16, rates=[2.0, 32.0], n_slots=3, max_len=96)
    assert serving_bench.sweep(0, **kw) == ref_bench.sweep(0, **kw)
    out = tmp_path / "sb.json"
    assert serving_bench.main(["--requests", "16", "--rates", "2", "32",
                               "--out", str(out)]) == 0
    assert json.loads(out.read_text())["continuous_beats_static_at_saturation"]
