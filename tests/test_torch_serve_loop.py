"""Step accounting of the port's batched greedy_generate
(`repro_torch.launch.serve`): twin of tests/test_serve_loop.py, case for
case.

The prompt runs as ONE chunked prefill call (tokens (B, prompt_len)), then
`new_tokens - 1` single-token decode calls; the final decode's argmax is
emitted, not discarded. The old token-by-token loop survives here ONLY as
a parity reference: both paths must emit identical tokens on the same step
function.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.serve import greedy_generate  # noqa: E402

_V = 11


def _stub_step(calls):
    """Deterministic stand-in for M.prefill_step: argmax of the logits at
    position p is (p + 1) % _V, so the greedy stream is computable. Records
    each call's (n_tokens, first_pos)."""
    def step(params, cache, b):
        calls.append((int(b["tokens"].shape[1]), int(b["pos"][0, 0])))
        logits = torch.nn.functional.one_hot(((b["pos"] + 1) % _V).long(), _V)
        return logits.to(torch.float32), cache
    return step


def _legacy_token_loop(step, prompts, new_tokens):
    """The pre-engine reference loop: every prompt token fed one at a time.
    Kept only to pin parity with the batched-prefill path."""
    batch, prompt_len = prompts.shape
    if new_tokens <= 0:
        return torch.zeros((batch, 0), dtype=torch.int32)
    logits = None
    for p in range(prompt_len):
        pos = torch.full((batch, 1), p, dtype=torch.int32)
        logits, _ = step(None, {}, {"tokens": prompts[:, p:p + 1], "pos": pos})
    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    outs = [tok]
    for i in range(new_tokens - 1):
        pos = torch.full((batch, 1), prompt_len + i, dtype=torch.int32)
        logits, _ = step(None, {}, {"tokens": tok, "pos": pos})
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        outs.append(tok)
    return torch.cat(outs, 1)


def test_one_prefill_call_then_single_token_decodes():
    batch, prompt_len, new_tokens = 3, 5, 4
    prompts = torch.zeros((batch, prompt_len), dtype=torch.int32)
    calls = []
    toks, _ = greedy_generate(_stub_step(calls), None, {}, prompts, new_tokens)
    # one (prompt_len)-wide prefill, then new_tokens-1 decodes at 5, 6, 7;
    # the final decode's argmax is EMITTED (the old loop discarded it)
    assert calls == [(prompt_len, 0)] + [(1, prompt_len + i)
                                         for i in range(new_tokens - 1)]
    assert toks.shape == (batch, new_tokens)
    want = [(prompt_len + i) % _V for i in range(new_tokens)]
    assert toks[0].tolist() == want
    assert toks[-1].tolist() == want


def test_batched_prefill_matches_legacy_token_loop():
    prompts = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    new_tokens = 5
    batched, _ = greedy_generate(_stub_step([]), None, {}, prompts, new_tokens)
    legacy = _legacy_token_loop(_stub_step([]), prompts, new_tokens)
    assert batched.tolist() == legacy.tolist()


def test_single_token_needs_no_decode_after_prompt():
    prompts = torch.zeros((2, 3), dtype=torch.int32)
    calls = []
    toks, _ = greedy_generate(_stub_step(calls), None, {}, prompts, 1)
    assert calls == [(3, 0)]  # token comes from the prefill's last logits
    assert toks.shape == (2, 1) and int(toks[0, 0]) == 3 % _V


def test_zero_tokens():
    prompts = torch.zeros((2, 3), dtype=torch.int32)
    calls = []
    toks, _ = greedy_generate(_stub_step(calls), None, {}, prompts, 0)
    assert calls == [] and toks.shape == (2, 0)


def test_empty_prompt_raises():
    """With no prompt token there are no seed logits — a clear assertion up
    front instead of a shape error inside the prefill."""
    prompts = torch.zeros((2, 0), dtype=torch.int32)
    with pytest.raises(AssertionError, match="prompt token"):
        greedy_generate(_stub_step([]), None, {}, prompts, 3)
    # zero requested tokens with an empty prompt is still a no-op, not a crash
    toks, _ = greedy_generate(_stub_step([]), None, {}, prompts, 0)
    assert toks.shape == (2, 0)
