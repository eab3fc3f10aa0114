"""Vocab-parallel training losses (`core.kd` with the head's `TPSplit`) on
gloo ranks of the CPU, against the JAX package's losses on the whole
logits.

tests/_torch_tp_harness.py --vocab spawns 4 ranks once and runs, on a
(2 data, 2 model) and then a (1, 4) mesh:

* Every loss (hard CE, MCKD's sparse soft-CE at K 4, `mckd_loss` over 2
  views, the soft CE, the teacher soft-CE at temperature 2, with and
  without a mask) on each rank's columns of seeded logits over a padded
  vocab of 64 with -1e9 padding columns (`loss_inputs`): with and without
  a final softcap, and with a vocab of 45 that leaves the (1, 4) mesh's
  last rank only padding. Labels and top-K ids sit on the rank
  boundaries and at the last id, and one row of tokens has its max on
  another rank than its label. Held: each rank's value within 1e-6
  relative of `repro.core.kd`'s, and the ranks' column gradients, put
  side by side, within 1e-6 of max|g| of its `jax.grad` (the sums over
  ranks reorder f32 sums only). The bytes launched under "loss" equal
  rows x 4 B x the f32 values each row all-reduces (`LOSS_VALUES`), and
  no collective runs in the backward.
* A step-0 gradient of the reduced qwen1.5-0.5b (tied head, padded vocab
  272), tensor-parallel, with kd "mckd" and "none": loss_main within
  1e-6 relative of one process's, the tied table's gradient within
  tests/test_torch_tp.py's 2e-2 relative L2, the "loss" bytes equal to
  rows x 3 x 4 B, and no all-gather of (rows, padded vocab) logits.

On one process, `tp=None` keeps every loss the whole-logits code: bit for
bit the composition it was before the vocab-parallel form.
"""
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import _torch_tp_harness as H  # noqa: E402
from test_torch_tp import _harness  # noqa: E402

LOSS_BAR = GRAD_BAR = 1e-6  # f32, summation order only
TABLE_BAR = 2e-2            # tests/test_torch_tp.py's GRAD_BAR
# f32 values a row all-reduces: the max, then the sum of exp and the
# target term (the soft CE adds the sum of the weights; the teacher first
# takes its own max and sum); mckd_loss runs one sparse soft-CE a view
LOSS_VALUES = {"hard": 3, "sparse": 3, "mckd": 2 * 3, "soft": 4, "teacher": 6}
HARNESS_S = 120


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    out = tmp_path_factory.mktemp("vocab")
    t0 = time.perf_counter()
    _harness(["--vocab", str(out)])
    wall = time.perf_counter() - t0
    return [torch.load(out / f"vocab{r}.pt") for r in range(H.VOCAB_RANKS)], wall


def _groups(res: list, m: int) -> list:
    """Each data group's ranks in model order."""
    groups = {}
    for r in res:
        groups.setdefault(r[m]["coords"]["data"], []).append(r)
    return [sorted(g, key=lambda r: r[m]["coords"]["model"]) for _, g in sorted(groups.items())]


def _jax_loss(name: str, x, inp: dict):
    import jax.numpy as jnp
    from repro.core import kd as K
    mask = jnp.asarray(inp["mask"]) if name.endswith("_mask") else None
    kind = name.removesuffix("_mask")
    if kind == "hard":
        return K.hard_ce(x[0], jnp.asarray(inp["labels"]), mask)
    if kind == "sparse":
        return K.sparse_soft_ce(x[0], jnp.asarray(inp["ids"][0]), jnp.asarray(inp["p"][0]),
                                mask)
    if kind == "mckd":
        return K.mckd_loss(x, jnp.asarray(inp["ids"]), jnp.asarray(inp["p"]))
    if kind == "soft":
        return K.soft_ce(x[0], jnp.asarray(inp["probs"]), mask)
    return K.kd_from_teacher_logits(x[0], jnp.asarray(inp["teacher"]), H.LOSS_T, mask)


@pytest.mark.parametrize("loss", H.LOSSES)
@pytest.mark.parametrize("case", list(H.LOSS_CASES))
@pytest.mark.parametrize("m", H.VOCAB_MODELS)
def test_vocab_parallel_loss_matches_jax(vocab, m, case, loss):
    import jax
    import jax.numpy as jnp
    res, _ = vocab
    inp = H.loss_inputs(case)
    v, g = jax.value_and_grad(lambda x: _jax_loss(loss, x, inp))(jnp.asarray(inp["x"]))
    v, g = float(v), np.asarray(g)
    for group in _groups(res, m):
        outs = [r[m]["losses"][case][loss] for r in group]
        for got, _, _ in outs:
            assert abs(got - v) <= LOSS_BAR * abs(v), (got, v)
        full = torch.cat([grad for _, grad, _ in outs], -1).numpy()
        assert full.shape == g.shape
        gap = float(np.abs(full - g).max())
        assert gap <= GRAD_BAR * float(np.abs(g).max()), (gap, float(np.abs(g).max()))


@pytest.mark.parametrize("loss", H.LOSSES)
@pytest.mark.parametrize("m", H.VOCAB_MODELS)
def test_loss_bytes_equal_their_formula(vocab, m, loss):
    res, _ = vocab
    rows = H.LOSS_B * H.LOSS_S
    want = rows * 4 * LOSS_VALUES[loss.removesuffix("_mask")]
    for r in res:
        for case in H.LOSS_CASES:
            assert r[m]["losses"][case][loss][2] == want, (case, r[m]["coords"])


@pytest.mark.parametrize("kd", ["mckd", "none"])
@pytest.mark.parametrize("m", H.VOCAB_MODELS)
def test_step0_matches_one_process(vocab, m, kd):
    """The reduced qwen1.5-0.5b's step 0 with the loss on the rank's
    columns: loss_main and the tied table's gradient against one process,
    the "loss" bytes, and no logits gathered."""
    from repro_torch.configs.registry import get_config, reduced_config
    res, _ = vocab
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    one = res[0]["one"][kd]
    for r in res:
        assert r[m]["head_tp"]
        step = r[m]["step"][kd]
        a, b = step["loss_main"], one["loss_main"]
        assert abs(a - b) <= LOSS_BAR * abs(b), (a, b)
        rel = float((step["table_grad"] - one["table_grad"]).norm()
                    / one["table_grad"].norm())
        assert rel < TABLE_BAR, rel
        assert step["rows"] * 4 // m == one["rows"]
        assert step["by_use"]["loss"] == step["rows"] * 3 * 4
        logits = step["rows"] * cfg.padded_vocab  # a gathered (rows, V)
        assert all(int(np.prod(s)) != logits for s in step["gathers"]), step["gathers"]


def test_vocab_harness_wall_time(vocab):
    _, wall = vocab
    print(f"vocab harness: {wall:.1f} s")
    assert wall < HARNESS_S


# ---------------------------------------------------------------------------
# one process: tp=None is the whole-logits code
# ---------------------------------------------------------------------------

def _whole(name: str, x: torch.Tensor, inp: dict) -> torch.Tensor:
    """The losses as `core.kd` composed them before the `tp` form."""
    def reduce(per_tok, mask):
        if mask is None:
            return torch.mean(per_tok)
        mask = mask.to(per_tok.dtype)
        return torch.sum(per_tok * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def soft(s, probs, mask):
        logp = torch.log_softmax(s.to(torch.float32), dim=-1)
        return reduce(-torch.sum(probs.to(torch.float32) * logp, dim=-1), mask)

    def sparse(s, idx, p, mask=None):
        logp = torch.log_softmax(s.to(torch.float32), dim=-1)
        gathered = torch.gather(logp, -1, idx.to(torch.int64))
        return reduce(-torch.sum(p.to(torch.float32) * gathered, dim=-1), mask)

    mask = inp["mask"] if name.endswith("_mask") else None
    kind = name.removesuffix("_mask")
    if kind == "hard":
        logp = torch.log_softmax(x[0].to(torch.float32), dim=-1)
        ll = torch.gather(logp, -1, inp["labels"].to(torch.int64)[..., None])[..., 0]
        return -reduce(ll, mask)
    if kind == "sparse":
        return sparse(x[0], inp["ids"][0], inp["p"][0], mask)
    if kind == "mckd":
        return torch.mean(torch.stack([sparse(s, i, p) for s, i, p in
                                       zip(x, inp["ids"], inp["p"])]))
    if kind == "soft":
        return soft(x[0], inp["probs"], mask)
    t = H.LOSS_T
    probs = torch.softmax(inp["teacher"].to(torch.float32) / t, dim=-1)
    return soft(x[0] / t, probs, mask) * (t * t)


@pytest.mark.parametrize("loss", H.LOSSES)
def test_one_process_keeps_its_bits(loss):
    inp = {k: torch.from_numpy(v) for k, v in H.loss_inputs("softcap").items()}
    outs = []
    for fn in (lambda x: H.loss_of(loss, x, inp), lambda x: _whole(loss, x, inp)):
        x = inp["x"].clone().requires_grad_(True)
        v = fn(x)
        outs.append((v.detach(), torch.autograd.grad(v, x)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_columns_that_do_not_make_the_vocab_raise():
    """No silent route: a head slice whose columns x the model ranks are
    not the padded vocab, or teacher logits not of the whole vocab,
    raise."""
    from repro_torch.core import kd
    from repro_torch.core.policy import get_preset
    from repro_torch.dist.spmd import TPSplit
    from repro_torch.models.common import lm_head_apply
    tp = TPSplit(None, 0, 3)  # no group: each collective returns its input
    x = torch.randn(1, 2, 8)
    p = {"w": torch.randn(8, 16)}
    with pytest.raises(ValueError, match="padded vocab"):
        lm_head_apply(p, x, get_preset("fp"), 60, 64, tp=tp, gather=False)
    assert lm_head_apply(p, x, get_preset("fp"), 40, 48, tp=tp, gather=False).shape == (1, 2, 16)
    with pytest.raises(ValueError, match="teacher logits"):
        kd.kd_from_teacher_logits(torch.randn(1, 2, 16), torch.randn(1, 2, 64), tp=tp)
