"""The recurrent blocks and the cross-attention sublayer tensor-parallel
(`models.model.layer_tp`'s mixer, sLSTM FFN and cross splits) on gloo ranks
of the CPU, against the whole port block and the JAX package's block on
the same parameters.

tests/_torch_tp_harness.py --recurrent spawns a (1, 2) and then a (1, 4)
mesh once. On each, every case of `BLOCK_CASES` runs on the rank's slices:
the mLSTM on its heads, the sLSTM's FFN on d_ff (its cell whole), the
RG-LRU on its channels and the cross sublayer on heads, at the reduced
widths (d_model 64, 4 heads, lru_width 64, 8 patches), from the JAX
package's init carried over leaf by leaf (`bridge.to_torch`), activation
quantizers calibrated as tests/test_torch_recurrent.py does and the cross
gate at 0.5. Three modes: fp weights at f32, w4a4 MDQ at bf16 unfused (the
JAX package's route on the CPU) and w4a4 on the kernel route (the plain
versions here; the card's route).

Bars:
* Against the whole port block on the same route. The output: at f32
  within 1e-6 of its largest magnitude (the row-parallel m_down / w_out /
  g_out / xo sum their partials over the ranks: summation order only); at
  bf16 the bulk bit-equal (90th percentile 0, a bf16 ulp where the
  reordered f32 sum crosses a rounding boundary) and every gap within 2
  bf16 ulps of the output's largest magnitude. Every gradient, the ranks'
  slices assembled in rank order (a replicated leaf's and the input's the
  same bits on every rank): at f32 within 1e-6 of the leaf's largest
  magnitude; at bf16 w4a4 the tensor-parallel bars of
  tests/test_torch_tp.py, every leaf with axes within 2e-2 relative L2 and
  every 0-d scale within 0.2 of its kind's RMS over the case.
* Against the JAX package's block (route off, XLA's excess precision off):
  tests/test_torch_recurrent.py's bars, 1e-5 of the largest |y| at f32 and
  at bf16 w4a4 90 % of |d| below 1e-3 with a mean below 0.05.
* Serving keeps these blocks whole: the reduced xlstm-350m served on (1, 2)
  (a prefill and 3 decode steps, its embedding and head vocab-parallel)
  gives the one-process logits bit for bit.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(__file__))
import _torch_tp_harness as H  # noqa: E402
from _torch_parity import EXACT_BF16, configs  # noqa: E402
from test_torch_recurrent import _calibrated  # noqa: E402
from repro.core.policy import QuantConfig as JQ  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import recurrent as JR  # noqa: E402
from repro_torch import bridge  # noqa: E402

HARNESS = os.path.join(os.path.dirname(__file__), "_torch_tp_harness.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SUM_BAR, GRAD_BAR, SCALAR_BAR = 1e-6, 2e-2, 0.2
ROUTE_GAP_FACTOR = 2.0  # tests/test_torch_tp.py's allowance
JAX_F32_BAR = 1e-5
SCALES = ("w_scale", "a_scale", "a_offset")
CROSS_GATE = 0.5


def _jax_side(block: str, mode: str):
    """(JAX cfg, JAX qcfg, JAX dtype) of a case, as `H.block_setup`."""
    quant, dtype, route = H.BLOCK_MODES[mode]
    jcfg, _ = configs(H.BLOCK_ARCH[block], dtype)
    jq = JQ(mode="off") if quant == "fp" else JQ(w_bits=4, a_bits=4, mode="mdq",
                                                 fused_matmul="off")
    return jcfg, jq, jnp.float32 if dtype == "float32" else jnp.bfloat16


def _jax_params(block: str, mode: str) -> dict:
    """The JAX package's init of the case's block, one draw per block and
    quantization (the two w4a4 routes run the same parameters)."""
    jcfg, jq, _ = _jax_side(block, mode)
    quant = H.BLOCK_MODES[mode][0]
    key = jax.random.PRNGKey(list(H.BLOCK_ARCH).index(block) * 2 + (quant != "fp"))
    if block == "cross":
        p = JM._attn_init(key, jcfg, jq, cross=True)
        p["xgate"] = jnp.full((), CROSS_GATE, jnp.float32)
    else:
        p = {"mlstm": JR.mlstm_init, "slstm": JR.slstm_init,
             "rglru": JR.rglru_init}[block](key, jcfg, jq)
    return _calibrated(p) if H.BLOCK_MODES[mode][0] != "fp" else p


def _to_torch(node):
    if isinstance(node, dict):
        return {k: _to_torch(v) for k, v in node.items()}
    return bridge.to_torch(np.asarray(node), "cpu")


def _jax_y(block: str, mode: str, p: dict) -> np.ndarray:
    jcfg, jq, jd = _jax_side(block, mode)
    inp = H.block_inputs(block, mode)
    x = jnp.asarray(inp["x"], jd)
    if block == "cross":
        def fn(p, x, e):
            kv = JM.cross_kv(p, e, jcfg, jq, jd)
            return JM._cross_sublayer(p, x, kv, jcfg, jq, jd, lambda t: t)
        args = (p, x, jnp.asarray(inp["embeds"], jd))
    else:
        kw = {"chunk": H.BLOCK_CHUNK} if block == "mlstm" else {}
        blk = {"mlstm": JR.mlstm_block, "slstm": JR.slstm_block,
               "rglru": JR.rglru_block}[block]

        def fn(p, x):
            return blk(p, x, jcfg, jq, jd, **kw)[0]
        args = (p, x)
    y = jax.jit(fn).lower(*args).compile(EXACT_BF16)(*args)
    return np.asarray(y.astype(jnp.float32))


@pytest.fixture(scope="module")
def split_blocks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_recurrent")
    jparams = {case: _jax_params(*case) for case in H.BLOCK_CASES}
    torch.save({case: _to_torch(jax.tree.map(np.asarray, p))
                for case, p in jparams.items()}, out / "blocks.pt")
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, HARNESS, "--recurrent", str(out)], env=env,
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    trees = torch.load(out / "blocks.pt")
    ranks = {m: [torch.load(out / f"rec_m{m}_rank{r}.pt") for r in range(m)]
             for m in H.BLOCK_RANKS}
    return {"ranks": ranks, "trees": trees, "jax": jparams, "wall": wall,
            "serve": torch.load(out / "rec_serve.pt")}


def _model_dim(spec):
    for d, entry in enumerate(spec or ()):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return d
    return None


def _assemble(parts: list, dim) -> torch.Tensor:
    """The ranks' slices along `dim` in rank order; a replicated tensor
    (dim None) must be the same bits on every rank."""
    if dim is None:
        for p in parts[1:]:
            assert torch.equal(p, parts[0])
        return parts[0]
    return torch.cat(parts, dim)


def _other_route(mode: str) -> str:
    """The w4a4 mode of the other fused route (same parameters)."""
    return {"w4a4": "w4a4_kernel", "w4a4_kernel": "w4a4"}[mode]


@pytest.mark.parametrize("ranks", H.BLOCK_RANKS)
@pytest.mark.parametrize("block,mode", H.BLOCK_CASES)
def test_split_block_matches_whole_and_jax(split_blocks, block, mode, ranks):
    res = [r[(block, mode)] for r in split_blocks["ranks"][ranks]]
    tree = split_blocks["trees"][(block, mode)]
    whole = H.run_block(block, mode, tree)
    f32 = H.BLOCK_MODES[mode][1] == "float32"
    # the output, whole on every rank
    y = _assemble([r["y"] for r in res], None)
    want = whole["y"]
    d = (y - want).abs()
    if f32:
        assert float(d.max()) <= SUM_BAR * float(want.abs().max()), float(d.max())
    else:
        assert float(d.quantile(0.9)) < 1e-3 and float(d.mean()) < 0.05, (
            float(d.quantile(0.9)), float(d.mean()))
    # against the JAX package's block, on its route
    if H.BLOCK_MODES[mode][2] == "off" or f32:
        j = _jax_y(block, mode, split_blocks["jax"][(block, mode)])
        dj = np.abs(y.numpy() - j)
        if f32:
            assert dj.max() <= JAX_F32_BAR * np.abs(j).max(), (dj.max(), np.abs(j).max())
        else:
            assert np.quantile(dj, 0.9) < 1e-3 and dj.mean() < 0.05, (
                np.quantile(dj, 0.9), dj.mean())
    # the gradients, assembled
    specs = res[0]["specs"]
    dx = _assemble([r["dx"] for r in res], None)
    assert set(res[0]["grads"]) == set(whole["grads"])
    items = [("dx", dx, whole["dx"])]
    split = 0
    for key, w in whole["grads"].items():
        dim = _model_dim(specs.get(key))
        split += dim is not None
        items.append((key, _assemble([r["grads"][key] for r in res], dim), w))
    assert split >= len(H.block_names(block))  # every split linear's weight
    if f32:
        mag = max(float(w.abs().max()) for _, _, w in items)
        for key, g, w in items:
            assert g.shape == w.shape and torch.isfinite(g).all(), key
            err = float((g - w).abs().max())
            assert err <= SUM_BAR * mag, (key, err, mag)
        return
    other = H.run_block(block, _other_route(mode), tree)
    route = {"dx": other["dx"], **other["grads"]}
    kinds: dict = {}
    for key, g, w in items:
        assert g.shape == w.shape and torch.isfinite(g).all(), key
        if key.split("/")[-1] in SCALES and g.dim() == 0:
            kinds.setdefault(key.split("/")[-1], []).append((key, float(g), float(w)))
            continue
        norm = max(float(w.norm()), 1e-30)
        rel = float((g - w).norm()) / norm
        gap = float((route[key] - w).norm()) / norm
        assert rel < max(GRAD_BAR, ROUTE_GAP_FACTOR * gap), (key, rel, gap)
    assert kinds
    for kind, leaves in kinds.items():
        rms = float(np.sqrt(np.mean([w * w for _, _, w in leaves])))
        worst = max((abs(g - w) / rms, key) for key, g, w in leaves)
        assert worst[0] < SCALAR_BAR, (kind, worst)


def test_serving_keeps_recurrent_blocks_whole(split_blocks):
    """Sharded prefill_step / decode_step of the reduced xlstm-350m on
    (1, 2): no mixer, sLSTM FFN or cross split in serving, and the logits
    equal one process's bit for bit."""
    srv = split_blocks["serve"]
    assert srv["head_tp"]
    assert not any(any(lt) for lt in srv["split"])
    assert torch.isfinite(srv["one"]).all()
    assert torch.equal(srv["sharded"], srv["one"])


def test_recurrent_harness_wall_time(split_blocks):
    assert split_blocks["wall"] <= 60.0, split_blocks["wall"]
