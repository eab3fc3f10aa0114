"""OBR (Eq. 10) and the oscillation fraction on each rank's slices
(`train.train_step.obr_` / `osc_fractions` over `dist.spmd.Spmd.leaf_sums`),
on gloo ranks of the CPU, against the JAX package on seeded numpy inputs.

tests/_torch_ep_harness.py --obr runs 4 ranks in a subprocess, on a (2, 2)
and a (1, 4) mesh, over the leaves of its OBR_CASES: a 0-d-scale FSDP +
TP column weight (w_in), a per-head-scale wq (heads on model, d on data),
a per-expert-scale moe_in under expert parallelism, a 3-expert moe_in
with its d_ff split (its per-expert scale spans the ranks), the embedding
(vocab on model; its oscillation state split over data too) and a router
that nothing splits. The test runs the JAX package's functions on the
same inputs meanwhile and holds:

* each leaf's Eq. 10 value within 1e-6 relative of
  `repro.core.obr.obr_loss`, and the sum over the leaves within 1e-6 of
  theirs: the slices' sums are added in another order;
* the gradient assembled from the ranks' slices within 1e-6 of max|g| of
  `jax.grad` of that function (replicas bit-equal);
* each state's oscillating fraction equal to
  `repro.core.oscillation.oscillation_fraction` exactly (integer counts);
* each state's Eq. 12 update on its slice (the embedding's cut from its
  weight slice, `Spmd.osc_view`) equal to the JAX package's update of the
  whole state, sliced;
* the bytes the ranks moved: "obr" and "oscillation" equal the sums'
  formula to the byte (no leaf or EMA gathered).

On one process (a world of one, no group) the same code is held bit for
bit to autograd through `obr_loss`, and `oscillation_fraction` to the f32
mean of the mask where that is exact, and to the exact count above 2^24
elements, where it is not.
"""
import math
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))
import _torch_ep_harness as H  # noqa: E402

HARNESS = os.path.join(os.path.dirname(__file__), "_torch_ep_harness.py")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SUM_BAR = 1e-6  # f32, summation order only
MESHES = {"2x2": {"data": 2, "model": 2}, "1x4": {"data": 1, "model": 4}}


def _jax_side() -> dict:
    """case -> the JAX package's Eq. 10 value and gradient (every case in
    one jit: op by op, XLA compiles each level's ops for each shape), Eq. 12
    update (eager, as the port's parity tests take it; element-wise, so
    the cases of a spec go as one vector) and oscillating fraction on the
    whole leaf."""
    import jax
    import jax.numpy as jnp
    from repro.core import obr as JO
    from repro.core import oscillation as JOsc
    from repro.core.policy import get_preset as j_preset
    from repro.core.policy import weight_spec as j_weight_spec
    from repro_torch.models.common import kind_of
    jq = j_preset("w3a3").replace(track_oscillation=True, edge_bits=4, router_bits=4)
    inp = {c: {k: jnp.asarray(v) for k, v in d.items()} for c, d in H.obr_inputs().items()}
    specs = {c: j_weight_spec(jq, kind_of(H.OBR_CASES[c][0])) for c in inp}
    obr = jax.jit(lambda ws, ss: {c: jax.value_and_grad(
        lambda w: JO.obr_loss(w, ss[c], specs[c]))(ws[c]) for c in ws})(
        {c: d["w"] for c, d in inp.items()}, {c: d["s"] for c, d in inp.items()})
    states = {c: JOsc.OscState(d["prev_int"], d["prev_dir"], d["freq"])
              for c, d in inp.items()}
    new = {}
    for spec in set(specs.values()):  # element-wise: each spec's cases as one vector
        cases = [c for c in inp if specs[c] == spec]
        flat = [jnp.concatenate([jnp.broadcast_to(x, inp[c]["w"].shape).reshape(-1)
                                 for c, x in zip(cases, xs)])
                for xs in zip(*([*states[c], inp[c]["w2"], inp[c]["s"]] for c in cases))]
        out = JOsc.update_osc_state(JOsc.OscState(*flat[:3]), flat[3], flat[4], spec,
                                    momentum=jq.osc_momentum)
        at = 0
        for c in cases:
            n = inp[c]["w"].size
            new[c] = tuple(np.array(t[at:at + n]).reshape(inp[c]["w"].shape) for t in out)
            at += n
    return {case: {"value": float(obr[case][0]), "grad": np.array(obr[case][1]),
                   "frac": float(JOsc.oscillation_fraction(states[case], H.OSC_THRESHOLD)),
                   "osc": new[case]} for case in inp}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("obr")
    env = dict(os.environ, PYTHONPATH=SRC)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, HARNESS, "--obr", str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    done: dict = {}

    def wait():
        done["err"] = proc.communicate(timeout=120)[1]
        done["wall"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait)
    waiter.start()
    try:
        jax_side = _jax_side()
    finally:
        waiter.join(timeout=150)
        proc.kill()
    assert proc.returncode == 0, done.get("err", "")[-4000:]
    res = [torch.load(out / f"obr_rank{r}.pt") for r in range(4)]
    return {"res": res, "jax": jax_side, "wall": done["wall"]}


def _assemble(parts: list, coords: list, spec: tuple, mesh: dict, shape: tuple):
    """The whole tensor from the ranks' slices by `spec` (replicas must be
    the same bits)."""
    from repro_torch.dist import sharding as shard
    sizes = shard.AxisSizes(tuple(mesh), tuple(mesh.values()))
    out, seen = torch.zeros(shape, dtype=parts[0].dtype), {}
    for t, c in zip(parts, coords):
        idx = [slice(None)] * len(shape)
        for dim, axes, n in shard.split_dims(spec, sizes):
            k = shape[dim] // n
            i = shard.axes_index(axes, sizes, c)
            idx[dim] = slice(i * k, (i + 1) * k)
        key = tuple((s.start, s.stop) for s in idx)
        if key in seen:
            assert torch.equal(seen[key], t)
        seen[key] = t
        out[tuple(idx)] = t
    assert len(seen) == math.prod(n for _, _, n in shard.split_dims(spec, sizes))
    return out


CASES = list(H.OBR_CASES)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_obr_value_matches_jax(ranks, mesh, case):
    want = ranks["jax"][case]["value"]
    for r in ranks["res"]:
        got = r[mesh]["values"][case]
        assert abs(got - want) <= SUM_BAR * abs(want), (got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_obr_total_matches_jax(ranks, mesh):
    want = sum(ranks["jax"][c]["value"] for c in CASES)
    totals = {r[mesh]["total"] for r in ranks["res"]}
    assert len(totals) == 1  # the same decision on every rank
    got = totals.pop()
    assert abs(got - want) <= SUM_BAR * abs(want), (got, want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_obr_grad_matches_jax(ranks, mesh, case):
    res = [r[mesh] for r in ranks["res"]]
    want = torch.from_numpy(ranks["jax"][case]["grad"])
    got = _assemble([r["grads"][case] for r in res], [r["coords"] for r in res],
                    res[0]["wspec"][case], MESHES[mesh], tuple(want.shape))
    err = float((got - want).abs().max())
    assert err <= SUM_BAR * float(want.abs().max()), (err, float(want.abs().max()))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_osc_frac_equals_jax(ranks, mesh, case):
    want = ranks["jax"][case]["frac"]
    for r in ranks["res"]:
        assert r[mesh]["fracs"][case] == want


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_osc_update_equals_jax(ranks, mesh, case):
    """Eq. 12 on each rank's oscillation slice, its weights cut as the
    state is (the embedding's from its weight slice, further along d),
    equals the JAX package's update of the whole state."""
    res = [r[mesh] for r in ranks["res"]]
    for i, want in enumerate(ranks["jax"][case]["osc"]):
        want = torch.from_numpy(want)
        got = _assemble([r["osc"][case][i] for r in res], [r["coords"] for r in res],
                        res[0]["ospec"][case], MESHES[mesh], tuple(want.shape))
        assert torch.equal(got, want), (case, i)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_obr_moves_only_the_sums(ranks, mesh):
    """One read of the fraction and Eq. 10 over every leaf at once: the
    ranks moved their sums (`_torch_ep_harness.stats_bytes`), to the byte,
    and nothing else."""
    from repro_torch.dist import sharding as shard
    params, osc = H.obr_state()
    sizes = shard.AxisSizes(tuple(MESHES[mesh]), tuple(MESHES[mesh].values()))
    specs = shard.state_pspecs({"params": params, "mu": params, "nu": params,
                                "osc": osc, "err": ()}, sizes, H.obr_qcfg())
    want = H.stats_bytes(params, specs, H.obr_qcfg(), sizes)
    assert want["obr"] > 0 and want["oscillation"] > 0
    for r in ranks["res"]:
        assert r[mesh]["moved"] == want, (r[mesh]["moved"], want)


def test_sharded_embedding_state_splits_more_than_its_weight(ranks):
    """The case `Spmd.osc_view` cuts: the embedding's weight on vocab
    only, its oscillation state on vocab and d (the rules' FSDP)."""
    r = ranks["res"][0]["2x2"]
    assert r["wspec"]["embed"] == ("model", None)
    assert r["ospec"]["embed"] == ("model", "data")
    assert r["wspec"]["router"] == (None, None)


def test_obr_harness_wall_time(ranks):
    assert ranks["wall"] <= 30.0, ranks["wall"]


# ---------------------------------------------------------------------------
# one process: the same code, the same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_one_process_obr_is_autograd_of_obr_loss(case):
    """`obr_` on a world of one adds lam x the gradient of `obr_loss` by
    autograd, bit for bit, and returns its value bit for bit."""
    from repro_torch import tree as T
    from repro_torch.core.obr import obr_loss
    from repro_torch.models.model import quant_leaf_paths
    from repro_torch.train.train_step import obr_
    qcfg = H.obr_qcfg()
    params, _ = H.obr_state()
    sub = {case: params[case]}
    ((_, w, s, spec),) = quant_leaf_paths(sub, qcfg)
    wl = w.clone().requires_grad_(True)
    v = obr_loss(wl, s, spec)
    (g,) = torch.autograd.grad(v, wl)
    grads = T.map_tree(lambda t: torch.full_like(t, 0.25), sub)
    lam = torch.tensor(0.5)
    total = obr_(sub, grads, qcfg, lam)
    assert torch.equal(total, v.detach())
    name = H.OBR_CASES[case][0]
    assert torch.equal(grads[case][name]["w"], 0.25 + lam * g)


@pytest.mark.parametrize("n", [1, 7, 384, 1000, 4097])
def test_osc_fraction_is_the_reference_mean_below_2_24(n):
    """Below 2^24 elements the count's fraction is the JAX package's mean
    of the f32 mask bit for bit (the sum times the f32 reciprocal)."""
    import jax.numpy as jnp
    from repro.core import oscillation as JOsc
    from repro_torch.core.oscillation import OscState, oscillation_fraction
    freq = (0.01 * np.random.default_rng(n).random(n)).astype(np.float32)
    got = oscillation_fraction(OscState(None, None, torch.from_numpy(freq)), 0.005)
    assert got.dtype == torch.float32
    want = JOsc.oscillation_fraction(JOsc.OscState(None, None, jnp.asarray(freq)), 0.005)
    assert float(got) == float(want)


def test_osc_fraction_is_exact_above_2_24():
    """2^24 + 3 of 2^24 + 5 weights oscillating: the count's fraction is
    the exact ratio's f32, where the f32 sum of the mask rounds 2^24 + 3 to
    2^24 + 4 and its mean is one ulp off."""
    from repro_torch.core.oscillation import OscState, oscillation_count, oscillation_fraction
    n = 2 ** 24 + 5
    freq = torch.ones(n, dtype=torch.float32)
    freq[:2] = 0.0
    st = OscState(None, None, freq)
    assert int(oscillation_count(st, 0.005)) == n - 2
    got = float(oscillation_fraction(st, 0.005))
    assert got == float(np.float32((n - 2) / n))
    assert float(torch.mean((freq > 0.005).to(torch.float32))) != got
