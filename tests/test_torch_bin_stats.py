"""Port parity: `repro_torch.kernels.ops.bin_stats` (the plain version of
csrc/bin_stats.cu on CPU tensors) against the JAX package's Pallas kernel
in interpret mode (the sweep of tests/test_kernels.py), and against the
port's own OBR moments."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.quantizer import QuantSpec as JSpec  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.obr import per_bin_moments  # noqa: E402
from repro_torch.core.quantizer import QuantSpec, quantize_int  # noqa: E402
from repro_torch.kernels import bin_stats as bs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


def _abs_sums(w: np.ndarray, scale: float, spec) -> np.ndarray:
    """(2, n_bins) f64 sums of |w| and w * w over each bin: the scale of
    each bin's rounding error."""
    w64 = w.reshape(-1).astype(np.float64)
    s = np.float32(max(scale, 1e-9))
    codes = (np.clip(np.round(w.reshape(-1) / s), -spec.q_n, spec.q_p)
             .astype(np.int64) + spec.q_n)
    n_bins = spec.q_n + spec.q_p + 1
    return np.stack([np.bincount(codes, np.abs(w64), n_bins),
                     np.bincount(codes, w64 * w64, n_bins)])


def _check(got: torch.Tensor, want: np.ndarray, w: np.ndarray, scale, spec):
    g = got.numpy()
    assert g.shape == (3, spec.q_n + spec.q_p + 1) and got.dtype == torch.float32
    assert np.array_equal(g[0], want[0])                    # counts exact
    assert g[0].astype(np.float64).sum() == w.size          # and all there
    bar = 1e-5 * _abs_sums(w, scale, spec)
    assert np.all(np.abs(g[1:].astype(np.float64) - want[1:]) <= bar)


@pytest.mark.parametrize("shape", [(100, 33), (1000, 33), (513, 7), (64, 64)])
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_bin_stats_sweep(rng, shape, bits):
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    want = np.asarray(jops.bin_stats(jnp.asarray(w), 0.1, JSpec(bits=bits),
                                     interpret=True))
    got = ops.bin_stats(torch.from_numpy(w), 0.1, QuantSpec(bits=bits))
    _check(got, want, w, 0.1, QuantSpec(bits=bits))


@pytest.mark.parametrize("rows", [511, 1025, 1537])
def test_bin_stats_masked_edge_equals_padded_reference(rng, rows):
    """The reference pads rows to 512 with zeros and takes their count back
    out of bin Q_N; the port masks: the same values at row counts that are
    not a multiple of 512, the zero bin included."""
    spec = QuantSpec(bits=4)
    w = (rng.standard_normal((rows, 24)) * 0.2).astype(np.float32)
    w[::7, 3] = 0.0  # real zeros in bin Q_N beside the padded ones
    want = np.asarray(jops.bin_stats(jnp.asarray(w), 0.05, JSpec(bits=4),
                                     interpret=True))
    got = ops.bin_stats(torch.from_numpy(w), 0.05, spec)
    _check(got, want, w, 0.05, spec)
    assert got[0, spec.q_n] >= (rows + 6) // 7


@pytest.mark.parametrize("shape", [(700,), (3, 50, 17)])
def test_bin_stats_any_rank(rng, shape):
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    want = np.asarray(jops.bin_stats(jnp.asarray(w), 0.08, JSpec(bits=3),
                                     interpret=True))
    got = ops.bin_stats(torch.from_numpy(w), 0.08, QuantSpec(bits=3))
    _check(got, want, w, 0.08, QuantSpec(bits=3))


@pytest.mark.parametrize("bits", [2, 3, 8])
def test_bin_stats_matches_obr_moments(rng, bits):
    """The kernel's histogram agrees with the port's OBR within-bin
    moments (masked reductions): counts equal, sums to the bar."""
    spec = QuantSpec(bits=bits)
    w = torch.from_numpy((rng.standard_normal((128, 16)) * 0.2).astype(np.float32))
    s = torch.tensor(0.08)
    got = ops.bin_stats(w, s, spec)
    count, s1, s2 = per_bin_moments(w, quantize_int(w, s, spec), (), spec)
    assert torch.equal(got[0], count)
    bar = 1e-5 * torch.from_numpy(_abs_sums(w.numpy(), 0.08, spec)).float()
    assert torch.all((got[1] - s1).abs() <= bar[0] + 1e-12)
    assert torch.all((got[2] - s2).abs() <= bar[1] + 1e-12)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 4096 * 528 + 1,
                               4096 * 14336, 4096 * 1024 + 3])
def test_grid_covers_every_element_once(n):
    """The kernel's blocks take fixed ranges of whole tiles: together they
    cover n, and the last block is not empty."""
    blocks, tiles = bs.grid(n)
    span = tiles * bs.TILE
    assert blocks * span >= n > (blocks - 1) * span
    assert blocks <= bs.BLOCKS_TARGET
    # within a tile, thread t takes float4s u * THREADS + t (u < TILE / (4
    # THREADS)): every element of the tile once, a warp's 32 lanes on 32
    # neighbouring float4s
    u = np.arange(bs.TILE // (4 * bs.THREADS))[:, None, None]
    t = np.arange(bs.THREADS)[None, :, None]
    off = 4 * (u * bs.THREADS + t) + np.arange(4)[None, None, :]
    assert np.array_equal(np.sort(off.ravel()), np.arange(bs.TILE))
    assert np.all(np.diff(off[:, :32, 0], axis=1) == 4)


def test_no_launch_on_cpu(rng):
    bs.bin_stats_2d.launches = 0
    bs.bin_stats_2d(torch.zeros((3, 4)), 0.1, q_n=2, q_p=1)
    assert bs.bin_stats_2d.launches == 0
    assert ops.launch_counts()["bin_stats_2d"] == 0


def _kernel_codes(w: torch.Tensor, s: float, q_n: int, q_p: int) -> torch.Tensor:
    """Each element's bin as csrc/bin_stats.cu computes it: q = clip(w *
    RN(1 / s)) rounded to an integer by adding 1.5 x 2^23 (whose bits give
    it); where q lies within |q| 2^-20 of a half-integer the IEEE quotient
    w / s is taken instead. fmin / fmax, as fminf / fmaxf, send NaN to lo."""
    s32 = torch.tensor(max(s, 1e-9), dtype=torch.float32)
    lo, hi = torch.tensor(-float(q_n)), torch.tensor(float(q_p))
    clip = lambda x: torch.fmin(torch.fmax(x, lo), hi)
    magic = torch.tensor(12582912.0)
    q = clip(w * (1.0 / s32))
    t = q + magic
    near = (0.5 - (q - (t - magic)).abs()) <= q.abs() * 2.0 ** -20
    t = torch.where(near, clip(w / s32) + magic, t)
    return t.view(torch.int32) - 0x4B400000 + q_n, near


@pytest.mark.parametrize("q_n,q_p,s", [(8, 7, 0.05), (128, 127, 3.7e-3), (2, 1, 0.3),
                                       (0, 15, 1e-12), (4, 3, 1.7), (0, 0, 0.1)])
def test_kernel_code_is_the_rule_bit_for_bit(q_n, q_p, s):
    """The kernel's code (product, then the quotient near a half-integer) is
    the plain rule clip(rint(w / s)) + Q_N for every element: Gaussian
    weights, values a few ulps either side of each half-integer times s,
    and inf, NaN, zeros, subnormals and values near the f32 limit."""
    rng = np.random.default_rng(q_n + q_p)
    s32 = np.float32(max(s, 1e-9))
    gauss = (rng.standard_normal(100_000) * s32 * 4).astype(np.float32)
    half = ((np.arange(-q_n - 2, q_p + 3) + np.float32(0.5)) * s32).astype(np.float32)
    near = [half]
    up, down = half, half
    for _ in range(6):
        up = np.nextafter(up, np.float32(np.inf))
        down = np.nextafter(down, np.float32(-np.inf))
        near += [up, down]
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-40, 3.4e38,
                        -3.4e38, 1e20], np.float32)
    w = torch.from_numpy(np.concatenate([gauss, *near, special]))
    got, slow = _kernel_codes(w, s, q_n, q_p)
    lo, hi = torch.tensor(-float(q_n)), torch.tensor(float(q_p))
    want = torch.fmin(torch.fmax(torch.round(w / torch.tensor(s32)), lo), hi)
    assert torch.equal(got, want.to(torch.int32) + q_n)
    finite = torch.isfinite(w)  # and ref.bin_stats_2d's counts, on finite w
    counts = torch.bincount(got[finite].long(), minlength=q_n + q_p + 1).float()
    assert torch.equal(ref.bin_stats_2d(w[finite], s, q_n=q_n, q_p=q_p)[0], counts)
    assert float(slow[:gauss.size].float().mean()) < 1e-4  # the quotient is rare


def _warp_tree(codes: np.ndarray, v: np.ndarray):
    """csrc/bin_stats.cu's warp_add for one step of 32 lanes: the match_any
    groups, and each lane's (sum, sum of squares) of its group after the f64
    tree over aligned lane blocks of 2, 4, 8, 16, 32 (level 0 from the
    partner's f32 value; level k from the lowest group member in the other
    half-block), every lane's shuffle reading the values of the level
    before."""
    lanes = np.arange(32)
    group = np.array([int(np.sum((codes == c).astype(np.int64) << lanes)) for c in codes])
    x = v.astype(np.float64)
    partner = lanes ^ 1
    paired = (group >> partner) & 1 == 1
    s1 = np.where(paired, x + x[partner], x)
    s2 = np.where(paired, x * x + x[partner] * x[partner], x * x)  # fma: x^2 exact
    for k in range(1, 5):
        half = 1 << k
        block = ((1 << half) - 1) << ((lanes ^ half) & ~(half - 1))
        other = group & block
        src = np.array([(int(o) & -int(o)).bit_length() - 1 if o else l
                        for l, o in zip(lanes, other)])
        o1, o2 = s1[src], s2[src]
        s1 = np.where(other != 0, s1 + o1, s1)
        s2 = np.where(other != 0, s2 + o2, s2)
    return group, s1, s2


@pytest.mark.parametrize("n_bins", [1, 3, 4, 16, 256])
def test_warp_tree_gives_each_group_its_sum(n_bins):
    """Every member of a group of equal codes ends the tree with the same
    bits (so whichever lane leads, the bins get one value), and that value
    is the group's sum and sum of squares (each member once) to f64
    rounding."""
    rng = np.random.default_rng(n_bins)
    for trial in range(300):
        codes = rng.integers(0, int(rng.integers(1, n_bins + 1)), 32)
        codes[rng.random(32) < 0.1] = n_bins  # lanes past the end
        v = (rng.standard_normal(32) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
        group, s1, s2 = _warp_tree(codes, v)
        x = v.astype(np.float64)
        for c in np.unique(codes):
            members = codes == c
            assert np.all(group[members] == group[members][0])
            assert len(set(s1[members].tobytes()[i:i + 8] for i in
                           range(0, 8 * int(members.sum()), 8))) == 1
            assert len(set(s2[members].tobytes()[i:i + 8] for i in
                           range(0, 8 * int(members.sum()), 8))) == 1
            mag = np.abs(x[members]).sum()
            assert abs(s1[members][0] - x[members].sum()) <= 1e-15 * mag
            assert abs(s2[members][0] - (x[members] ** 2).sum()) <= 1e-15 * (x[members] ** 2).sum()
