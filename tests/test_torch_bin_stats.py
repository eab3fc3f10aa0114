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
from repro_torch.kernels import ops  # noqa: E402


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


def test_no_launch_on_cpu(rng):
    bs.bin_stats_2d.launches = 0
    bs.bin_stats_2d(torch.zeros((3, 4)), 0.1, q_n=2, q_p=1)
    assert bs.bin_stats_2d.launches == 0
    assert ops.launch_counts()["bin_stats_2d"] == 0
