// Per-bin statistics of a per-tensor quantizer: out (3, n_bins) f32 =
// [count, sum, sum of squares] of w over the bins of
// code = clip(rint(w / max(s, 1e-9)), -Q_N, Q_P) + Q_N.
//
// Replaces the TPU kernel bin_stats_2d (src/repro/kernels/bin_stats.py:48,
// body `_bin_stats_kernel` :25), which builds an (elements x bins) one-hot
// per tile and contracts it on the MXU, carrying the sums across its
// sequential grid in VMEM scratch.
//
// What bounds it on an H100: it reads each weight once (4 bytes) and
// writes 3 x n_bins floats, so HBM bandwidth (3.35 TB/s); its few flops an
// element are far from the compute line. The design below does not reach
// that bound for wide codes: it trades speed for a fixed summation order
// (no float atomics, so a run's bits do not depend on scheduling), as the
// QAT kernels of this package do.
//
//   bin_stats_partial_kernel: block b takes a fixed range of elements (the
//     rows of w, flattened), `tiles` tiles of TILE elements. For each tile
//     its 256 threads stage w (f32) and the codes (uint8) in shared memory.
//     The threads are split as n_bins bins x S = 256 / n_bins slices; the
//     thread of (slice j, bin c) scans slice j's 32-bit words of 4 codes
//     (j, j + S, ...) for byte c and, on a match, adds 1, w and w * w to its
//     own accumulators. The accumulators are f64 (count as an int), so
//     the sums are exact to far below an f32 ulp whatever the order; the
//     cost is paid only on a match (once an element). The S slices are
//     then added in slice order into the block's (3, n_bins) f64 partial.
//   bin_stats_finish_kernel: one warp per output value sums the blocks'
//     partials in a fixed order (lane l takes blocks l, l + 32, ..., then a
//     fixed shuffle tree) in f64 and rounds once to f32, so the counts are
//     exact below 2^24 and correctly rounded above, as in the plain version.
//
// The scan costs n_bins byte compares an element (spread over n_bins
// threads), which is cheap at 2-4 bits and the bottleneck at 8 bits (256
// bins); a warp-aggregated (match_any) or sorted design is the next step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int TILE = 4096;            // elements staged per step
constexpr int WORDS = TILE / 4;       // 32-bit words of codes per tile

__device__ __forceinline__ uint32_t code_of(float w, float s, float lo, float hi, int q_n) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(w, s)), lo), hi);
  return static_cast<uint32_t>(static_cast<int>(q) + q_n);
}

// a byte of v is zero (exact as a test of "any"; per-byte flags may be wrong)
__device__ __forceinline__ bool has_zero_byte(uint32_t v) {
  return ((v - 0x01010101u) & ~v & 0x80808080u) != 0u;
}

__global__ void __launch_bounds__(NTHREADS)
bin_stats_partial_kernel(const float* __restrict__ w, const float* __restrict__ scale,
                         double* __restrict__ partial, long long n, int tiles,
                         int q_n, int q_p, int vec) {
  __shared__ __align__(16) float ws[TILE];
  __shared__ __align__(16) uint32_t cs[WORDS];
  __shared__ double red[3][NTHREADS];

  const int n_bins = q_n + q_p + 1;
  const int slices = NTHREADS / n_bins;
  const int tid = threadIdx.x;
  const int bin = tid % n_bins;
  const int slice = tid / n_bins;
  const bool active = slice < slices;
  const uint32_t pattern = static_cast<uint32_t>(bin) * 0x01010101u;
  const float s = fmaxf(*scale, 1e-9f);
  const float lo = -static_cast<float>(q_n), hi = static_cast<float>(q_p);

  long long cnt = 0;
  double s1 = 0.0, s2 = 0.0;
  const long long first = static_cast<long long>(blockIdx.x) * tiles * TILE;
  for (int t = 0; t < tiles; ++t) {
    const long long base = first + static_cast<long long>(t) * TILE;
    if (base >= n) break;
    const int valid = static_cast<int>(n - base < TILE ? n - base : TILE);
    __syncthreads();  // the previous tile's readers are done
    for (int k = tid; k < WORDS; k += NTHREADS) {
      float v[4];
      const long long e = base + 4 * k;
      if (vec && 4 * k + 3 < valid) {
        const float4 t4 = *reinterpret_cast<const float4*>(w + e);
        v[0] = t4.x; v[1] = t4.y; v[2] = t4.z; v[3] = t4.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = (4 * k + c < valid) ? w[e + c] : 0.f;
      }
      uint32_t word = 0;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // bytes past the end hold 0xff, a valid bin at 8 bits: the scan
        // masks them by index
        const uint32_t code = (4 * k + c < valid) ? code_of(v[c], s, lo, hi, q_n) : 0xffu;
        word |= code << (8 * c);
      }
      cs[k] = word;
      *reinterpret_cast<float4*>(ws + 4 * k) = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    if (!active) continue;
    const int words = (valid + 3) / 4;
    for (int k = slice; k < words; k += slices) {
      const uint32_t word = cs[k];
      if (!has_zero_byte(word ^ pattern)) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * k + c;
        if (((word >> (8 * c)) & 0xffu) == static_cast<uint32_t>(bin) && i < valid) {
          const double x = static_cast<double>(ws[i]);
          cnt += 1;
          s1 += x;
          s2 = fma(x, x, s2);
        }
      }
    }
  }

  // slices in order into the block's partial
  __syncthreads();
  red[0][tid] = static_cast<double>(cnt);
  red[1][tid] = s1;
  red[2][tid] = s2;
  __syncthreads();
  if (tid < n_bins) {
    double a0 = 0.0, a1 = 0.0, a2 = 0.0;
    for (int j = 0; j < slices; ++j) {
      a0 += red[0][j * n_bins + tid];
      a1 += red[1][j * n_bins + tid];
      a2 += red[2][j * n_bins + tid];
    }
    double* p = partial + static_cast<long long>(blockIdx.x) * 3 * n_bins;
    p[tid] = a0;
    p[n_bins + tid] = a1;
    p[2 * n_bins + tid] = a2;
  }
}

// out[v] for v < 3 * n_bins = f32(sum over blocks of partial[block][v])
__global__ void __launch_bounds__(NTHREADS)
bin_stats_finish_kernel(const double* __restrict__ partial, float* __restrict__ out,
                        int blocks, int n_vals) {
  const int v = (blockIdx.x * NTHREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (v >= n_vals) return;  // whole warps leave together
  double acc = 0.0;
  for (int b = lane; b < blocks; b += 32) acc += partial[static_cast<long long>(b) * n_vals + v];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[v] = static_cast<float>(acc);
}

}  // namespace

// Elements a tile (the wrapper sizes the grid with it: blocks x tiles x
// TILE >= n, about 4 blocks an SM).
extern "C" int bin_stats_tile() { return TILE; }

// w: n contiguous f32; scale: one f32 on the device; partial: blocks x 3 x
// n_bins f64 scratch; out: (3, n_bins) f32. Block b covers elements
// [b * tiles * TILE, (b + 1) * tiles * TILE); n_bins = q_n + q_p + 1 <= 256.
// vec = 1 when w is 16-byte aligned. Returns cudaGetLastError().
extern "C" int bin_stats_launch(const void* w, const void* scale, void* partial, void* out,
                                long long n, int blocks, int tiles, int q_n, int q_p,
                                int vec, void* stream) {
  const int n_bins = q_n + q_p + 1;
  if (n_bins > NTHREADS || n_bins < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    bin_stats_partial_kernel<<<blocks, NTHREADS, 0, st>>>(
        static_cast<const float*>(w), static_cast<const float*>(scale),
        static_cast<double*>(partial), n, tiles, q_n, q_p, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    blocks = 0;
  }
  const int n_vals = 3 * n_bins;
  const int fin_blocks = (n_vals * 32 + NTHREADS - 1) / NTHREADS;
  bin_stats_finish_kernel<<<fin_blocks, NTHREADS, 0, st>>>(
      static_cast<const double*>(partial), static_cast<float*>(out), blocks, n_vals);
  return static_cast<int>(cudaGetLastError());
}
