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
// writes 3 x n_bins floats, so HBM bandwidth (3.35 TB/s) bounds it; the
// warp work of each step of 32 elements is the real limit: a
// __match_any_sync, whose cost grows with the distinct codes in the step
// (most at 256 bins), and a five-level tree of f64 shuffles, a fixed cost
// (most of the time at 16 bins). An element's work no longer grows with
// n_bins. Sums keep a fixed order (no float atomics), so a run's bits do
// not depend on scheduling, as in the QAT kernels of this package.
//
//   bin_stats_partial_kernel: block b takes a fixed range of elements (the
//     rows of w, flattened), `tiles` tiles of TILE elements; thread t loads
//     float4 u * 256 + t of a tile (u < 4) and computes its 4 codes, each
//     element by its own lane (code_of). For each of them the warp groups equal
//     codes with __match_any_sync; every lane sums its group's values (and
//     squares) in f64 over a fixed tree of aligned lane blocks of 2, 4, 8,
//     16, 32 (a block's group sum taken by one shuffle from its lowest
//     member), and the group's lowest lane adds the count (a popcount,
//     exact), the sum and the sum of squares to the warp's own f64 bins in
//     shared memory: one lane a bin in a step, so no atomics. At the end the
//     8 warps' bins are added in warp order into the block's (3, n_bins)
//     f64 partial.
//   bin_stats_finish_kernel: one warp per output value sums the blocks'
//     partials in a fixed order (lane l takes blocks l, l + 32, ..., then a
//     fixed shuffle tree) in f64 and rounds once to f32, so the counts are
//     exact below 2^24 and correctly rounded above, as in the plain version.
//
// Non-finite values follow the reference's one-hot contraction, where an
// element outside a bin adds w * 0 to its sum: a NaN code (w or s NaN) falls
// in no bin, and a bin's sum (sum of squares) is NaN when an element outside
// it has a non-finite w (f32 w * w). The hot loop is unchanged for that: a
// NaN code lands in bin 0, and a NaN or Inf w, or one with |w| >= 2^64
// (whose f32 square is Inf), leaves its block a bin sum that is not finite
// or a sum of squares >= 2^128 (which many large finite w can also reach).
// Only such a block reads its elements again and counts, in its shared
// memory, each one whose f32 square is not finite, in total and by bin, and
// each NaN code apart (integer-valued f64 atomics: exact in any order); then
// it takes the NaN codes out of its bin 0 count and writes NaN into its
// partial sum (sum of squares) of every bin that such an element outside it
// reaches. Summed over the blocks, that is the reference's rule. With a NaN
// scale every code is NaN: the finish writes counts 0 and sums 0, or NaN
// where a block wrote one. ±Inf clips to an edge bin and sums as itself.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int TILE = 4096;                  // elements of a block step
constexpr int U = TILE / (4 * NTHREADS);    // float4s a thread a tile
constexpr unsigned FULL = 0xffffffffu;

// The bin of w: clip(rint(w / s), lo, hi) + q_n, the quotient rounded as an
// IEEE division and rint to even, as in the plain version. The quotient is
// first taken as w * (1 / s), within 3 units of its last place of the
// correctly rounded one, so both round to the same integer unless a
// half-integer lies that close; there (about one element in 10^5 of
// Gaussian data) the division itself is taken. Clipping before rounding
// gives the same code (lo and hi are integers), and adding 1.5 x 2^23
// rounds to an integer (ties to even) whose bits are the code: no
// quarter-rate rounding or conversion instruction.
__device__ __forceinline__ uint32_t code_of(float w, float s, float inv_s, float lo, float hi,
                                            int q_n) {
  constexpr float MAGIC = 12582912.f;  // 1.5 x 2^23
  float q = fminf(fmaxf(__fmul_rn(w, inv_s), lo), hi);
  float t = __fadd_rn(q, MAGIC);
  if (0.5f - fabsf(__fsub_rn(q, __fsub_rn(t, MAGIC))) <= fabsf(q) * 9.5367431640625e-07f) {
    q = fminf(fmaxf(__fdiv_rn(w, s), lo), hi);  // within |q| 2^-20 of a half-integer
    t = __fadd_rn(q, MAGIC);
  }
  return static_cast<uint32_t>(__float_as_int(t) - 0x4B400000 + q_n);
}

// Adds the warp's 32 elements (one a lane: code, value; code n_bins for no
// element) to the warp's bins ([3][n_bins] f64: count, sum, sum of
// squares). Lanes with equal codes form a group (__match_any_sync); every
// lane sums its group's values and squares in f64 over a fixed tree of
// aligned lane blocks of 2, 4, 8, 16 and 32 (the other half-block's group
// sum read by one shuffle from its lowest member), so all members hold the
// same bits; the group's lowest lane adds the count (a popcount, exact),
// the sum and the sum of squares to the bins: one lane a bin, so no atomics.
__device__ __forceinline__ void warp_add(double* bins, int n_bins, uint32_t code, float v,
                                         int lane) {
  const unsigned group = __match_any_sync(FULL, code);
  // the tree's first level pairs lanes 2i, 2i + 1: one f32 shuffle
  const float vo = __shfl_xor_sync(FULL, v, 1);
  const double x = v;
  double s1 = x, s2 = x * x;  // exact: an f32 square fits an f64
  if (group & (1u << (lane ^ 1))) {
    const double xo = vo;
    s1 += xo;
    s2 = fma(xo, xo, s2);
  }
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    // the other half of this lane's aligned block of 2^(k+1) lanes
    const int half = 1 << k;
    const unsigned other = group & (((1u << half) - 1u) << ((lane ^ half) & ~(half - 1)));
    const int src = other ? __ffs(other) - 1 : lane;
    const double o1 = __shfl_sync(FULL, s1, src);
    const double o2 = __shfl_sync(FULL, s2, src);
    if (other) {
      s1 += o1;
      s2 += o2;
    }
  }
  if (code < static_cast<uint32_t>(n_bins) && lane == __ffs(group) - 1) {
    bins[code] += static_cast<double>(__popc(group));
    bins[n_bins + code] += s1;
    bins[2 * n_bins + code] += s2;
  }
  __syncwarp();  // the next step's leaders may take the same bin
}

// A block's counters of non-finite elements (in its shared memory, once
// its bins are written out): [n_bins by bin, total] for a non-finite w, the
// same for a non-finite f32 w * w, and the count of NaN codes.
__host__ __device__ constexpr int slots(int n_bins) { return 2 * (n_bins + 1) + 1; }

// Counts one w whose f32 square is not finite (a NaN code in no bin).
__device__ __noinline__ void note_nonfinite(double* nf, int n_bins, float w, float s,
                                            float inv_s, float lo, float hi, int q_n) {
  const float p = __fmul_rn(w, inv_s);
  const uint32_t code = p != p ? n_bins : code_of(w, s, inv_s, lo, hi, q_n);
  const bool binned = code < static_cast<uint32_t>(n_bins);
  double* sq = nf + n_bins + 1;
  atomicAdd(sq + n_bins, 1.0);
  if (binned) atomicAdd(sq + code, 1.0);
  if (!(fabsf(w) <= FLT_MAX)) {
    atomicAdd(nf + n_bins, 1.0);
    if (binned) atomicAdd(nf + code, 1.0);
  }
  if (!binned) atomicAdd(nf + 2 * (n_bins + 1), 1.0);
}

// A tile's U float4s of thread tid (u * NTHREADS + tid), zeros past n.
__device__ __forceinline__ void load_tile(float (&v)[U][4], const float* w, long long base,
                                          long long n, int tid, int vec) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long e = base + 4 * (u * NTHREADS + tid);
    if (vec && e + 3 < n) {
      const float4 t4 = __ldcs(reinterpret_cast<const float4*>(w + e));
      v[u][0] = t4.x; v[u][1] = t4.y; v[u][2] = t4.z; v[u][3] = t4.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[u][j] = e + j < n ? w[e + j] : 0.f;
    }
  }
}

// note_nonfinite for each of thread tid's elements of a tile whose square is
// not finite (the tile loaded again).
__device__ __noinline__ void note_tile(double* nf, int n_bins, const float* w, long long base,
                                       long long n, int tid, int vec, float s, float inv_s,
                                       float lo, float hi, int q_n) {
  float v[U][4];
  load_tile(v, w, base, n, tid, vec);
  for (int u = 0; u < U; ++u)
    for (int j = 0; j < 4; ++j)
      if (!(fabsf(__fmul_rn(v[u][j], v[u][j])) <= FLT_MAX))
        note_nonfinite(nf, n_bins, v[u][j], s, inv_s, lo, hi, q_n);
}

__global__ void __launch_bounds__(NTHREADS, 4)
bin_stats_partial_kernel(const float* __restrict__ w, const float* __restrict__ scale,
                         double* __restrict__ partial, long long n, int tiles,
                         int q_n, int q_p, int vec) {
  extern __shared__ double bins[];  // [NWARPS][3][n_bins]
  const int n_bins = q_n + q_p + 1;
  const int tid = threadIdx.x, lane = tid % 32;
  for (int i = tid; i < NWARPS * 3 * n_bins; i += NTHREADS) bins[i] = 0.0;
  __syncthreads();
  double* mine = bins + (tid / 32) * 3 * n_bins;
  const float s = floor_scale(*scale, 1e-9f), inv_s = __frcp_rn(s);
  const float lo = -static_cast<float>(q_n), hi = static_cast<float>(q_p);

  const long long first = static_cast<long long>(blockIdx.x) * tiles * TILE;
  for (int t = 0; t < tiles; ++t) {
    const long long base = first + static_cast<long long>(t) * TILE;
    if (base >= n) break;
    float v[U][4];
    load_tile(v, w, base, n, tid, vec);
    const bool full = base + TILE <= n;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long e = base + 4 * (u * NTHREADS + tid) + j;
        const uint32_t code =
            full || e < n ? code_of(v[u][j], s, inv_s, lo, hi, q_n) : n_bins;
        warp_add(mine, n_bins, code, v[u][j], lane);
      }
  }

  // the warps' bins in warp order into the block's partial
  __syncthreads();
  double* p = partial + static_cast<long long>(blockIdx.x) * 3 * n_bins;
  bool bad = false;  // a bin's f64 sum not finite, or its sum of squares >= 2^128
  if (tid < n_bins) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      double a = bins[q * n_bins + tid];
      for (int wp = 1; wp < NWARPS; ++wp) a += bins[(wp * 3 + q) * n_bins + tid];
      p[q * n_bins + tid] = a;
      if (q == 1) bad = !(fabs(a) <= DBL_MAX);
      if (q == 2) bad = bad || !(a < 0x1p128);
    }
  }
  // rare: a NaN or Inf w, or a w with |w| >= 2^64 (its f32 square is Inf),
  // made a sum so; count such elements in the free shared bins and correct
  if (__syncthreads_or(bad)) {
    double* nf = bins;
    for (int i = tid; i < slots(n_bins); i += NTHREADS) nf[i] = 0.0;
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      const long long base = first + static_cast<long long>(t) * TILE;
      if (base < n) note_tile(nf, n_bins, w, base, n, tid, vec, s, inv_s, lo, hi, q_n);
    }
    __syncthreads();
    if (tid < n_bins) {
      const double nan = __longlong_as_double(0x7ff8000000000000LL);
      const double* sq = nf + n_bins + 1;
      if (tid == 0) p[0] -= nf[2 * (n_bins + 1)];  // the NaN codes binned at 0
      if (nf[n_bins] > nf[tid]) p[n_bins + tid] = nan;
      if (sq[n_bins] > sq[tid]) p[2 * n_bins + tid] = nan;
    }
  }
}

// out[v] for v < 3 * n_bins = f32(sum over blocks of partial[block][v]);
// with a NaN scale (every code NaN), counts 0 and sums 0 or NaN.
__global__ void __launch_bounds__(NTHREADS)
bin_stats_finish_kernel(const double* __restrict__ partial, const float* __restrict__ scale,
                        float* __restrict__ out, int blocks, int n_vals) {
  const int v = (blockIdx.x * NTHREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (v >= n_vals) return;  // whole warps leave together
  double acc = 0.0;
  for (int b = lane; b < blocks; b += 32) acc += partial[static_cast<long long>(b) * n_vals + v];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0)
    out[v] = *scale == *scale ? static_cast<float>(acc)
                              : (v >= n_vals / 3 && acc != acc ? __int_as_float(0x7fc00000) : 0.f);
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
    // at most 8 x 3 x 256 f64 = 48 KB, the static limit: no attribute needed
    const size_t smem = sizeof(double) * NWARPS * 3 * n_bins;
    bin_stats_partial_kernel<<<blocks, NTHREADS, smem, st>>>(
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
      static_cast<const double*>(partial), static_cast<const float*>(scale),
      static_cast<float*>(out), blocks, n_vals);
  return static_cast<int>(cudaGetLastError());
}
