// QAT fused fake-quant matmul and its backward: out = q_a(x) @ q_w(w).
//
// Replaces six TPU kernels of the JAX package (src/repro/kernels/quant_matmul.py):
//   qat_fwd  <- quant_matmul      (:81,  body _qmm_kernel :46)
//   qat_dx   <- quant_matmul_dx   (:241, body _qmm_dx_kernel :196)
//   qat_dw   <- quant_matmul_dw   (:361, body _qmm_dw_kernel :295)
//   qat_bwd  <- quant_matmul_bwd  (:574, body _qmm_bwd_kernel :453)
//   qat_fwd_batched <- quant_matmul_batched     (:141, body _qmm_batched_kernel :114)
//   qat_bwd_batched <- quant_matmul_bwd_batched (:743, body _qmm_bwd_batched_kernel :655)
//
// What each computes (Eq. 5-7 of the paper, LSQ+ activations, grouped weights):
//   xd = bf16(clip(round((x - b) / max(s, 1e-9))) * s + b)      x (M, K), s, b scalars
//   wd = bf16(clip(round(w / max(ws, 1e-9))) * ws)              w (K, N); ws (N,) per
//        column, or (K,) per row (the K-side per-head scales of wo)
//   fwd: y = xd @ wd, f32 sums of bf16 x bf16 products
//   dx:  dxd = bf16(dY @ wd^T); dX = dxd * 1[-Q_N <= u <= Q_P] on the UNCLIPPED
//        u = (x - b) / s; dsa = sum dxd * (q - mf*u); dba = sum dxd * (1 - mf)
//   dw:  dwd = bf16(xd^T @ dY); dW = dwd * mask(w / ws); dws = sum dwd * (q - mf*u)
//        per column (over K) or per row (over N)
//   bwd: all five in one launch (+ the finish pass below).
// dY is rounded to bf16 when round_cot is set (a bf16 linear); the lm head keeps
// it in f32 (round_cot = 0), and then the products are f32 x bf16-valued f32.
// The dX / dW accumulators are rounded through bf16 in every case.
//
// What bounds it on an H100: at the training shapes (M = 4096 tokens, K and N
// of 1024..152064) every product is far above the tensor-core line (hundreds of
// operations a byte), so the kernels are bound by operations: 2*M*K*N at 989
// TFLOP/s in bf16, or at 67 TFLOP/s in f32 for the lm head's f32 cotangents.
// This first version uses no tensor cores: one simple SIMT GEMM tile (128 x 128
// outputs a block of 256 threads, 8 x 8 a thread, the contraction walked 8 at a
// time through shared memory, the next slice's loads in flight while the current
// one is multiplied) serves all six kernels. Each operand is dequantized as it
// is staged into shared memory, so the dequantized x and w never reach HBM (the
// point of the TPU kernels), and a bf16 value held in f32 makes a bf16 x bf16
// product exact, so f32 FMA gives the f32 sum of exact products that the tensor
// cores' bf16 path would. wgmma / TMA come in a later change.
//
// What differs from the TPU design, and why:
//   * No carried accumulators: the TPU grid runs in order and carries dX / dW
//     and the scale sums across grid steps; here a block loops over the whole
//     contraction for its output tile.
//   * Scale cotangents without atomics: each block writes its partial sums
//     (dsa/dba per block; dws per column over the block's rows, or per row over
//     its columns) to a scratch the wrapper allocates, and one finish kernel adds
//     them in a fixed order, so every result is the same from run to run.
//   * The combined backward is one grid whose first blocks compute dX tiles and
//     whose other blocks compute dW tiles, through the same device code as the
//     split kernels, so the two routes give identical bits. The TPU's (bk, Np)
//     VMEM panel has no counterpart.
//   * Edges are masked in the kernel; nothing is padded.
//   * The batched (MoE expert) kernels put the expert on blockIdx.z: a block
//     offsets every per-expert operand (x, w, the (E,) activation scale and
//     offset, the (E, N) column scales, dY, the outputs and the partials) by
//     its expert and then runs the same tile as the 2D kernel, so an expert's
//     results are bit for bit those of the 2D kernels on its slices. The finish
//     pass runs one row of blocks per expert (blockIdx.y). Expert weight
//     scales are N-side only (the reference's eligibility rule), so the
//     batched kernels take no row scales. At the MoE training shapes (32
//     experts x 1280 capacity rows, K and N of 512 / 1024) each expert is 40
//     output tiles, 1280 blocks a launch.
// Numerics: round half to even (rintf), IEEE division (built without fast math),
// and the multiply and add of the dequantization rounded separately (no FMA
// contraction), as the reference writes them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;          // output rows of a block tile
constexpr int BN = 128;          // output columns of a block tile
constexpr int BK = 8;            // contraction slice staged per step
constexpr int NT = 256;          // threads a block: 16 x 16, 8 x 8 outputs each
constexpr int PAD = 4;           // keeps the staging stores free of bank conflicts
constexpr float EPS = 1e-9f;

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

struct Quant {  // one quantizer's code range
  float qn, qp;
  __device__ __forceinline__ float code(float u) const {
    return fminf(fmaxf(rintf(u), -qn), qp);
  }
  __device__ __forceinline__ float in_range(float u) const {
    return (u >= -qn && u <= qp) ? 1.f : 0.f;
  }
};

__device__ __forceinline__ float act_deq(float x, float s, float b, Quant q) {
  const float u = __fdiv_rn(__fsub_rn(x, b), s);
  return bf16r(__fadd_rn(__fmul_rn(q.code(u), s), b));
}

__device__ __forceinline__ float w_deq(float w, float s, Quant q) {
  return bf16r(__fmul_rn(q.code(__fdiv_rn(w, s)), s));
}

// ---------------------------------------------------------------------------
// Operand loaders. A is (I rows, L contraction), B is (L, J columns). load()
// reads the raw value (0 outside the matrix) while the previous slice is being
// multiplied; conv() turns it into the staged value (0 outside). L_FAST: the
// operand is contiguous along L in memory, so neighbouring threads walk L.
// ---------------------------------------------------------------------------

template <class XT>
struct XDeq {  // A(m, k) = xd(m, k): forward
  static constexpr bool L_FAST = true;
  const XT* x; int M, K; float s, b; Quant q;
  __device__ float load(int m, int k) const {
    return (m < M && k < K) ? ld(x, (size_t)m * K + k) : 0.f;
  }
  __device__ float conv(float v, int m, int k) const {
    return (m < M && k < K) ? act_deq(v, s, b, q) : 0.f;
  }
};

template <class XT>
struct XDeqT {  // A(k, m) = xd(m, k): dW = xd^T @ dY
  static constexpr bool L_FAST = false;
  const XT* x; int M, K; float s, b; Quant q;
  __device__ float load(int k, int m) const {
    return (m < M && k < K) ? ld(x, (size_t)m * K + k) : 0.f;
  }
  __device__ float conv(float v, int k, int m) const {
    return (m < M && k < K) ? act_deq(v, s, b, q) : 0.f;
  }
};

struct WQ {  // the weight quantizer: w (K, N), scales per column or per row
  const float* w; const float* ws; int K, N, k_side; Quant q;
  __device__ __forceinline__ float scale(int k, int n) const {
    return fmaxf(ws[k_side ? k : n], EPS);
  }
};

struct Args {
  const void* x;           // (M, K) bf16 or f32
  const float* w;          // (K, N)
  const float* a_s;        // 0-d activation scale (device)
  const float* a_b;        // 0-d activation offset (device)
  const float* ws;         // (N,) column or (K,) row weight scales
  const float* dy;         // (M, N) f32
  int M, K, N;
  int k_side;              // ws is per row (K,) instead of per column (N,)
  int round_cot;           // dY rounded to bf16
  Quant qa, qw;
  __device__ __forceinline__ WQ wq() const { return WQ{w, ws, K, N, k_side, qw}; }
};

struct WDeq {  // B(k, n) = wd(k, n): forward
  static constexpr bool L_FAST = false;
  WQ a;
  __device__ float load(int k, int n) const {
    return (k < a.K && n < a.N) ? a.w[(size_t)k * a.N + n] : 0.f;
  }
  __device__ float conv(float v, int k, int n) const {
    return (k < a.K && n < a.N) ? w_deq(v, a.scale(k, n), a.q) : 0.f;
  }
};

struct WDeqT {  // B(n, k) = wd(k, n): dX = dY @ wd^T
  static constexpr bool L_FAST = true;
  WQ a;
  __device__ float load(int n, int k) const {
    return (k < a.K && n < a.N) ? a.w[(size_t)k * a.N + n] : 0.f;
  }
  __device__ float conv(float v, int n, int k) const {
    return (k < a.K && n < a.N) ? w_deq(v, a.scale(k, n), a.q) : 0.f;
  }
};

template <bool L_IS_N>
struct DY {  // dY (M, N): A(m, n) for dX (L = n), B(m, n) for dW (L = m)
  static constexpr bool L_FAST = L_IS_N;
  const float* dy; int M, N, round_cot;
  __device__ float load(int r, int c) const {
    return (r < M && c < N) ? dy[(size_t)r * N + c] : 0.f;
  }
  __device__ float conv(float v, int, int) const {
    return round_cot ? bf16r(v) : v;
  }
};

// ---------------------------------------------------------------------------
// The GEMM tile: acc[r][c] = sum_l A(i0 + row(r), l) * B(l, j0 + col(c)),
// rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise with tx.
// ---------------------------------------------------------------------------

struct Smem {
  float A[BK][BM + PAD];
  float B[BK][BN + PAD];
  float red[16][BM];       // epilogue reductions (16 partials per row/column)
};

__device__ __forceinline__ int tile_row(int ty, int r) { return (r < 4 ? 0 : 64) + ty * 4 + (r & 3); }

__device__ __forceinline__ void a_index(bool l_fast, int e, int& i, int& l) {
  if (l_fast) { i = e / BK; l = e % BK; } else { l = e / BM; i = e % BM; }
}

__device__ __forceinline__ void b_index(bool l_fast, int e, int& l, int& j) {
  if (l_fast) { j = e / BK; l = e % BK; } else { l = e / BN; j = e % BN; }
}

template <class LA, class LB>
__device__ __forceinline__ void gemm_tile(const LA& la, const LB& lb, int i0, int j0,
                                          int L, float (&acc)[8][8], Smem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  constexpr int PER = BM * BK / NT;  // 4 elements of each operand a thread
  float ra[PER], rb[PER];
#pragma unroll
  for (int p = 0; p < PER; ++p) {
    int i, l, j, l2;
    a_index(LA::L_FAST, tid + p * NT, i, l);
    b_index(LB::L_FAST, tid + p * NT, l2, j);
    ra[p] = la.load(i0 + i, l);
    rb[p] = lb.load(l2, j0 + j);
  }
  for (int l0 = 0; l0 < L; l0 += BK) {
    __syncthreads();  // the previous slice's readers are done
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      int i, l, j, l2;
      a_index(LA::L_FAST, tid + p * NT, i, l);
      b_index(LB::L_FAST, tid + p * NT, l2, j);
      sm.A[l][i] = la.conv(ra[p], i0 + i, l0 + l);
      sm.B[l2][j] = lb.conv(rb[p], l0 + l2, j0 + j);
    }
    __syncthreads();
    if (l0 + BK < L) {
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        int i, l, j, l2;
        a_index(LA::L_FAST, tid + p * NT, i, l);
        b_index(LB::L_FAST, tid + p * NT, l2, j);
        ra[p] = la.load(i0 + i, l0 + BK + l);
        rb[p] = lb.load(l0 + BK + l2, j0 + j);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sm.A[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sm.A[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sm.B[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sm.B[kk][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

// Fixed-order sum of one value per thread; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* buf) {
  __syncthreads();
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  return buf[0];
}

// ---------------------------------------------------------------------------
// The three tiles
// ---------------------------------------------------------------------------

template <class XT>
__device__ __forceinline__ void fwd_tile(const Args& a, float* out, int blk, Smem& sm) {
  const int n_i = (a.M + BM - 1) / BM;
  const int i0 = (blk % n_i) * BM, j0 = (blk / n_i) * BN;
  const float s = fmaxf(*a.a_s, EPS), b = *a.a_b;
  XDeq<XT> la{static_cast<const XT*>(a.x), a.M, a.K, s, b, a.qa};
  WDeq lb{a.wq()};
  float acc[8][8];
  gemm_tile(la, lb, i0, j0, a.K, acc, sm);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = i0 + tile_row(ty, r);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = j0 + tile_row(tx, c);
      if (m < a.M && n < a.N) out[(size_t)m * a.N + n] = acc[r][c];
    }
  }
}

// dX tile (rows m, columns k; contraction over n) + this block's dsa/dba.
template <class XT>
__device__ __forceinline__ void dx_tile(const Args& a, float* dx, float* part, int blk, Smem& sm) {
  const int n_i = (a.M + BM - 1) / BM;
  const int i0 = (blk % n_i) * BM, j0 = (blk / n_i) * BN;
  DY<true> la{a.dy, a.M, a.N, a.round_cot};
  WDeqT lb{a.wq()};
  float acc[8][8];
  gemm_tile(la, lb, i0, j0, a.N, acc, sm);
  const float s = fmaxf(*a.a_s, EPS), b = *a.a_b;
  const XT* x = static_cast<const XT*>(a.x);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int m = i0 + tile_row(ty, r);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int k = j0 + tile_row(tx, c);
      if (m < a.M && k < a.K) {
        const size_t at = (size_t)m * a.K + k;
        const float dxd = bf16r(acc[r][c]);
        const float u = __fdiv_rn(__fsub_rn(ld(x, at), b), s);
        const float mf = a.qa.in_range(u);
        const float q = a.qa.code(u);
        dx[at] = __fmul_rn(dxd, mf);
        sa = __fadd_rn(sa, __fmul_rn(dxd, __fsub_rn(q, __fmul_rn(mf, u))));
        sb = __fadd_rn(sb, __fmul_rn(dxd, __fsub_rn(1.f, mf)));
      }
    }
  }
  float* buf = &sm.red[0][0];
  const float ta = block_sum(sa, buf);
  if (threadIdx.x == 0) part[2 * blk] = ta;
  const float tb = block_sum(sb, buf);
  if (threadIdx.x == 0) part[2 * blk + 1] = tb;
}

// dW tile (rows k, columns n; contraction over m) + this block's dws partials:
// per column over its rows (part[row block][N]) or per row over its columns
// (part[column block][K]).
template <class XT>
__device__ __forceinline__ void dw_tile(const Args& a, float* dw, float* part, int blk, Smem& sm) {
  const int n_i = (a.K + BM - 1) / BM;
  const int bi = blk % n_i, bj = blk / n_i;
  const int i0 = bi * BM, j0 = bj * BN;
  const float s = fmaxf(*a.a_s, EPS), b = *a.a_b;
  XDeqT<XT> la{static_cast<const XT*>(a.x), a.M, a.K, s, b, a.qa};
  DY<false> lb{a.dy, a.M, a.N, a.round_cot};
  const WQ wq = a.wq();
  float acc[8][8];
  gemm_tile(la, lb, i0, j0, a.M, acc, sm);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float rsum[8], csum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rsum[i] = csum[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int k = i0 + tile_row(ty, r);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = j0 + tile_row(tx, c);
      if (k < a.K && n < a.N) {
        const size_t at = (size_t)k * a.N + n;
        const float dwd = bf16r(acc[r][c]);
        const float u = __fdiv_rn(a.w[at], wq.scale(k, n));
        const float mf = a.qw.in_range(u);
        const float q = a.qw.code(u);
        dw[at] = __fmul_rn(dwd, mf);
        const float p = __fmul_rn(dwd, __fsub_rn(q, __fmul_rn(mf, u)));
        rsum[r] = __fadd_rn(rsum[r], p);
        csum[c] = __fadd_rn(csum[c], p);
      }
    }
  }
  __syncthreads();  // sm.red is free (the GEMM's last readers are done)
  if (a.k_side) {
#pragma unroll
    for (int r = 0; r < 8; ++r) sm.red[tx][tile_row(ty, r)] = rsum[r];
  } else {
#pragma unroll
    for (int c = 0; c < 8; ++c) sm.red[ty][tile_row(tx, c)] = csum[c];
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int t = threadIdx.x;
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < 16; ++g) v += sm.red[g][t];
    if (a.k_side) {
      if (i0 + t < a.K) part[(size_t)bj * a.K + i0 + t] = v;
    } else {
      if (j0 + t < a.N) part[(size_t)bi * a.N + j0 + t] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

template <class XT>
__global__ void __launch_bounds__(NT) qat_fwd_kernel(Args a, float* out) {
  __shared__ __align__(16) Smem sm;
  fwd_tile<XT>(a, out, blockIdx.x, sm);
}

template <class XT>
__global__ void __launch_bounds__(NT) qat_dx_kernel(Args a, float* dx, float* part) {
  __shared__ __align__(16) Smem sm;
  dx_tile<XT>(a, dx, part, blockIdx.x, sm);
}

template <class XT>
__global__ void __launch_bounds__(NT) qat_dw_kernel(Args a, float* dw, float* part) {
  __shared__ __align__(16) Smem sm;
  dw_tile<XT>(a, dw, part, blockIdx.x, sm);
}

// Blocks [0, n_dx) are dX tiles, the rest dW tiles.
template <class XT>
__global__ void __launch_bounds__(NT) qat_bwd_kernel(Args a, float* dx, float* part_x,
                                                     float* dw, float* part_w, int n_dx) {
  __shared__ __align__(16) Smem sm;
  if ((int)blockIdx.x < n_dx) dx_tile<XT>(a, dx, part_x, blockIdx.x, sm);
  else dw_tile<XT>(a, dw, part_w, blockIdx.x - n_dx, sm);
}

// Expert e's operands: every per-expert pointer advanced to its slice.
template <class XT>
__device__ __forceinline__ Args at_expert(Args a, int e) {
  a.x = static_cast<const XT*>(a.x) + (size_t)e * a.M * a.K;
  a.w += (size_t)e * a.K * a.N;
  a.a_s += e;
  a.a_b += e;
  a.ws += (size_t)e * a.N;
  if (a.dy != nullptr) a.dy += (size_t)e * a.M * a.N;
  return a;
}

template <class XT>
__global__ void __launch_bounds__(NT) qat_fwd_batched_kernel(Args a, float* out) {
  __shared__ __align__(16) Smem sm;
  const int e = blockIdx.z;
  fwd_tile<XT>(at_expert<XT>(a, e), out + (size_t)e * a.M * a.N, blockIdx.x, sm);
}

// Per expert: blocks [0, n_dx) are dX tiles, the rest dW tiles; each expert
// owns 2 * n_dx dX partials and n_wp * N dws partials.
template <class XT>
__global__ void __launch_bounds__(NT) qat_bwd_batched_kernel(Args a, float* dx, float* part_x,
                                                             float* dw, float* part_w,
                                                             int n_dx, int n_wpart) {
  __shared__ __align__(16) Smem sm;
  const int e = blockIdx.z;
  const Args ae = at_expert<XT>(a, e);
  if ((int)blockIdx.x < n_dx)
    dx_tile<XT>(ae, dx + (size_t)e * a.M * a.K, part_x + (size_t)e * 2 * n_dx, blockIdx.x, sm);
  else
    dw_tile<XT>(ae, dw + (size_t)e * a.K * a.N, part_w + (size_t)e * n_wpart,
                blockIdx.x - n_dx, sm);
}

// The fixed-order finish: dsa / dba from n_sp block pairs (block 0), and dws[l]
// = sum over r of part_w[r][l] in order r = 0, 1, ... (all blocks).
// Expert e = blockIdx.y reads its own partials and writes its own sums (the
// 2D kernels launch one row, e = 0).
__global__ void __launch_bounds__(NT) qat_finish_kernel(const float* part_x, int n_sp,
                                                        float* dsa, float* dba,
                                                        const float* part_w, int n_wp,
                                                        int L, float* dws) {
  __shared__ float buf[NT];
  const int e = blockIdx.y;
  if (part_x != nullptr) {
    part_x += (size_t)e * 2 * n_sp;
    dsa += e;
    dba += e;
  }
  if (part_w != nullptr) {
    part_w += (size_t)e * n_wp * L;
    dws += (size_t)e * L;
  }
  if (part_x != nullptr && blockIdx.x == 0) {
    float sa = 0.f, sb = 0.f;
    for (int i = threadIdx.x; i < n_sp; i += NT) {
      sa += part_x[2 * i];
      sb += part_x[2 * i + 1];
    }
    const float ta = block_sum(sa, buf);
    if (threadIdx.x == 0) *dsa = ta;
    const float tb = block_sum(sb, buf);
    if (threadIdx.x == 0) *dba = tb;
  }
  if (part_w != nullptr) {
    for (int l = blockIdx.x * NT + threadIdx.x; l < L; l += gridDim.x * NT) {
      float v = 0.f;
      for (int r = 0; r < n_wp; ++r) v += part_w[(size_t)r * L + l];
      dws[l] = v;
    }
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }
inline int n_dx_blocks(const Args& a) { return cdiv(a.M, BM) * cdiv(a.K, BN); }
inline int n_dw_blocks(const Args& a) { return cdiv(a.K, BM) * cdiv(a.N, BN); }
// dws partials: rows of length L = K (row scales) or N (column scales)
inline int n_wp(const Args& a) { return a.k_side ? cdiv(a.N, BN) : cdiv(a.K, BM); }
inline int wp_len(const Args& a) { return a.k_side ? a.K : a.N; }

cudaError_t finish(const Args& a, const float* part_x, float* dsa, float* dba,
                   const float* part_w, float* dws, cudaStream_t st, int experts = 1) {
  const int L = part_w ? wp_len(a) : 0;
  int grid = cdiv(L, NT);
  grid = grid < 1 ? 1 : (grid > 1024 ? 1024 : grid);
  qat_finish_kernel<<<dim3(grid, experts), NT, 0, st>>>(
      part_x, part_x ? n_dx_blocks(a) : 0, dsa, dba, part_w, part_w ? n_wp(a) : 0, L, dws);
  return cudaGetLastError();
}

Args make_args(const void* x, const void* w, const void* a_s, const void* a_b,
               const void* ws, const void* dy, int M, int K, int N, int k_side,
               int round_cot, int qn_a, int qp_a, int qn_w, int qp_w) {
  Args a;
  a.x = x;
  a.w = static_cast<const float*>(w);
  a.a_s = static_cast<const float*>(a_s);
  a.a_b = static_cast<const float*>(a_b);
  a.ws = static_cast<const float*>(ws);
  a.dy = static_cast<const float*>(dy);
  a.M = M; a.K = K; a.N = N;
  a.k_side = k_side;
  a.round_cot = round_cot;
  a.qa = Quant{static_cast<float>(qn_a), static_cast<float>(qp_a)};
  a.qw = Quant{static_cast<float>(qn_w), static_cast<float>(qp_w)};
  return a;
}

}  // namespace

// Every entry: pointers to contiguous tensors on the current device, x (M, K)
// bf16 (x_bf16 = 1) or f32, w (K, N) f32, a_s / a_b 0-d f32, ws (N,) or (K,) f32
// (k_side), dy (M, N) f32; outputs f32. Scratch (allocated by the caller):
// part_x 2 * qat_dx_blocks floats, part_w qat_dws_partials floats. Launches on
// `stream` and returns cudaGetLastError().

extern "C" int qat_tile(void) { return BM; }

extern "C" int qat_fwd_launch(const void* x, int x_bf16, const void* w, const void* a_s,
                              const void* a_b, const void* ws, int k_side, void* out,
                              int M, int K, int N, int qn_a, int qp_a, int qn_w, int qp_w,
                              void* stream) {
  if (M <= 0 || N <= 0) return 0;
  Args a = make_args(x, w, a_s, a_b, ws, nullptr, M, K, N, k_side, 0, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = cdiv(M, BM) * cdiv(N, BN);
  if (x_bf16) qat_fwd_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a, static_cast<float*>(out));
  else qat_fwd_kernel<float><<<grid, NT, 0, st>>>(a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qat_dx_launch(const void* dy, const void* x, int x_bf16, const void* w,
                             const void* a_s, const void* a_b, const void* ws, int k_side,
                             void* dx, void* dsa, void* dba, void* part_x,
                             int M, int K, int N, int qn_a, int qp_a, int qn_w, int qp_w,
                             int round_cot, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  Args a = make_args(x, w, a_s, a_b, ws, dy, M, K, N, k_side, round_cot, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* px = static_cast<float*>(part_x);
  const int grid = n_dx_blocks(a);
  if (x_bf16) qat_dx_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a, static_cast<float*>(dx), px);
  else qat_dx_kernel<float><<<grid, NT, 0, st>>>(a, static_cast<float*>(dx), px);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(a, px, static_cast<float*>(dsa), static_cast<float*>(dba),
                                 nullptr, nullptr, st));
}

extern "C" int qat_dw_launch(const void* dy, const void* x, int x_bf16, const void* w,
                             const void* a_s, const void* a_b, const void* ws, int k_side,
                             void* dw, void* dws, void* part_w,
                             int M, int K, int N, int qn_a, int qp_a, int qn_w, int qp_w,
                             int round_cot, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  Args a = make_args(x, w, a_s, a_b, ws, dy, M, K, N, k_side, round_cot, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pw = static_cast<float*>(part_w);
  const int grid = n_dw_blocks(a);
  if (x_bf16) qat_dw_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a, static_cast<float*>(dw), pw);
  else qat_dw_kernel<float><<<grid, NT, 0, st>>>(a, static_cast<float*>(dw), pw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(a, nullptr, nullptr, nullptr, pw, static_cast<float*>(dws), st));
}

extern "C" int qat_bwd_launch(const void* dy, const void* x, int x_bf16, const void* w,
                              const void* a_s, const void* a_b, const void* ws, int k_side,
                              void* dx, void* dsa, void* dba, void* dw, void* dws,
                              void* part_x, void* part_w,
                              int M, int K, int N, int qn_a, int qp_a, int qn_w, int qp_w,
                              int round_cot, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0) return 0;
  Args a = make_args(x, w, a_s, a_b, ws, dy, M, K, N, k_side, round_cot, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* px = static_cast<float*>(part_x);
  float* pw = static_cast<float*>(part_w);
  const int n_dx = n_dx_blocks(a);
  const int grid = n_dx + n_dw_blocks(a);
  if (x_bf16)
    qat_bwd_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a, static_cast<float*>(dx), px,
                                                       static_cast<float*>(dw), pw, n_dx);
  else
    qat_bwd_kernel<float><<<grid, NT, 0, st>>>(a, static_cast<float*>(dx), px,
                                               static_cast<float*>(dw), pw, n_dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(a, px, static_cast<float*>(dsa), static_cast<float*>(dba),
                                 pw, static_cast<float*>(dws), st));
}

// Batched (per-expert) entries: x (E, M, K) bf16 or f32, w (E, K, N) f32,
// a_s / a_b (E,) f32, ws (E, N) f32 column scales, dy (E, M, N) f32; outputs
// f32 (E, M, N) / dx (E, M, K), dsa / dba (E,), dw (E, K, N), dws (E, N).
// Scratch: part_x E * 2 * qat_dx_blocks floats, part_w E * cdiv(K, 128) * N.

extern "C" int qat_fwd_batched_launch(const void* x, int x_bf16, const void* w,
                                      const void* a_s, const void* a_b, const void* ws,
                                      void* out, int E, int M, int K, int N, int qn_a,
                                      int qp_a, int qn_w, int qp_w, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  Args a = make_args(x, w, a_s, a_b, ws, nullptr, M, K, N, 0, 0, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(cdiv(M, BM) * cdiv(N, BN), 1, E);
  if (x_bf16)
    qat_fwd_batched_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a, static_cast<float*>(out));
  else
    qat_fwd_batched_kernel<float><<<grid, NT, 0, st>>>(a, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qat_bwd_batched_launch(const void* dy, const void* x, int x_bf16,
                                      const void* w, const void* a_s, const void* a_b,
                                      const void* ws, void* dx, void* dsa, void* dba,
                                      void* dw, void* dws, void* part_x, void* part_w,
                                      int E, int M, int K, int N, int qn_a, int qp_a,
                                      int qn_w, int qp_w, int round_cot, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return 0;
  Args a = make_args(x, w, a_s, a_b, ws, dy, M, K, N, 0, round_cot, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* px = static_cast<float*>(part_x);
  float* pw = static_cast<float*>(part_w);
  const int n_dx = n_dx_blocks(a);
  const int n_wpart = n_wp(a) * wp_len(a);
  const dim3 grid(n_dx + n_dw_blocks(a), 1, E);
  if (x_bf16)
    qat_bwd_batched_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(
        a, static_cast<float*>(dx), px, static_cast<float*>(dw), pw, n_dx, n_wpart);
  else
    qat_bwd_batched_kernel<float><<<grid, NT, 0, st>>>(
        a, static_cast<float*>(dx), px, static_cast<float*>(dw), pw, n_dx, n_wpart);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(a, px, static_cast<float*>(dsa), static_cast<float*>(dba),
                                 pw, static_cast<float*>(dws), st, E));
}
