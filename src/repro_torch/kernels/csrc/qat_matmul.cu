// QAT fused fake-quant matmul and its backward: out = q_a(x) @ q_w(w).
//
// Replaces six TPU kernels of the JAX package (src/repro/kernels/quant_matmul.py):
//   qat_fwd_tc <- quant_matmul      (:81,  body _qmm_kernel :46) and
//                 quant_matmul_batched (:141, body _qmm_batched_kernel :114)
//   qat_dx_tc  <- quant_matmul_dx   (:241, body _qmm_dx_kernel :196)
//   qat_dw_tc  <- quant_matmul_dw   (:361, body _qmm_dw_kernel :295)
//   qat_bwd_tc (bf16 dY) / qat_bwd (f32 dY)
//              <- quant_matmul_bwd  (:574, body _qmm_bwd_kernel :453)
//   qat_bwd_tc (bf16 dY, E > 1) / qat_bwd_batched (f32 dY)
//              <- quant_matmul_bwd_batched (:743, body _qmm_bwd_batched_kernel :655)
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
// What bounds them on an H100: at the training shapes (M = 4096 tokens, K and
// N of 512..152064) every product is far above the tensor-core line (hundreds
// of operations a byte), so the kernels are bound by operations: 2*M*K*N at
// 989 TFLOP/s in bf16 (three times that for the head's f32 cotangents, below).
//
// Tensor cores (bf16 x bf16 products, f32 sums): the forward, 2D and per
// expert (qat_fwd_tc_launch); the combined backward for bf16 cotangents, 2D
// and per expert (qat_bwd_tc_launch, the form a training step launches for
// every bf16 linear, the MoE experts' included); and the split dx / dw
// (qat_dx_tc_launch, qat_dw_tc_launch: the vocab-wide head, and each expert
// of a batched backward past the reference's scratch budget). Dequantizing
// while staging would repeat __fdiv_rn + rintf + clamp + two rounded ops for
// every operand element in every block that reads it
// (at the qwen head each of 1,188 column blocks would divide all of x, each
// of 32 row blocks the whole 1024 x 152064 weight), more f32 instructions
// than the products' bound. So one prologue (qat_prologue_kernel) writes xd,
// wd and the cotangent's bf16 planes to zero-padded bf16 scratch once, with
// the device functions the SIMT tile stages with, so the same bits; the
// scratch costs its bytes twice (written, read), ~0.3 ms for the 0.3 GB of
// the qwen head's wd. The tile is then a plain bf16 GEMM: 128 x 128 outputs a
// block of 8 warps (64 x 32 a warp, m16n8k16 fragments, 64 f32 accumulators
// a thread), the contraction staged 32 deep by 16-byte cp.async in 2 stages
// (rows padded by 8 bf16, so ldmatrix is free of bank conflicts;
// ldmatrix.trans for operands contiguous along the output axis: wd in the
// forward, xd and dY in dW). The forward's epilogue stores the f32
// accumulators (8-byte pairs where N is even); the backward's recomputes u
// from x / w and reduces the scale sums in a fixed order (in the thread, a
// fixed shuffle tree, then shared memory in warp order). Two launches give
// the same bits, and there are no float atomics. Products of exact bf16
// values summed in f32 differ from any other order only inside the f32
// order bound.
//
// f32 cotangents on the tensor cores: an f32 x bf16 product is not exact in
// bf16, and TF32 (10 mantissa bits) is not allowed. So the prologue splits
// each f32 cotangent exactly into three bf16 planes (split3): hi = bf16(y),
// mid = bf16(y - hi), lo = bf16(y - hi - mid), both subtractions exact in
// f32, so hi + mid + lo == y for every finite |y| >= 2^-110. Each plane's
// products with wd (or xd) are exact bf16 x bf16 products, and the tile walks
// the contraction once per plane (hi, mid, lo, in that order) into the same
// f32 accumulators: the same products the f32 tile added, in another order,
// at three times the bf16 work (still ~5x under the f32 SIMT line). Each
// 16-deep mma partial is added with a round-to-nearest f32 add
// (mma_bf16_rn): the tensor core's accumulation truncates, and over the
// head's 3 x 152,064 products its drift alone moved 7 % of the bf16-rounded
// dX off the plain version's (the bar allows 1 %). Where hi
// is not finite, mid = lo = 0, so an Inf or NaN multiplies as in the plain
// version. Below 2^-110, lo is a bf16 subnormal or lost (an error of at most
// 2^-134); an f32 above bf16's largest finite value splits to Inf.
//
// SIMT tile (f32 FMA on bf16 values held in f32, exact products): the
// combined backward, 2D and per expert, for f32 cotangents (the 2D form on
// the untied heads narrow enough for the combined route: musicgen-medium's,
// paper-deit-t's). 128 x 128 outputs a block of 256 threads, 8 x 8 a
// thread, the contraction walked 8 at a time through shared memory, the next
// slice's loads in flight while the current one is multiplied; each operand
// is dequantized as it is staged.
//
// Left for later: the f32 combined backward onto the three planes (then the
// SIMT tile can go); wgmma and TMA, a persistent grid and more stages for the
// tensor-core tile (the 128 x 128 mma.sync tile runs at a fraction of the 989
// TFLOP/s peak); a split contraction for the one-wave dX grid of the head.
//
// What differs from the TPU design, and why:
//   * No carried accumulators: the TPU grid runs in order and carries dX / dW
//     and the scale sums across grid steps; here a block loops over the whole
//     contraction for its output tile.
//   * The dequantized operands reach HBM on the tensor-core path (the TPU
//     kernels keep them in VMEM): on this card the bytes are the cheap side.
//   * Scale cotangents without atomics: each block writes its partial sums
//     (dsa/dba per block; dws per column over the block's rows, or per row over
//     its columns) to a scratch the wrapper allocates, and one finish kernel adds
//     them in a fixed order, so every result is the same from run to run.
//   * The combined backward is one grid whose first blocks compute dX tiles and
//     whose other blocks compute dW tiles, through the same device code as the
//     split kernels, so the two routes give identical bits for bf16
//     cotangents. The TPU's (bk, Np) VMEM panel has no counterpart.
//   * Edges are masked in the kernel (and the scratch's pad is zero); the
//     operands are not padded.
//   * The batched (MoE expert) kernels put the expert on blockIdx.z (the
//     prologue on blockIdx.y): a block offsets every per-expert operand (x, w,
//     the (E,) activation scale and offset, the (E, N) column scales, dY, the
//     scratch, the outputs and the partials) by its expert and then runs the
//     same tile as the 2D kernel, so an expert's results are bit for bit those
//     of the 2D kernels on its slices. The finish pass runs one row of blocks
//     per expert (blockIdx.y). Expert weight scales are N-side only (the
//     reference's eligibility rule), so the batched kernels take no row
//     scales. At the MoE training shapes (32 experts x 1280 capacity rows, K
//     and N of 512 / 1024) each expert is 40 forward output tiles, 1280
//     blocks a launch, and 112 backward tiles (80 dX + 32 dW at K 1024, N
//     512), 3584 blocks a launch.
// Numerics: round half to even (rintf), IEEE division (built without fast math),
// and the multiply and add of the dequantization rounded separately (no FMA
// contraction), as the reference writes them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 128;          // output rows of a block tile
constexpr int BN = 128;          // output columns of a block tile
constexpr int BK = 8;            // contraction slice staged per step
constexpr int FOLD = 128;        // SIMT contraction rows summed before a fold (multiple of BK)
constexpr int NT = 256;          // threads a block: 16 x 16, 8 x 8 outputs each
constexpr int PAD = 4;           // keeps the staging stores free of bank conflicts
constexpr float EPS = 1e-9f;
static_assert(FOLD % BK == 0, "a fold ends a staged slice");

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
// rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns likewise with tx. Each
// FOLD-deep chunk of the contraction is summed by FMA from zero and then added
// to a running total (the last, partial chunk too). One f32 accumulator over
// a long contraction (12,608 at paper-deit-t's head, dW) drifts far enough
// that bf16(dW) leaves its correctly rounded value more often than the plain
// version's does (phase 5 of chip_smoke.py prints both shares).
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
  float tot[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) tot[r][c] = 0.f;
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
    if ((l0 + BK) % FOLD == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          tot[r][c] = __fadd_rn(tot[r][c], acc[r][c]);
          acc[r][c] = 0.f;
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = __fadd_rn(tot[r][c], acc[r][c]);
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
// The SIMT backward tiles
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The tensor-core path: the forward (qat_fwd_tc_launch, 2D and per expert)
// and the backward for bf16 cotangents (qat_bwd_tc_launch). A prologue
// writes xd (M, ld_x), wd (K, ld_w) and, for the backward, bf16(dY) (M, ld_y)
// once, each leading dimension a multiple of 8 with its pad zeroed; the tile
// then runs a plain bf16 GEMM: 16-byte cp.async into 2 stages of 32-deep
// slices, ldmatrix, and mma.sync m16n8k16 with f32 accumulators.
// ---------------------------------------------------------------------------

struct TcOp {  // a bf16 scratch array (rows, ld), ld % 8 == 0, 16-byte aligned
  const __nv_bfloat16* p;
  int rows, ld;
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// row[c0 .. c0 + 8) as f32 (0 past `cols`), 16-byte loads where aligned.
__device__ __forceinline__ void load8(const float* row, int c0, int cols, float (&v)[8]) {
  if (c0 + 8 <= cols && aligned16(row + c0)) {
    const float4 p = *reinterpret_cast<const float4*>(row + c0);
    const float4 q = *reinterpret_cast<const float4*>(row + c0 + 4);
    v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
    v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c0 + e < cols ? row[c0 + e] : 0.f;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* row, int c0, int cols,
                                      float (&v)[8]) {
  if (c0 + 8 <= cols && aligned16(row + c0)) {
    const uint4 p = *reinterpret_cast<const uint4*>(row + c0);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&p);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = c0 + e < cols ? __bfloat162float(row[c0 + e]) : 0.f;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  uint4 o;
  uint32_t* u = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    u[e] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = o;
}

// The exact three-plane split of an f32 cotangent (the contract of
// ref.cotangent_planes): hi = bf16(y); where hi is not finite mid = lo = 0,
// else mid = bf16(y - hi) and lo = bf16(y - hi - mid), both subtractions
// exact in f32. Each value is bf16-exact, so store8 keeps it as it is.
__device__ __forceinline__ void split3(float y, float& hi, float& mid, float& lo) {
  hi = bf16r(y);
  if (!isfinite(hi)) {
    mid = lo = 0.f;
    return;
  }
  const float r = __fsub_rn(y, hi);
  mid = bf16r(r);
  lo = bf16r(__fsub_rn(r, mid));
}

// One grid-stride pass over the arrays in chunks of 8 elements of a row: the
// same act_deq / w_deq / bf16 rounding as the SIMT tile's staging, so the
// values are those the SIMT kernels multiply, bit for bit. An operand whose
// pointer is null is skipped: dY for the forward, xd for dX alone, wd for dW
// alone. dY is written as `planes` consecutive (M, ld_y) planes: bf16(dY)
// for one, split3's hi, mid and lo for three. Expert e = blockIdx.y (0 for
// the 2D kernels) reads its own operands and scales and writes its own
// slices.
template <class XT>
__global__ void __launch_bounds__(NT) qat_prologue_kernel(Args a, __nv_bfloat16* xd, int ld_x,
                                                          __nv_bfloat16* wd, int ld_w,
                                                          __nv_bfloat16* dyb, int ld_y,
                                                          int planes) {
  const size_t e = blockIdx.y;
  a = at_expert<XT>(a, (int)e);
  if (xd != nullptr) xd += e * a.M * ld_x;
  if (wd != nullptr) wd += e * a.K * ld_w;
  if (dyb != nullptr) dyb += e * planes * a.M * ld_y;
  const float s = fmaxf(*a.a_s, EPS), b = *a.a_b;
  const WQ wq = a.wq();
  const XT* x = static_cast<const XT*>(a.x);
  const size_t px = ld_x / 8, pw = ld_w / 8, py = ld_y / 8;
  const size_t plane = (size_t)a.M * ld_y;
  const size_t cx = xd != nullptr ? (size_t)a.M * px : 0;
  const size_t cw = wd != nullptr ? (size_t)a.K * pw : 0;
  const size_t cy = dyb != nullptr ? (size_t)a.M * py : 0;
  for (size_t c = (size_t)blockIdx.x * NT + threadIdx.x; c < cx + cw + cy;
       c += (size_t)gridDim.x * NT) {
    float v[8];
    if (c < cx) {
      const int r = (int)(c / px), c0 = (int)(c % px) * 8;
      load8(x + (size_t)r * a.K, c0, a.K, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = c0 + e < a.K ? act_deq(v[e], s, b, a.qa) : 0.f;
      store8(xd + (size_t)r * ld_x + c0, v);
    } else if (c < cx + cw) {
      const size_t cc = c - cx;
      const int r = (int)(cc / pw), c0 = (int)(cc % pw) * 8;
      load8(a.w + (size_t)r * a.N, c0, a.N, v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = c0 + e < a.N ? w_deq(v[e], wq.scale(r, c0 + e), a.qw) : 0.f;
      store8(wd + (size_t)r * ld_w + c0, v);
    } else {
      const size_t cc = c - cx - cw;
      const int r = (int)(cc / py), c0 = (int)(cc % py) * 8;
      __nv_bfloat16* dst = dyb + (size_t)r * ld_y + c0;
      load8(a.dy + (size_t)r * a.N, c0, a.N, v);  // 0 past N: every plane's pad is 0
      if (planes == 3) {
        float mid[8], lo[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) split3(v[e], v[e], mid[e], lo[e]);
        store8(dst + plane, mid);
        store8(dst + 2 * plane, lo);
      }
      store8(dst, v);  // hi, or (one plane) dY rounded to bf16 by store8
    }
  }
}

constexpr int TC_BK = 32;                  // contraction slice a stage
constexpr int TC_STAGES = 2;
constexpr int TC_LS = TC_BK + 8;           // row stride of an L-contiguous slice [128][40]
constexpr int TC_TS = BM + 8;              // row stride of a transposed slice [32][136]
constexpr int TC_OPND = BM * TC_LS;        // bf16 elements an operand a stage (>= 32 * 136)
static_assert(TC_BK * TC_TS <= TC_OPND, "operand slot too small");
static_assert(4 * BM * 4 <= TC_STAGES * 2 * TC_OPND * 2, "epilogue buffer does not fit");

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the contraction slice [l0, l0 + 32) of an operand whose output index
// o runs over [o0, o0 + 128). TRANS = false: the scratch rows are o and the
// slice is contiguous along l, staged [o][l]; TRANS = true: the scratch rows
// are l, staged [l][o]. Rows past `rows` and 8-element chunks past `ld` are
// zero-filled (ld % 8 == 0, so a chunk is all in or all out).
template <bool TRANS>
__device__ __forceinline__ void tc_stage(const TcOp& op, int o0, int l0, __nv_bfloat16* dst) {
#pragma unroll
  for (int p = 0; p < BM * TC_BK / 8 / NT; ++p) {
    const int c = threadIdx.x + p * NT;
    int r, col, off;
    if (TRANS) {  // 32 rows of 16 chunks
      r = l0 + c / 16;
      col = o0 + (c % 16) * 8;
      off = (c / 16) * TC_TS + (c % 16) * 8;
    } else {      // 128 rows of 4 chunks
      r = o0 + c / 4;
      col = l0 + (c % 4) * 8;
      off = (c / 4) * TC_LS + (c % 4) * 8;
    }
    const bool valid = r < op.rows && col < op.ld;
    cp_async16(dst + off, valid ? op.p + (size_t)r * op.ld + col : op.p, valid);
  }
}

// Plane p of a scratch array of consecutive (rows, ld) planes.
__device__ __forceinline__ TcOp tc_plane(const TcOp& op, int p) {
  return TcOp{op.p + (size_t)p * op.rows * op.ld, op.rows, op.ld};
}

// acc[mf][nf][e] = sum_l A(i, l) B(l, j) over l < L for the block's 128 x 128
// tile at (i0, j0); warp w owns rows (w / 4) * 64 + mf * 16 + [0, 16) and
// columns (w % 4) * 32 + nf * 8 + [0, 8), in the m16n8 accumulator layout.
// PA / PB > 1: that operand is PA (PB) consecutive planes (the cotangent's
// split), and the contraction is walked once per plane, in plane order,
// into the same accumulators, the other operand read again for each; the
// pipeline runs on across the planes' seams. The planes' sums (f32
// cotangents, the head's long contraction) add each 16-deep product to the
// accumulators with round-to-nearest adds (mma_bf16_rn).
template <bool A_T, bool B_T, int PA = 1, int PB = 1>
__device__ __forceinline__ void tc_gemm(const TcOp& A, const TcOp& B, int i0, int j0, int L,
                                        float (&acc)[4][4][4], __nv_bfloat16* sm) {
  static_assert(PA == 1 || PB == 1, "planes in one operand only");
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int wi = (w / 4) * 64, wj = (w % 4) * 32;
  const int q = lane / 8, r = lane % 8;
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
  const int nl = (L + TC_BK - 1) / TC_BK;  // slices a plane
  const int nk = nl * PA * PB;              // slices of the whole walk
  auto stage = [&](int kt, __nv_bfloat16* st) {
    int p = 0, l = kt;  // one plane: no division in the loop
    if (PA * PB > 1) {
      p = kt / nl;
      l = kt - p * nl;
    }
    tc_stage<A_T>(PA > 1 ? tc_plane(A, p) : A, i0, l * TC_BK, st);
    tc_stage<B_T>(PB > 1 ? tc_plane(B, p) : B, j0, l * TC_BK, st + TC_OPND);
  };
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) stage(s, sm + s * 2 * TC_OPND);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();  // slice kt has landed; the stage refilled below is free
    const int nxt = kt + TC_STAGES - 1;
    if (nxt < nk) stage(nxt, sm + (nxt % TC_STAGES) * 2 * TC_OPND);
    cp_async_commit();
    const __nv_bfloat16* As = sm + (kt % TC_STAGES) * 2 * TC_OPND;
    const __nv_bfloat16* Bs = As + TC_OPND;
#pragma unroll
    for (int ks = 0; ks < TC_BK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int mf = 0; mf < 4; ++mf) {
        const int i = wi + mf * 16;
        if (A_T) ldsm_x4<true>(af[mf], As + (ks + (q >> 1) * 8 + r) * TC_TS + i + (q & 1) * 8);
        else ldsm_x4<false>(af[mf], As + (i + (q & 1) * 8 + r) * TC_LS + ks + (q >> 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int j = wj + np * 16;
        uint32_t t4[4];
        if (B_T) ldsm_x4<true>(t4, Bs + (ks + (q & 1) * 8 + r) * TC_TS + j + (q >> 1) * 8);
        else ldsm_x4<false>(t4, Bs + (j + (q >> 1) * 8 + r) * TC_LS + ks + (q & 1) * 8);
        bf[2 * np][0] = t4[0];
        bf[2 * np][1] = t4[1];
        bf[2 * np + 1][0] = t4[2];
        bf[2 * np + 1][1] = t4[3];
      }
#pragma unroll
      for (int mf = 0; mf < 4; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          if (PA * PB > 1) mma_bf16_rn(acc[mf][nf], af[mf], bf[nf][0], bf[nf][1]);
          else mma_bf16(acc[mf][nf], af[mf], bf[nf][0], bf[nf][1]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages: sm is free
}

// Sum of v over the lanes whose index differs only in the bits lo..hi (powers
// of two), by a fixed butterfly: every such lane ends with the same bits.
__device__ __forceinline__ float lane_sum(float v, int lo, int hi) {
  for (int o = lo; o <= hi; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Accumulator element (mf, nf, e) of this thread: tile row / column.
__device__ __forceinline__ int tc_row(int mf, int e) {
  return ((threadIdx.x / 32) / 4) * 64 + mf * 16 + (threadIdx.x % 32) / 4 + (e >> 1) * 8;
}
__device__ __forceinline__ int tc_col(int nf, int e) {
  return ((threadIdx.x / 32) % 4) * 32 + nf * 8 + 2 * (threadIdx.x % 4) + (e & 1);
}

// dX tile (rows m, columns k; contraction over n): A = dyb (P planes),
// B(n, k) = wd(k, n).
template <class XT, int P>
__device__ __forceinline__ void dx_tc_tile(const Args& a, const TcOp& wd, const TcOp& dyb,
                                           float* dx, float* part, int blk,
                                           __nv_bfloat16* sm) {
  const int n_i = (a.M + BM - 1) / BM;
  const int i0 = (blk % n_i) * BM, j0 = (blk / n_i) * BN;
  float acc[4][4][4];
  tc_gemm<false, false, P, 1>(dyb, wd, i0, j0, a.N, acc, sm);
  const float s = fmaxf(*a.a_s, EPS), b = *a.a_b;
  const XT* x = static_cast<const XT*>(a.x);
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = i0 + tc_row(mf, e), k = j0 + tc_col(nf, e);
        if (m < a.M && k < a.K) {
          const size_t at = (size_t)m * a.K + k;
          const float dxd = bf16r(acc[mf][nf][e]);
          const float u = __fdiv_rn(__fsub_rn(ld(x, at), b), s);
          const float mfl = a.qa.in_range(u);
          const float qc = a.qa.code(u);
          dx[at] = __fmul_rn(dxd, mfl);
          sa = __fadd_rn(sa, __fmul_rn(dxd, __fsub_rn(qc, __fmul_rn(mfl, u))));
          sb = __fadd_rn(sb, __fmul_rn(dxd, __fsub_rn(1.f, mfl)));
        }
      }
  sa = lane_sum(sa, 1, 16);
  sb = lane_sum(sb, 1, 16);
  float* red = reinterpret_cast<float*>(sm);
  const int w = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[2 * w] = sa;
    red[2 * w + 1] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = 0.f, tb = 0.f;
    for (int i = 0; i < NT / 32; ++i) {
      ta += red[2 * i];
      tb += red[2 * i + 1];
    }
    part[2 * blk] = ta;
    part[2 * blk + 1] = tb;
  }
}

// dW tile (rows k, columns n; contraction over m): A(k, m) = xd(m, k) and
// B(m, n) = dyb(m, n) (P planes), both staged transposed. dws partials as
// dw_tile's.
template <int P>
__device__ __forceinline__ void dw_tc_tile(const Args& a, const TcOp& xd, const TcOp& dyb,
                                           float* dw, float* part, int blk,
                                           __nv_bfloat16* sm) {
  const int n_i = (a.K + BM - 1) / BM;
  const int bi = blk % n_i, bj = blk / n_i;
  const int i0 = bi * BM, j0 = bj * BN;
  float acc[4][4][4];
  tc_gemm<true, true, 1, P>(xd, dyb, i0, j0, a.M, acc, sm);
  const WQ wq = a.wq();
  float rsum[4][2], csum[4][2];  // [mf][row half], [nf][column parity]
#pragma unroll
  for (int f = 0; f < 4; ++f) rsum[f][0] = rsum[f][1] = csum[f][0] = csum[f][1] = 0.f;
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = i0 + tc_row(mf, e), n = j0 + tc_col(nf, e);
        if (k < a.K && n < a.N) {
          const size_t at = (size_t)k * a.N + n;
          const float dwd = bf16r(acc[mf][nf][e]);
          const float u = __fdiv_rn(a.w[at], wq.scale(k, n));
          const float mfl = a.qw.in_range(u);
          const float qc = a.qw.code(u);
          dw[at] = __fmul_rn(dwd, mfl);
          const float p = __fmul_rn(dwd, __fsub_rn(qc, __fmul_rn(mfl, u)));
          rsum[mf][e >> 1] = __fadd_rn(rsum[mf][e >> 1], p);
          csum[nf][e & 1] = __fadd_rn(csum[nf][e & 1], p);
        }
      }
  float* red = reinterpret_cast<float*>(sm);  // [4][BM]: one row a warp column / row
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  if (a.k_side) {  // per row: over the 4 lanes of a row, then the 4 warps of a row band
#pragma unroll
    for (int mf = 0; mf < 4; ++mf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = lane_sum(rsum[mf][h], 1, 2);
        if (lane % 4 == 0) red[(w % 4) * BM + tc_row(mf, 2 * h)] = v;
      }
  } else {         // per column: over the 8 lanes of a column, then the 2 warps
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = lane_sum(csum[nf][e], 4, 16);
        if (lane < 4) red[(w / 4) * BM + tc_col(nf, e)] = v;
      }
  }
  __syncthreads();
  if (threadIdx.x < BM) {
    const int t = threadIdx.x;
    if (a.k_side) {
      const float v = ((red[t] + red[BM + t]) + red[2 * BM + t]) + red[3 * BM + t];
      if (i0 + t < a.K) part[(size_t)bj * a.K + i0 + t] = v;
    } else {
      const float v = red[t] + red[BM + t];
      if (j0 + t < a.N) part[(size_t)bi * a.N + j0 + t] = v;
    }
  }
}

// Blocks [0, n_dx) are dX tiles, the rest dW tiles (as qat_bwd_kernel).
// EXPERTS (the batched backward): expert e = blockIdx.z advances every
// per-expert operand (Args by at_expert, the three scratch arrays, dX, dW
// and its 2 * n_dx dX and n_wpart dws partials, the layout qat_finish_kernel
// reads per blockIdx.y) to its slice, then runs the 2D tile code, so its
// bits are the 2D kernel's on those slices. A separate instance, so the 2D
// kernel's code is unchanged and a profile names the two apart.
template <class XT, bool EXPERTS>
__global__ void __launch_bounds__(NT, 2) qat_bwd_tc_kernel(Args a, TcOp xd, TcOp wd, TcOp dyb,
                                                           float* dx, float* part_x, float* dw,
                                                           float* part_w, int n_dx, int n_wpart) {
  __shared__ __align__(128) __nv_bfloat16 sm[TC_STAGES * 2 * TC_OPND];
  if (EXPERTS) {
    const size_t e = blockIdx.z;
    a = at_expert<XT>(a, (int)e);
    xd.p += e * xd.rows * xd.ld;
    wd.p += e * wd.rows * wd.ld;
    dyb.p += e * dyb.rows * dyb.ld;
    dx += e * a.M * a.K;
    dw += e * a.K * a.N;
    part_x += e * 2 * n_dx;
    part_w += e * n_wpart;
  }
  if ((int)blockIdx.x < n_dx) dx_tc_tile<XT, 1>(a, wd, dyb, dx, part_x, blockIdx.x, sm);
  else dw_tc_tile<1>(a, xd, dyb, dw, part_w, blockIdx.x - n_dx, sm);
}

// The split backward: the dX grid alone, or the dW grid alone (which reads no
// x, so one instance serves both x types), on P cotangent planes: 1 for
// bf16 cotangents (the combined kernel's tiles, so its bits), 3 for f32.
template <class XT, int P>
__global__ void __launch_bounds__(NT, 2) qat_dx_tc_kernel(Args a, TcOp wd, TcOp dyb, float* dx,
                                                          float* part_x) {
  __shared__ __align__(128) __nv_bfloat16 sm[TC_STAGES * 2 * TC_OPND];
  dx_tc_tile<XT, P>(a, wd, dyb, dx, part_x, blockIdx.x, sm);
}

template <int P>
__global__ void __launch_bounds__(NT, 2) qat_dw_tc_kernel(Args a, TcOp xd, TcOp dyb, float* dw,
                                                          float* part_w) {
  __shared__ __align__(128) __nv_bfloat16 sm[TC_STAGES * 2 * TC_OPND];
  dw_tc_tile<P>(a, xd, dyb, dw, part_w, blockIdx.x, sm);
}

// Forward tile (rows m, columns n; contraction over k): A = xd (M, ld_x),
// B(k, n) = wd (K, ld_w) staged transposed; the accumulators go to out (M,
// N) f32, a thread's two neighbouring columns as one 8-byte store where N
// is even (then every pair starts on an even column, 8-byte aligned).
__device__ __forceinline__ void fwd_tc_tile(const TcOp& xd, const TcOp& wd, int N, float* out,
                                            int blk, __nv_bfloat16* sm) {
  const int M = xd.rows;
  const int n_i = (M + BM - 1) / BM;
  const int i0 = (blk % n_i) * BM, j0 = (blk / n_i) * BN;
  float acc[4][4][4];
  tc_gemm<false, true>(xd, wd, i0, j0, wd.rows, acc, sm);
  const bool pairs = N % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = i0 + tc_row(mf, 2 * h), n = j0 + tc_col(nf, 0);
        if (m >= M || n >= N) continue;
        float* p = out + (size_t)m * N + n;
        const float v0 = acc[mf][nf][2 * h], v1 = acc[mf][nf][2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (n + 1 < N) p[1] = v1;
        }
      }
}

// The forward: expert e = blockIdx.z (0 for the 2D kernel) multiplies its
// slices of the scratch into its slice of out, so its bits are the 2D
// kernel's on those slices.
__global__ void __launch_bounds__(NT, 2) qat_fwd_tc_kernel(TcOp xd, TcOp wd, float* out, int N) {
  __shared__ __align__(128) __nv_bfloat16 sm[TC_STAGES * 2 * TC_OPND];
  const size_t e = blockIdx.z;
  xd.p += e * xd.rows * xd.ld;
  wd.p += e * wd.rows * wd.ld;
  fwd_tc_tile(xd, wd, N, out + e * xd.rows * N, blockIdx.x, sm);
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

// The tensor-core path's scratch: xd (M, ld_x), wd (K, ld_w) and, for the
// backward, dyb (planes, M, ld_y) bf16 (E of each for the batched kernels),
// each leading dimension a multiple of 8 and at least K, N, N, 16-byte
// aligned; the prologue writes them whole (pad included).
namespace {
bool scratch_ok(const void* p, int ld, int cols) {
  return ld >= cols && ld % 8 == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool tc_scratch_ok(int K, int N, const void* xd, int ld_x, const void* wd, int ld_w,
                   const void* dyb, int ld_y) {
  return scratch_ok(xd, ld_x, K) && scratch_ok(wd, ld_w, N) && scratch_ok(dyb, ld_y, N);
}

// Null xd, wd or dyb: that array is not written (as in the kernel).
cudaError_t prologue(const Args& a, int x_bf16, void* xd, int ld_x, void* wd, int ld_w,
                     void* dyb, int ld_y, cudaStream_t st, int experts = 1, int planes = 1) {
  const size_t chunks = ((xd != nullptr ? (size_t)a.M * ld_x : 0) +
                         (wd != nullptr ? (size_t)a.K * ld_w : 0) +
                         (dyb != nullptr ? (size_t)a.M * ld_y : 0)) / 8;
  const dim3 grid((unsigned)(chunks / NT + 1 < 4096 ? chunks / NT + 1 : 4096), experts);
  auto* bx = static_cast<__nv_bfloat16*>(xd);
  auto* bw = static_cast<__nv_bfloat16*>(wd);
  auto* by = static_cast<__nv_bfloat16*>(dyb);
  if (x_bf16)
    qat_prologue_kernel<__nv_bfloat16><<<grid, NT, 0, st>>>(a, bx, ld_x, bw, ld_w, by, ld_y,
                                                            planes);
  else
    qat_prologue_kernel<float><<<grid, NT, 0, st>>>(a, bx, ld_x, bw, ld_w, by, ld_y, planes);
  return cudaGetLastError();
}
}  // namespace

// The backward's prologue: xd (E, M, ld_x), wd (E, K, ld_w) and the
// cotangent's planes (E, planes, M, ld_y): 1 plane, bf16(dY), for bf16
// cotangents; 3, split3's hi / mid / lo, for f32 ones. xd or wd may be null
// (not written: dX alone needs no xd, dW alone no wd). The split backward
// runs it before qat_dx_tc_launch / qat_dw_tc_launch; alone it is a check.
extern "C" int qat_bwd_prologue_launch(const void* dy, const void* x, int x_bf16,
                                       const void* w, const void* a_s, const void* a_b,
                                       const void* ws, int k_side, void* xd, int ld_x,
                                       void* wd, int ld_w, void* dyb, int ld_y, int E, int M,
                                       int K, int N, int qn_a, int qp_a, int qn_w, int qp_w,
                                       int planes, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return 0;
  if ((E > 1 && k_side) || (planes != 1 && planes != 3) || dyb == nullptr ||
      !scratch_ok(dyb, ld_y, N) || (xd != nullptr && !scratch_ok(xd, ld_x, K)) ||
      (wd != nullptr && !scratch_ok(wd, ld_w, N)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, a_s, a_b, ws, dy, M, K, N, k_side, 1, qn_a, qp_a, qn_w, qp_w);
  return static_cast<int>(prologue(a, x_bf16, xd, ld_x, wd, ld_w, dyb, ld_y,
                                   static_cast<cudaStream_t>(stream), E, planes));
}

// The split backward on the tensor cores, 2D: the dX grid (qat_dx_tc_launch:
// dx, dsa, dba from wd and the planes) or the dW grid (qat_dw_tc_launch: dw,
// dws from xd and the planes), each then its finish, on the scratch that
// qat_bwd_prologue_launch wrote with the same plane count (1 or 3). The
// operands are qat_bwd_launch's (the tile's epilogue reads x or w and the
// scales); part_x / part_w as there.
extern "C" int qat_dx_tc_launch(const void* x, int x_bf16, const void* w, const void* a_s,
                                const void* a_b, const void* ws, int k_side, void* dx, void* dsa,
                                void* dba, void* part_x, const void* wd, int ld_w,
                                const void* dyb, int ld_y, int M, int K, int N, int qn_a,
                                int qp_a, int qn_w, int qp_w, int planes, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  if ((planes != 1 && planes != 3) || !scratch_ok(wd, ld_w, N) || !scratch_ok(dyb, ld_y, N))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, a_s, a_b, ws, nullptr, M, K, N, k_side, 1, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TcOp owd{static_cast<const __nv_bfloat16*>(wd), K, ld_w};
  const TcOp ody{static_cast<const __nv_bfloat16*>(dyb), M, ld_y};
  float* px = static_cast<float*>(part_x);
  float* fdx = static_cast<float*>(dx);
  const int grid = n_dx_blocks(a);
  if (x_bf16 && planes == 3)
    qat_dx_tc_kernel<__nv_bfloat16, 3><<<grid, NT, 0, st>>>(a, owd, ody, fdx, px);
  else if (x_bf16)
    qat_dx_tc_kernel<__nv_bfloat16, 1><<<grid, NT, 0, st>>>(a, owd, ody, fdx, px);
  else if (planes == 3)
    qat_dx_tc_kernel<float, 3><<<grid, NT, 0, st>>>(a, owd, ody, fdx, px);
  else
    qat_dx_tc_kernel<float, 1><<<grid, NT, 0, st>>>(a, owd, ody, fdx, px);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(a, px, static_cast<float*>(dsa), static_cast<float*>(dba),
                                 nullptr, nullptr, st));
}

extern "C" int qat_dw_tc_launch(const void* x, int x_bf16, const void* w, const void* a_s,
                                const void* a_b, const void* ws, int k_side, void* dw, void* dws,
                                void* part_w, const void* xd, int ld_x, const void* dyb,
                                int ld_y, int M, int K, int N, int qn_a, int qp_a, int qn_w,
                                int qp_w, int planes, void* stream) {
  if (K <= 0 || N <= 0) return 0;
  if ((planes != 1 && planes != 3) || !scratch_ok(xd, ld_x, K) || !scratch_ok(dyb, ld_y, N))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, a_s, a_b, ws, nullptr, M, K, N, k_side, 1, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const TcOp oxd{static_cast<const __nv_bfloat16*>(xd), M, ld_x};
  const TcOp ody{static_cast<const __nv_bfloat16*>(dyb), M, ld_y};
  float* pw = static_cast<float*>(part_w);
  float* fdw = static_cast<float*>(dw);
  const int grid = n_dw_blocks(a);
  if (planes == 3) qat_dw_tc_kernel<3><<<grid, NT, 0, st>>>(a, oxd, ody, fdw, pw);
  else qat_dw_tc_kernel<1><<<grid, NT, 0, st>>>(a, oxd, ody, fdw, pw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(a, nullptr, nullptr, nullptr, pw, static_cast<float*>(dws),
                                 st));
}

// The combined backward on the tensor cores for bf16 cotangents only
// (round_cot = 1): qat_bwd_launch's parameters plus the three scratch arrays
// xd (E, M, ld_x), wd (E, K, ld_w), dyb (E, M, ld_y) and the expert count:
// 2D (E = 1) or per expert (E > 1: the operands, outputs and partials of
// qat_bwd_batched_launch, column scales only). Prologue (the expert on
// blockIdx.y), tile (on blockIdx.z), finish (on blockIdx.y).
extern "C" int qat_bwd_tc_launch(const void* dy, const void* x, int x_bf16, const void* w,
                                 const void* a_s, const void* a_b, const void* ws, int k_side,
                                 void* dx, void* dsa, void* dba, void* dw, void* dws,
                                 void* part_x, void* part_w, void* xd, int ld_x, void* wd,
                                 int ld_w, void* dyb, int ld_y, int E,
                                 int M, int K, int N, int qn_a, int qp_a, int qn_w, int qp_w,
                                 int round_cot, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return 0;
  if (!round_cot || (E > 1 && k_side) || dyb == nullptr ||
      !tc_scratch_ok(K, N, xd, ld_x, wd, ld_w, dyb, ld_y))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, a_s, a_b, ws, dy, M, K, N, k_side, 1, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prologue(a, x_bf16, xd, ld_x, wd, ld_w, dyb, ld_y, st, E);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TcOp oxd{static_cast<const __nv_bfloat16*>(xd), M, ld_x};
  const TcOp owd{static_cast<const __nv_bfloat16*>(wd), K, ld_w};
  const TcOp ody{static_cast<const __nv_bfloat16*>(dyb), M, ld_y};
  float* px = static_cast<float*>(part_x);
  float* pw = static_cast<float*>(part_w);
  float* fdx = static_cast<float*>(dx);
  float* fdw = static_cast<float*>(dw);
  const int n_dx = n_dx_blocks(a);
  const int n_wpart = n_wp(a) * wp_len(a);
  const dim3 grid(n_dx + n_dw_blocks(a), 1, E);
  if (x_bf16 && E > 1)
    qat_bwd_tc_kernel<__nv_bfloat16, true><<<grid, NT, 0, st>>>(a, oxd, owd, ody, fdx, px, fdw,
                                                                pw, n_dx, n_wpart);
  else if (x_bf16)
    qat_bwd_tc_kernel<__nv_bfloat16, false><<<grid, NT, 0, st>>>(a, oxd, owd, ody, fdx, px, fdw,
                                                                 pw, n_dx, n_wpart);
  else if (E > 1)
    qat_bwd_tc_kernel<float, true><<<grid, NT, 0, st>>>(a, oxd, owd, ody, fdx, px, fdw, pw,
                                                        n_dx, n_wpart);
  else
    qat_bwd_tc_kernel<float, false><<<grid, NT, 0, st>>>(a, oxd, owd, ody, fdx, px, fdw, pw,
                                                         n_dx, n_wpart);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(a, px, static_cast<float*>(dsa), static_cast<float*>(dba),
                                 pw, static_cast<float*>(dws), st, E));
}

// The forward on the tensor cores, 2D (E = 1, the operands above, out (M,
// N)) or per expert (E > 1: x (E, M, K), w (E, K, N), a_s / a_b (E,), ws
// (E, N) column scales, out (E, M, N)), with the two scratch arrays xd (E,
// M, ld_x) and wd (E, K, ld_w): prologue, then tile.
extern "C" int qat_fwd_tc_launch(const void* x, int x_bf16, const void* w, const void* a_s,
                                 const void* a_b, const void* ws, int k_side, void* out,
                                 void* xd, int ld_x, void* wd, int ld_w, int E, int M, int K,
                                 int N, int qn_a, int qp_a, int qn_w, int qp_w, void* stream) {
  if (E <= 0 || M <= 0 || N <= 0) return 0;
  if ((E > 1 && k_side) || !scratch_ok(xd, ld_x, K) || !scratch_ok(wd, ld_w, N))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, a_s, a_b, ws, nullptr, M, K, N, k_side, 0, qn_a, qp_a, qn_w, qp_w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = prologue(a, x_bf16, xd, ld_x, wd, ld_w, nullptr, 0, st, E);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TcOp oxd{static_cast<const __nv_bfloat16*>(xd), M, ld_x};
  const TcOp owd{static_cast<const __nv_bfloat16*>(wd), K, ld_w};
  const dim3 grid(cdiv(M, BM) * cdiv(N, BN), 1, E);
  qat_fwd_tc_kernel<<<grid, NT, 0, st>>>(oxd, owd, static_cast<float*>(out), N);
  return static_cast<int>(cudaGetLastError());
}

// The forward's prologue alone (for checks): qat_fwd_tc_launch's scratch.
extern "C" int qat_fwd_prologue_launch(const void* x, int x_bf16, const void* w,
                                       const void* a_s, const void* a_b, const void* ws,
                                       int k_side, void* xd, int ld_x, void* wd, int ld_w,
                                       int E, int M, int K, int N, int qn_a, int qp_a,
                                       int qn_w, int qp_w, void* stream) {
  if (E <= 0 || M <= 0 || K <= 0 || N <= 0) return 0;
  if ((E > 1 && k_side) || !scratch_ok(xd, ld_x, K) || !scratch_ok(wd, ld_w, N))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, w, a_s, a_b, ws, nullptr, M, K, N, k_side, 0, qn_a, qp_a, qn_w, qp_w);
  return static_cast<int>(prologue(a, x_bf16, xd, ld_x, wd, ld_w, nullptr, 0,
                                   static_cast<cudaStream_t>(stream), E));
}

// The batched (per-expert) backward on the SIMT tile, for f32 cotangents
// (bf16 cotangents take qat_bwd_tc_launch with E > 1): x (E, M, K) bf16 or
// f32, w (E, K, N) f32, a_s / a_b (E,) f32, ws (E, N) f32 column scales, dy
// (E, M, N) f32; outputs f32 dx (E, M, K), dsa / dba (E,), dw (E, K, N), dws
// (E, N). Scratch: part_x E * 2 * qat_dx_blocks floats, part_w E * cdiv(K,
// 128) * N.

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
