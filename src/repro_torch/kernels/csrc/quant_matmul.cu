// Serving matmuls over int-coded weights: out = x @ bf16(code * max(col_scale, 1e-9)).
//
// Replaces the TPU kernels int_matmul (src/repro/kernels/quant_matmul.py:819,
// body `kernel` :834) and int4_matmul (:863, body `kernel` :883) of the JAX
// package. Numerics, as in the TPU kernels: x is bf16 (the wrapper casts), the
// weight is dequantized as one f32 product rounded to f32 and then once to
// bf16, and the bf16 x bf16 products, exact in f32, are summed in f32.
//
// What bounds both on an H100: decode runs at M = n_slots (4), so every weight
// byte feeds only 4 (int8) or 8 (int4) multiply-adds and the kernels are bound
// by the code bytes they stream from HBM (0.5 or 1 byte a weight at 3.35 TB/s),
// far below the tensor-core line; the dequantization (several integer and f32
// operations a weight) is the other limit. Every output row's bits depend
// on (K, N) alone, never on M: the engine's stream-equality contract.
//
// Both run on the tensor cores. int4_matmul (nibble-packed codes: byte p of a
// column holds row 2p in the low nibble and row 2p+1 in the high nibble, two's
// complement): mma.sync m16n8k16 with the dequantized weight as the A operand (16
// output columns x 16 k) and the tokens as the n = 8 side, so decode (M <= 8)
// is one n-tile and prefill carries 4 n-tiles over the same dequantized
// weights. A warp owns 128 output columns: lane (r, c) loads 16 contiguous
// code bytes (columns 16r..16r+15) of byte rows c and c + 4 of each 16-deep
// step with one 16-byte load each, so a warp's load covers 4 rows x 128
// contiguous bytes; mma row r of tile t is column 16r + 2t, row r + 8 column
// 16r + 2t + 1, and the byte's two nibbles are exactly the fragment's k pair,
// so no byte is moved between lanes. Dequantization is in registers: the
// biased nibble (code + 8) goes into the mantissa of 2^23 by a byte permute,
// one f32 subtraction gives the code exactly, one f32 product by the column
// scale and a packed round to bf16 give the rule's value (no integer-to-float
// conversion instruction). Each 16-deep mma partial is added to the running
// f32 sum with a round-to-nearest add (mma_bf16_rn): the tensor core's own
// accumulation truncates, and w_out's contraction is 14,336 deep.
//
// The grid fills the card without depending on M: a block is 8 warps on one
// 128-column tile, and the contraction is cut into `splits` ranges of
// `ksteps_per_split` 16-deep steps (the wrapper's plan, `int4_plan`, a
// function of (K, N) only). Warp w of a block takes steps w, w + 8, ... of its
// range in order; the 8 warp sums are added in warp order through shared
// memory; with more than one split each block writes its sums to f32 scratch
// and the last block of a tile to arrive (an integer ticket, reset by that
// block) adds the splits in split order. No float atomics: the bits repeat.
//
// int_matmul (int8 codes: w8a8 models' N-side linears, untied 8-bit heads)
// is the same design with one code a byte, so a code byte is one k of the A
// fragment: lane (r, c) loads byte rows 2c, 2c + 1, 2c + 8 and 2c + 9 of each
// 16-deep step (k of its A registers), CW contiguous bytes (columns
// CW r .. CW r + CW - 1) of each, and an A register pairs the two rows' bytes
// of one column; mma row r of tile t is column CW r + 2t, row r + 8 column
// CW r + 2t + 1. The byte is biased by x ^ 0x80 (code + 128), put into the
// mantissa of 2^23 by the same byte permute, and 2^23 + 128 is taken off.
// Decode (M <= 8, one n-tile) takes CW = 16 (128-column blocks); prefill
// (four n-tiles) CW = 8 (64 columns), which halves a lane's accumulators
// and keeps two blocks an SM. A block's width never changes an element's
// sum: that is the plan (int4_plan, shared), the warps' step order and the
// split order.
//
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"
#include "quant.cuh"

namespace {

// ---------------------------------------------------------------------------
// int4_matmul: nibble-packed codes, tensor cores
// ---------------------------------------------------------------------------

constexpr int Q4_WARPS = 8;
constexpr int Q4_THREADS = Q4_WARPS * 32;
constexpr int Q4_BN = 128;  // output columns of a block (each warp's too)
constexpr int Q4_STEP = 8;  // code byte rows (16 k) of one mma step

// 16 code bytes, streamed past L1 (each is read once a call).
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// Code bytes of byte row kb, columns n0 .. n0 + 15; zeros past KB or N. VEC:
// N % 16 == 0 and the codes 16-byte aligned, so a 16-column group is all in
// or all out.
template <bool VEC>
__device__ __forceinline__ uint4 load_codes(const int8_t* codes, int kb, int n0, int KB, int N) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (kb >= KB || n0 >= N) return v;
  const int8_t* row = codes + (size_t)kb * N + n0;
  if (VEC) return ld_stream16(row);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n0 + j < N)
      w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[j])) << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The code in byte j of `biased` (each byte holds a code + BIAS: 8 for a
// nibble, 128 for an int8 code) as an f32, exactly: the byte goes into the
// low mantissa of 2^23 and 2^23 + BIAS is taken off.
template <int BIAS>
__device__ __forceinline__ float code_f32(uint32_t biased, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)),
                   static_cast<float>(8388608 + BIAS));
}

// The mma A register of the codes in byte j of two biased words (lo = the
// even k, the register's low half): bf16(f32(code) * s) each.
template <int BIAS>
__device__ __forceinline__ uint32_t deq_pair(uint32_t lo, uint32_t hi, int j, float s) {
  return pack_bf16(__fmul_rn(code_f32<BIAS>(lo, j), s), __fmul_rn(code_f32<BIAS>(hi, j), s));
}

// The end of both serving kernels. red holds each warp's sums of the block's
// TOK x BN outputs ([warp][token][column], f32), written just before the
// call. The 8 warp sums are added in warp order; with one split they are the
// outputs, else the block writes them to its split's slice of part and the
// last block of its (column tile, token tile) to arrive (an integer ticket,
// reset by that block) adds the splits in split order.
template <int TOK, int BN>
__device__ __forceinline__ void finish_tile(const float* red, float* __restrict__ out,
                                            float* __restrict__ part, int* __restrict__ tickets,
                                            int M, int N, int m0, int n_tile) {
  __shared__ int last;
  const int split = blockIdx.y, splits = gridDim.y;
  __syncthreads();
  float* dst = splits > 1 ? part + (size_t)split * M * N : out;
  for (int i = threadIdx.x; i < TOK * BN; i += Q4_THREADS) {
    const int m = m0 + i / BN, n = n_tile + i % BN;
    float v = red[i];
#pragma unroll
    for (int wp = 1; wp < Q4_WARPS; ++wp) v += red[wp * TOK * BN + i];
    if (m < M && n < N) dst[(size_t)m * N + n] = v;
  }
  if (splits == 1) return;

  // the last block of this tile adds the splits in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(ticket, 1) == splits - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < TOK * BN; i += Q4_THREADS) {
    const int m = m0 + i / BN, n = n_tile + i % BN;
    if (m >= M || n >= N) continue;
    const float* p = part + (size_t)m * N + n;
    float v = __ldcg(p);
#pragma unroll 8
    for (int sp = 1; sp < splits; ++sp) v += __ldcg(p + (size_t)sp * M * N);
    out[(size_t)m * N + n] = v;
  }
}

// NT: 8-token n-tiles carried at once (1 for decode, 4 for prefill).
template <int NT, bool VEC>
__global__ void __launch_bounds__(Q4_THREADS, NT == 1 ? 2 : 1)
int4_tc_kernel(const __nv_bfloat16* __restrict__ x,  // (M, K)
               const int8_t* __restrict__ codes,     // (K / 2, N)
               const float* __restrict__ scale,      // (N,)
               float* __restrict__ out,              // (M, N)
               float* __restrict__ part,             // (splits, M, N) when splits > 1
               int* __restrict__ tickets,            // one a (column tile, token tile)
               int M, int K, int N, int ksteps_per_split) {
  extern __shared__ __align__(16) float red[];  // [Q4_WARPS][8 NT][Q4_BN]
  constexpr int TOK = 8 * NT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 4, c = lane % 4;
  const int n_tile = blockIdx.x * Q4_BN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * TOK;
  const int KB = K / 2;
  const int ksteps = (KB + Q4_STEP - 1) / Q4_STEP;
  const int ks_lo = split * ksteps_per_split;
  const int ks_hi = min(ksteps, ks_lo + ksteps_per_split);
  const int col0 = n_tile + 16 * r;  // this lane's 16 columns

  float s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = col0 + j < N ? floor_scale(scale[col0 + j], 1e-9f) : 0.f;

  float acc[8][NT][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  // x rows of this lane's B fragments (token m0 + 8 nt + r), k offset 2c
  const uint32_t* xrow[NT];
  bool xlive[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int m = m0 + nt * 8 + r;
    xlive[nt] = m < M;
    xrow[nt] = reinterpret_cast<const uint32_t*>(x + (size_t)(xlive[nt] ? m : 0) * K) + c;
  }

  // one 16-deep step of codes (and, at NT = 1, of x fragments) in registers
  // while the next loads; at NT = 4 the accumulators leave no room for x's
  constexpr bool XPRE = NT == 1;
  auto load_x = [&](uint32_t (&xb)[NT][2], int ks) {
    // B fragments: x[m][k0 + 2c, +1] and x[m][k0 + 2c + 8, +9] (k0 = 16 ks)
    const int k = ks * 16 + 2 * c;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      xb[nt][0] = ks < ks_hi && xlive[nt] && k < K ? __ldg(xrow[nt] + ks * 8) : 0u;
      xb[nt][1] = ks < ks_hi && xlive[nt] && k + 8 < K ? __ldg(xrow[nt] + ks * 8 + 4) : 0u;
    }
  };
  auto load = [&](uint4 (&w)[2], uint32_t (&xb)[NT][2], int ks) {
    const int kb = ks < ks_hi ? ks * Q4_STEP + c : KB;  // past the range: zeros
    w[0] = load_codes<VEC>(codes, kb, col0, KB, N);
    w[1] = load_codes<VEC>(codes, kb + 4, col0, KB, N);
    if (XPRE) load_x(xb, ks);
  };
  uint4 cur[2], nxt[2];
  uint32_t xc[NT][2], xn[NT][2];
  load(cur, xc, ks_lo + warp);
  for (int ks = ks_lo + warp; ks < ks_hi; ks += Q4_WARPS) {
    load(nxt, xn, ks + Q4_WARPS);
    if (!XPRE) load_x(xc, ks);
    const uint32_t l0[4] = {cur[0].x, cur[0].y, cur[0].z, cur[0].w};
    const uint32_t l1[4] = {cur[1].x, cur[1].y, cur[1].z, cur[1].w};
    uint32_t lo0[4], hi0[4], lo1[4], hi1[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v0 = l0[i] ^ 0x88888888u, v1 = l1[i] ^ 0x88888888u;
      lo0[i] = v0 & 0x0F0F0F0Fu;
      hi0[i] = (v0 >> 4) & 0x0F0F0F0Fu;
      lo1[i] = v1 & 0x0F0F0F0Fu;
      hi1[i] = (v1 >> 4) & 0x0F0F0F0Fu;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      // mma row r = column 16r + 2t (bytes 2t), row r + 8 = column 16r + 2t + 1
      const int wi = t / 2, j0 = 2 * (t % 2);
      uint32_t a[4];
      a[0] = deq_pair<8>(lo0[wi], hi0[wi], j0, s[2 * t]);
      a[1] = deq_pair<8>(lo0[wi], hi0[wi], j0 + 1, s[2 * t + 1]);
      a[2] = deq_pair<8>(lo1[wi], hi1[wi], j0, s[2 * t]);
      a[3] = deq_pair<8>(lo1[wi], hi1[wi], j0 + 1, s[2 * t + 1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16_rn(acc[t][nt], a, xc[nt][0], xc[nt][1]);
    }
    cur[0] = nxt[0];
    cur[1] = nxt[1];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      xc[nt][0] = xn[nt][0];
      xc[nt][1] = xn[nt][1];
    }
  }

  // the 8 warps' sums, added in warp order
  float* mine = red + warp * TOK * Q4_BN;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(nt * 8 + 2 * c + (e & 1)) * Q4_BN + 16 * r + 2 * t + (e >> 1)] = acc[t][nt][e];
  finish_tile<TOK, Q4_BN>(red, out, part, tickets, M, N, m0, n_tile);
}

template <int NT, bool VEC>
cudaError_t launch_int4(const void* x, const void* codes, const void* scale, void* out,
                        void* part, void* tickets, int M, int K, int N, int splits,
                        int ksteps_per_split, cudaStream_t stream) {
  auto kern = int4_tc_kernel<NT, VEC>;
  const int smem = Q4_WARPS * 8 * NT * Q4_BN * 4;
  static int smem_set = 0;  // per instance: the attribute is set once
  if (smem_set < smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  dim3 grid((N + Q4_BN - 1) / Q4_BN, splits, (M + 8 * NT - 1) / (8 * NT));
  kern<<<grid, Q4_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), M, K, N, ksteps_per_split);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// int_matmul: int8 codes, tensor cores (int4_matmul's tile, plan and merge)
// ---------------------------------------------------------------------------

constexpr int Q8_CW_DECODE = 16;  // code bytes (columns) a lane loads a row, M <= 8
constexpr int Q8_CW_PREFILL = 8;  // the same for M > 8

// 8 code bytes, streamed past L1.
__device__ __forceinline__ uint2 ld_stream8(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0,%1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}

// Code bytes of row k, columns n0 .. n0 + CW - 1, as CW / 4 words; zeros
// past K or N. VEC: N % 16 == 0 and the codes 16-byte aligned, so a lane's
// column group is all in or all out.
template <int CW, bool VEC>
__device__ __forceinline__ void load_codes8(uint32_t (&w)[CW / 4], const int8_t* codes, int k,
                                            int n0, int K, int N) {
#pragma unroll
  for (int i = 0; i < CW / 4; ++i) w[i] = 0u;
  if (k >= K || n0 >= N) return;
  const int8_t* row = codes + (size_t)k * N + n0;
  if (VEC) {
    if constexpr (CW == 16) {
      const uint4 v = ld_stream16(row);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
      const uint2 v = ld_stream8(row);
      w[0] = v.x; w[1] = v.y;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < CW; ++j)
    if (n0 + j < N)
      w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[j])) << (8 * (j % 4));
}

// NT: 8-token n-tiles carried at once (1 for decode, 4 for prefill); CW:
// columns a lane owns (a block's 8 CW).
template <int NT, int CW, bool VEC>
__global__ void __launch_bounds__(Q4_THREADS, 2)
int8_tc_kernel(const __nv_bfloat16* __restrict__ x,  // (M, ldx), ldx >= K, even
               const int8_t* __restrict__ codes,     // (K, N)
               const float* __restrict__ scale,      // (N,)
               float* __restrict__ out,              // (M, N)
               float* __restrict__ part,             // (splits, M, N) when splits > 1
               int* __restrict__ tickets,            // one a (column tile, token tile)
               int M, int K, int N, int ldx, int ksteps_per_split) {
  extern __shared__ __align__(16) float red[];  // [Q4_WARPS][8 NT][8 CW]
  constexpr int TOK = 8 * NT, BN = 8 * CW, WORDS = CW / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 4, c = lane % 4;
  const int n_tile = blockIdx.x * BN;
  const int m0 = blockIdx.z * TOK;
  const int ksteps = (K + 15) / 16;
  const int ks_lo = blockIdx.y * ksteps_per_split;
  const int ks_hi = min(ksteps, ks_lo + ksteps_per_split);
  const int col0 = n_tile + CW * r;  // this lane's CW columns

  float s[CW];
#pragma unroll
  for (int j = 0; j < CW; ++j) s[j] = col0 + j < N ? floor_scale(scale[col0 + j], 1e-9f) : 0.f;

  float acc[CW / 2][NT][4];
#pragma unroll
  for (int t = 0; t < CW / 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][nt][e] = 0.f;

  // B fragments: x[m][k0 + 2c, +1] and x[m][k0 + 2c + 8, +9] (k0 = 16 ks) of
  // token m = m0 + 8 nt + r, one 32-bit load each (rows of ldx bf16, even)
  const uint32_t* xrow = reinterpret_cast<const uint32_t*>(x) + (size_t)(m0 + r) * (ldx / 2) + c;
  const size_t xtile = (size_t)4 * ldx;  // 8 rows, in 32-bit words
  auto load = [&](uint32_t (&w)[4][WORDS], uint32_t (&xb)[NT][2], int ks) {
    const int k = ks < ks_hi ? ks * 16 + 2 * c : K;  // past the range: zeros
    load_codes8<CW, VEC>(w[0], codes, k, col0, K, N);
    load_codes8<CW, VEC>(w[1], codes, k + 1, col0, K, N);
    load_codes8<CW, VEC>(w[2], codes, k + 8, col0, K, N);
    load_codes8<CW, VEC>(w[3], codes, k + 9, col0, K, N);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bool live = m0 + nt * 8 + r < M;
      const uint32_t* xp = xrow + nt * xtile + ks * 8;
      xb[nt][0] = live && k < K ? __ldg(xp) : 0u;
      xb[nt][1] = live && k + 8 < K ? __ldg(xp + 4) : 0u;
    }
  };
  uint32_t cur[4][WORDS], nxt[4][WORDS];
  uint32_t xc[NT][2], xn[NT][2];
  load(cur, xc, ks_lo + warp);
  for (int ks = ks_lo + warp; ks < ks_hi; ks += Q4_WARPS) {
    load(nxt, xn, ks + Q4_WARPS);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < WORDS; ++i) cur[q][i] ^= 0x80808080u;  // code + 128 a byte
#pragma unroll
    for (int t = 0; t < CW / 2; ++t) {
      // mma row r = column CW r + 2t (byte 2t), row r + 8 = column CW r + 2t + 1
      const int wi = t / 2, j0 = 2 * (t % 2);
      uint32_t a[4];
      a[0] = deq_pair<128>(cur[0][wi], cur[1][wi], j0, s[2 * t]);
      a[1] = deq_pair<128>(cur[0][wi], cur[1][wi], j0 + 1, s[2 * t + 1]);
      a[2] = deq_pair<128>(cur[2][wi], cur[3][wi], j0, s[2 * t]);
      a[3] = deq_pair<128>(cur[2][wi], cur[3][wi], j0 + 1, s[2 * t + 1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16_rn(acc[t][nt], a, xc[nt][0], xc[nt][1]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < WORDS; ++i) cur[q][i] = nxt[q][i];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      xc[nt][0] = xn[nt][0];
      xc[nt][1] = xn[nt][1];
    }
  }

  float* mine = red + warp * TOK * BN;
#pragma unroll
  for (int t = 0; t < CW / 2; ++t)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[(nt * 8 + 2 * c + (e & 1)) * BN + CW * r + 2 * t + (e >> 1)] = acc[t][nt][e];
  finish_tile<TOK, BN>(red, out, part, tickets, M, N, m0, n_tile);
}

template <int NT, int CW, bool VEC>
cudaError_t launch_int8(const void* x, const void* codes, const void* scale, void* out,
                        void* part, void* tickets, int M, int K, int N, int ldx, int splits,
                        int ksteps_per_split, cudaStream_t stream) {
  auto kern = int8_tc_kernel<NT, CW, VEC>;
  constexpr int BN = 8 * CW;
  const int smem = Q4_WARPS * 8 * NT * BN * 4;
  static int smem_set = 0;  // per instance: the attribute is set once
  if (smem_set < smem) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  dim3 grid((N + BN - 1) / BN, splits, (M + 8 * NT - 1) / (8 * NT));
  kern<<<grid, Q4_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int*>(tickets), M, K, N, ldx, ksteps_per_split);
  return cudaGetLastError();
}

}  // namespace

// Output columns of an int_matmul block: decode (M <= 8) x 1000 + prefill
// (the wrapper's tickets check them).
extern "C" int int_matmul_tile(void) { return 8 * Q8_CW_DECODE * 1000 + 8 * Q8_CW_PREFILL; }

// x (M, ldx) bf16 (ldx >= K and even, columns past K zero), codes (K, N)
// int8, scale (N,) f32, out (M, N) f32; part (splits, M, N) f32 and tickets
// (one int32 a column tile x token tile, zero on entry and left zero) when
// splits > 1, else ignored. The contraction is cut into `splits` ranges of
// `ksteps_per_split` 16-deep steps (the wrapper's plan). vec = 1 when
// N % 16 == 0 and the codes pointer is 16-byte aligned. Returns
// cudaGetLastError().
extern "C" int int_matmul_launch(const void* x, const void* codes, const void* scale,
                                 void* out, void* part, void* tickets, int M, int K, int N,
                                 int ldx, int splits, int ksteps_per_split, int vec,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || ksteps_per_split < 1 || ldx < K || (ldx & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int D = Q8_CW_DECODE, P = Q8_CW_PREFILL;
  cudaError_t err;
  if (M <= 8)
    err = vec ? launch_int8<1, D, true>(x, codes, scale, out, part, tickets, M, K, N, ldx,
                                        splits, ksteps_per_split, s)
              : launch_int8<1, D, false>(x, codes, scale, out, part, tickets, M, K, N, ldx,
                                         splits, ksteps_per_split, s);
  else
    err = vec ? launch_int8<4, P, true>(x, codes, scale, out, part, tickets, M, K, N, ldx,
                                        splits, ksteps_per_split, s)
              : launch_int8<4, P, false>(x, codes, scale, out, part, tickets, M, K, N, ldx,
                                         splits, ksteps_per_split, s);
  return static_cast<int>(err);
}

// Output columns of an int4_matmul block and code byte rows of its mma step
// (the wrapper's plan checks them).
extern "C" int int4_matmul_tile(void) { return Q4_BN * 1000 + Q4_STEP; }

// x (M, K) bf16 (K even), codes (K / 2, N) nibble-packed int8, scale (N,) f32,
// out (M, N) f32; part (splits, M, N) f32 and tickets (one int32 a column tile
// x token tile, zero on entry and left zero) when splits > 1, else ignored.
// The contraction is cut into `splits` ranges of `ksteps_per_split` 16-deep
// steps (the wrapper's plan). vec = 1 when N % 16 == 0 and the codes pointer
// is 16-byte aligned. Returns cudaGetLastError().
extern "C" int int4_matmul_launch(const void* x, const void* codes, const void* scale,
                                  void* out, void* part, void* tickets, int M, int K, int N,
                                  int splits, int ksteps_per_split, int vec, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (splits < 1 || ksteps_per_split < 1 || (K & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 8)
    err = vec ? launch_int4<1, true>(x, codes, scale, out, part, tickets, M, K, N, splits,
                                        ksteps_per_split, s)
              : launch_int4<1, false>(x, codes, scale, out, part, tickets, M, K, N, splits,
                                         ksteps_per_split, s);
  else
    err = vec ? launch_int4<4, true>(x, codes, scale, out, part, tickets, M, K, N, splits,
                                        ksteps_per_split, s)
              : launch_int4<4, false>(x, codes, scale, out, part, tickets, M, K, N, splits,
                                         ksteps_per_split, s);
  return static_cast<int>(err);
}
