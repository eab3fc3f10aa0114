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
// int4_matmul (nibble-packed codes: byte p of a column holds row 2p in the low
// nibble and row 2p+1 in the high nibble, two's complement) runs on the tensor
// cores: mma.sync m16n8k16 with the dequantized weight as the A operand (16
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
// int_matmul (int8 codes, the lm head) keeps the SIMT tile of the first port:
// a block owns 32 output columns and M-tile rows; its 256 threads are 8 column
// groups x 32 K-groups, 4 code bytes (4 columns) a thread, several rows in
// flight; K-group y walks byte rows y, y+32, ... in order; the 32 partial sums
// of a column are added in a fixed tree (warp shuffles, then the 8 warps in
// order). Edges are masked in place of padding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// int_matmul: int8 codes, SIMT
// ---------------------------------------------------------------------------

constexpr int TX = 8;              // threads along N, 4 columns each
constexpr int TY = 32;             // K-groups
constexpr int BN = TX * 4;         // output columns per block
constexpr int NTHREADS = TX * TY;  // 256
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float dequant(int code, float s) {
  return __bfloat162float(__float2bfloat16_rn(static_cast<float>(code) * s));
}

__device__ __forceinline__ int byte_at(uint32_t word, int c) {
  return static_cast<int>(static_cast<int8_t>((word >> (8 * c)) & 0xffu));
}

// U = byte rows each thread loads per chunk; MT = output rows per block.
template <int MT, int U>
__global__ void __launch_bounds__(NTHREADS)
int_matmul_kernel(const __nv_bfloat16* __restrict__ x,  // (M, K)
                  const int8_t* __restrict__ codes,     // (K, N)
                  const float* __restrict__ scale,      // (N,)
                  float* __restrict__ out,              // (M, N)
                  int M, int K, int N, int vec) {
  constexpr int CB = TY * U;            // byte rows (= k rows) per chunk
  __shared__ __align__(16) float xs[CB][MT];          // x chunk, xs[k][m]
  __shared__ float red[NWARPS][MT][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int nb = blockIdx.x * BN;
  const int n0 = nb + tx * 4;
  const int m0 = blockIdx.y * MT;

  float s[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = (n0 + c < N) ? fmaxf(scale[n0 + c], 1e-9f) : 0.f;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  const bool full_vec = vec && (n0 + 3 < N);
  for (int kb0 = 0; kb0 < K; kb0 += CB) {
    __syncthreads();  // the previous chunk's readers are done with xs
    for (int i = tid; i < CB * MT; i += NTHREADS) {
      const int mm = i / CB, kk = i % CB;
      const int m = m0 + mm, k = kb0 + kk;
      xs[kk][mm] = (m < M && k < K) ? __bfloat162float(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();

    uint32_t w[U];
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int kb = kb0 + ty + r * TY;
      uint32_t word = 0;
      if (kb < K) {
        const int8_t* row = codes + (size_t)kb * N;
        if (full_vec) {
          word = *reinterpret_cast<const uint32_t*>(row + n0);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n0 + c < N) word |= (static_cast<uint32_t>(static_cast<uint8_t>(row[n0 + c])) << (8 * c));
        }
      }
      w[r] = word;
    }

#pragma unroll
    for (int r = 0; r < U; ++r) {
      float wd[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) wd[c] = dequant(byte_at(w[r], c), s[c]);
      const float* xr = xs[ty + r * TY];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xr[m];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wd[c], acc[m][c]);
      }
    }
  }

  // fixed-order reduction over the 32 K-groups: the 4 in a warp by shuffles,
  // then the 8 warps in order
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][c] = v;
    }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < TX) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[warp][m][lane * 4 + c] = acc[m][c];
  }
  __syncthreads();
  for (int i = tid; i < MT * BN; i += NTHREADS) {
    const int mm = i / BN, nn = i % BN;
    float v = 0.f;
#pragma unroll
    for (int wp = 0; wp < NWARPS; ++wp) v += red[wp][mm][nn];
    const int m = m0 + mm, n = nb + nn;
    if (m < M && n < N) out[(size_t)m * N + n] = v;
  }
}

template <int MT, int U>
cudaError_t launch_int8(const void* x, const void* codes, const void* scale, void* out,
                        int M, int K, int N, int vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  int_matmul_kernel<MT, U><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N, vec);
  return cudaGetLastError();
}

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

// The code in byte j of `biased` (each byte holds a nibble's code + 8) as an
// f32, exactly: the byte goes into the low mantissa of 2^23 and 2^23 + 8 is
// taken off.
__device__ __forceinline__ float code_f32(uint32_t biased, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540 + j)), 8388616.f);
}

// The mma A register of the two codes of byte j of a code word (low nibble =
// even k, the register's low half): bf16(f32(code) * s) each.
__device__ __forceinline__ uint32_t deq_pair(uint32_t lo, uint32_t hi, int j, float s) {
  return pack_bf16(__fmul_rn(code_f32(lo, j), s), __fmul_rn(code_f32(hi, j), s));
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
  __shared__ int last;
  constexpr int TOK = 8 * NT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 4, c = lane % 4;
  const int n_tile = blockIdx.x * Q4_BN;
  const int split = blockIdx.y, splits = gridDim.y;
  const int m0 = blockIdx.z * TOK;
  const int KB = K / 2;
  const int ksteps = (KB + Q4_STEP - 1) / Q4_STEP;
  const int ks_lo = split * ksteps_per_split;
  const int ks_hi = min(ksteps, ks_lo + ksteps_per_split);
  const int col0 = n_tile + 16 * r;  // this lane's 16 columns

  float s[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) s[j] = col0 + j < N ? fmaxf(scale[col0 + j], 1e-9f) : 0.f;

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
      a[0] = deq_pair(lo0[wi], hi0[wi], j0, s[2 * t]);
      a[1] = deq_pair(lo0[wi], hi0[wi], j0 + 1, s[2 * t + 1]);
      a[2] = deq_pair(lo1[wi], hi1[wi], j0, s[2 * t]);
      a[3] = deq_pair(lo1[wi], hi1[wi], j0 + 1, s[2 * t + 1]);
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
  __syncthreads();
  float* dst = splits > 1 ? part + (size_t)split * M * N : out;
  for (int i = threadIdx.x; i < TOK * Q4_BN; i += Q4_THREADS) {
    const int m = m0 + i / Q4_BN, n = n_tile + i % Q4_BN;
    float v = red[i];
#pragma unroll
    for (int wp = 1; wp < Q4_WARPS; ++wp) v += red[wp * TOK * Q4_BN + i];
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
  for (int i = threadIdx.x; i < TOK * Q4_BN; i += Q4_THREADS) {
    const int m = m0 + i / Q4_BN, n = n_tile + i % Q4_BN;
    if (m >= M || n >= N) continue;
    const float* p = part + (size_t)m * N + n;
    float v = __ldcg(p);
#pragma unroll 8
    for (int sp = 1; sp < splits; ++sp) v += __ldcg(p + (size_t)sp * M * N);
    out[(size_t)m * N + n] = v;
  }
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

}  // namespace

// x (M, K) bf16, codes (K, N) int8, scale (N,) f32, out (M, N) f32; all
// contiguous on the current device. vec = 1 when N % 4 == 0 and the codes
// pointer is 4-byte aligned. Returns cudaGetLastError().
extern "C" int int_matmul_launch(const void* x, const void* codes, const void* scale,
                                 void* out, int M, int K, int N, int vec, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (M <= 4) err = launch_int8<4, 8>(x, codes, scale, out, M, K, N, vec, s);
  else if (M <= 8) err = launch_int8<8, 8>(x, codes, scale, out, M, K, N, vec, s);
  else err = launch_int8<16, 4>(x, codes, scale, out, M, K, N, vec, s);
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
