// Serving matmul over int-coded weights: out = x @ bf16(code * max(col_scale, 1e-9)).
//
// Replaces the TPU kernels int_matmul (src/repro/kernels/quant_matmul.py:819,
// body `kernel` :834) and int4_matmul (:863, body `kernel` :883) of the JAX
// package. One source; PACKED selects nibble-packed int4 codes (byte p of a
// column holds row 2p in the low nibble and row 2p+1 in the high nibble, two's
// complement) over one int8 code per byte.
//
// What bounds it on an H100: decode runs at M = n_slots (4), so every weight
// byte feeds only 4 (int8) or 8 (int4) multiply-adds and the kernel is bound
// by the code bytes it streams from HBM (0.5 or 1 byte a weight at 3.35 TB/s),
// far below the tensor-core line. The design therefore reads each code byte
// exactly once per block of output rows, 4 bytes (4 columns) per thread and
// several rows in flight per thread, and does the dequantization and the f32
// multiply-adds in registers (plain FMA, no tensor cores; wgmma/TMA come with
// a later change). A block owns 32 output columns and M-tile rows; its 256
// threads are 8 column groups x 32 K-groups. K-group y walks byte rows
// y, y+32, ... in order; the 32 partial sums of a column are added in a fixed
// tree (warp shuffles, then the 8 warps in order). Nothing in that order
// depends on M, so an output row's bits do not depend on how many rows the
// batch has (the serving engine's stream-equality contract).
//
// Numerics, as in the TPU kernel: x is bf16 (the wrapper casts), the weight is
// dequantized in f32 and rounded once to bf16, and the bf16 x bf16 products,
// exact in f32, are summed in f32. Edges are masked in place of padding.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ int nibble(int b, int hi) {
  // sign-extend the low (hi=0) or high (hi=1) nibble of a sign-extended byte
  const uint32_t u = static_cast<uint32_t>(b);
  return hi ? (static_cast<int>(u << 24) >> 28) : (static_cast<int>(u << 28) >> 28);
}

// U = byte rows each thread loads per chunk; MT = output rows per block.
template <bool PACKED, int MT, int U>
__global__ void __launch_bounds__(NTHREADS)
int_matmul_kernel(const __nv_bfloat16* __restrict__ x,  // (M, K)
                  const int8_t* __restrict__ codes,     // (K or K/2, N)
                  const float* __restrict__ scale,      // (N,)
                  float* __restrict__ out,              // (M, N)
                  int M, int K, int N, int vec) {
  constexpr int KPB = PACKED ? 2 : 1;   // k rows per byte row
  constexpr int CB = TY * U;            // byte rows per chunk
  constexpr int CK = CB * KPB;          // k rows per chunk
  __shared__ __align__(16) float xs[CK][MT];          // x chunk, xs[k][m]
  __shared__ float red[NWARPS][MT][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int nb = blockIdx.x * BN;
  const int n0 = nb + tx * 4;
  const int m0 = blockIdx.y * MT;
  const int KB = PACKED ? K / 2 : K;

  float s[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = (n0 + c < N) ? fmaxf(scale[n0 + c], 1e-9f) : 0.f;

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

  const bool full_vec = vec && (n0 + 3 < N);
  for (int kb0 = 0; kb0 < KB; kb0 += CB) {
    __syncthreads();  // the previous chunk's readers are done with xs
    for (int i = tid; i < CK * MT; i += NTHREADS) {
      const int mm = i / CK, kk = i % CK;
      const int m = m0 + mm, k = kb0 * KPB + kk;
      xs[kk][mm] = (m < M && k < K) ? __bfloat162float(x[(size_t)m * K + k]) : 0.f;
    }
    __syncthreads();

    uint32_t w[U];
#pragma unroll
    for (int r = 0; r < U; ++r) {
      const int kb = kb0 + ty + r * TY;
      uint32_t word = 0;
      if (kb < KB) {
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
#pragma unroll
      for (int j = 0; j < KPB; ++j) {
        float wd[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = byte_at(w[r], c);
          wd[c] = dequant(PACKED ? nibble(b, j) : b, s[c]);
        }
        const float* xr = xs[(ty + r * TY) * KPB + j];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xr[m];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wd[c], acc[m][c]);
        }
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

template <bool PACKED, int MT, int U>
cudaError_t launch(const void* x, const void* codes, const void* scale, void* out,
                   int M, int K, int N, int vec, cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  int_matmul_kernel<PACKED, MT, U><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N, vec);
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t dispatch(const void* x, const void* codes, const void* scale, void* out,
                     int M, int K, int N, int vec, cudaStream_t stream) {
  if (M <= 4) return launch<PACKED, 4, 8>(x, codes, scale, out, M, K, N, vec, stream);
  if (M <= 8) return launch<PACKED, 8, 8>(x, codes, scale, out, M, K, N, vec, stream);
  return launch<PACKED, 16, 4>(x, codes, scale, out, M, K, N, vec, stream);
}

}  // namespace

// x (M, K) bf16, codes (K, N) int8 or (K/2, N) packed int4, scale (N,) f32,
// out (M, N) f32; all contiguous on the current device. vec = 1 when N % 4 == 0
// and the codes pointer is 4-byte aligned. Returns cudaGetLastError().
extern "C" int int_matmul_launch(const void* x, const void* codes, const void* scale,
                                 void* out, int M, int K, int N, int packed, int vec,
                                 void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = packed ? dispatch<true>(x, codes, scale, out, M, K, N, vec, s)
                           : dispatch<false>(x, codes, scale, out, M, K, N, vec, s);
  return static_cast<int>(err);
}
