// LSQ fake-quantization (Eq. 5 forward): y = s * clip(rint((x - b) / s), -Q_N, Q_P) + b.
//
// Replaces the TPU kernels fake_quant_2d (src/repro/kernels/fake_quant.py:48,
// body `_fq_kernel_scalar` :30; per-tensor scale and offset) and
// fake_quant_rows (:73, body `_fq_kernel_rows` :39; one scale per row, no
// offset) of the JAX package.
//
// What bounds it on an H100: one read of x and one write of y per element
// (8 bytes an f32 element, 4 a bf16 one) against a few flops, so HBM
// bandwidth (3.35 TB/s). The design is a grid-stride elementwise pass with
// 16-byte (f32) or 8-byte (bf16) vector accesses, 4 elements a thread and
// step, the scale and offset read once a thread from device memory (no host
// round trip), and edges masked in place of the reference's padding.
//
// Rounding is the reference kernel's, bit for bit (no --use_fast_math):
//   u = (x - b) / s   __fsub_rn then __fdiv_rn (IEEE division)
//   q = clip(rint(u)) rintf: half to even, as jnp.round; NaN stays NaN
//                     (clip_code, quant.cuh), as do NaN scales
//   y = q * s + b     one rounding, __fmaf_rn: XLA fuses the TPU kernel's
//                     multiply and add into a fused multiply-add
//   y = q * s         __fmul_rn where there is no offset (rows variant, and
//                     the per-tensor variant called without one: XLA drops
//                     the "+ 0", so a -0 stays -0)
// then one rounding to bf16 (__float2bfloat16_rn) for a bf16 tensor.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "quant.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // grid-stride beyond 16 blocks an SM

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// 4 consecutive elements at a 16-byte (f32) / 8-byte (bf16) aligned address
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __halves2bfloat162(
      __float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1]));
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __halves2bfloat162(
      __float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3]));
  *reinterpret_cast<uint2*>(p) = t;
}

template <bool OFFSET>
__device__ __forceinline__ float fq(float x, float s, float b, float lo, float hi) {
  const float u = OFFSET ? __fdiv_rn(__fsub_rn(x, b), s) : __fdiv_rn(x, s);
  const float q = clip_code(u, lo, hi);
  return OFFSET ? __fmaf_rn(q, s, b) : __fmul_rn(q, s);
}

// Per-tensor: x, y flat (n elements); scale / offset one f32 each on the
// device (offset null = no offset). vec: x and y 4-element aligned.
template <typename T, bool OFFSET>
__global__ void __launch_bounds__(NTHREADS)
fake_quant_tensor_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ offset, T* __restrict__ y,
                         long long n, int q_n, int q_p, int vec) {
  const float s = floor_scale(*scale, 1e-9f);
  const float b = OFFSET ? *offset : 0.f;
  const float lo = -static_cast<float>(q_n), hi = static_cast<float>(q_p);
  const long long stride = static_cast<long long>(gridDim.x) * NTHREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = t0; i < n4; i += stride) {
    float v[4];
    load4(x + 4 * i, v);
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = fq<OFFSET>(v[c], s, b, lo, hi);
    store4(y + 4 * i, v);
  }
  for (long long i = 4 * n4 + t0; i < n; i += stride)
    store1(y + i, fq<OFFSET>(load1(x + i), s, b, lo, hi));
}

// Per-row: x, y (M, N) row-major, row_scale (M,) f32. A row per blockIdx.y
// (strided past the grid's y limit), its columns over blockIdx.x.
// vec: N % 4 == 0 and x, y 4-element aligned.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fake_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ row_scale,
                       T* __restrict__ y, int M, long long N, int q_n, int q_p, int vec) {
  const float lo = -static_cast<float>(q_n), hi = static_cast<float>(q_p);
  const long long stride = static_cast<long long>(gridDim.x) * NTHREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * NTHREADS + threadIdx.x;
  const long long n4 = vec ? N / 4 : 0;
  for (int r = blockIdx.y; r < M; r += gridDim.y) {
    const float s = floor_scale(row_scale[r], 1e-9f);
    const T* xr = x + static_cast<long long>(r) * N;
    T* yr = y + static_cast<long long>(r) * N;
    for (long long i = t0; i < n4; i += stride) {
      float v[4];
      load4(xr + 4 * i, v);
#pragma unroll
      for (int c = 0; c < 4; ++c) v[c] = fq<false>(v[c], s, 0.f, lo, hi);
      store4(yr + 4 * i, v);
    }
    for (long long i = 4 * n4 + t0; i < N; i += stride)
      store1(yr + i, fq<false>(load1(xr + i), s, 0.f, lo, hi));
  }
}

int blocks_for(long long work) {
  const long long b = (work + NTHREADS - 1) / NTHREADS;
  return static_cast<int>(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

template <typename T>
cudaError_t tensor_launch(const void* x, const void* scale, const void* offset, void* y,
                          long long n, int q_n, int q_p, int vec, cudaStream_t st) {
  const int blocks = blocks_for(vec ? (n + 3) / 4 : n);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(offset);
  if (offset)
    fake_quant_tensor_kernel<T, true><<<blocks, NTHREADS, 0, st>>>(xp, sp, bp, yp, n, q_n, q_p, vec);
  else
    fake_quant_tensor_kernel<T, false><<<blocks, NTHREADS, 0, st>>>(xp, sp, bp, yp, n, q_n, q_p, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rows_launch(const void* x, const void* row_scale, void* y, int M, long long N,
                        int q_n, int q_p, int vec, cudaStream_t st) {
  const int gx = blocks_for(vec ? (N + 3) / 4 : N);
  const int gy = M < 65535 ? M : 65535;
  fake_quant_rows_kernel<T><<<dim3(gx, gy), NTHREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(row_scale), static_cast<T*>(y),
      M, N, q_n, q_p, vec);
  return cudaGetLastError();
}

}  // namespace

// x, y: n contiguous elements, f32 (bf16 = 0) or bf16 (bf16 = 1); scale,
// offset: one f32 each on the device, offset null for none. vec = 1 when x
// and y are 16-byte (f32) / 8-byte (bf16) aligned. Returns cudaGetLastError().
extern "C" int fake_quant_tensor_launch(const void* x, const void* scale, const void* offset,
                                        void* y, long long n, int q_n, int q_p, int bf16,
                                        int vec, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16
      ? tensor_launch<__nv_bfloat16>(x, scale, offset, y, n, q_n, q_p, vec, st)
      : tensor_launch<float>(x, scale, offset, y, n, q_n, q_p, vec, st);
  return static_cast<int>(err);
}

// x, y: (M, N) contiguous, f32 or bf16; row_scale (M,) f32. vec = 1 when
// N % 4 == 0 and x, y are aligned as above. Returns cudaGetLastError().
extern "C" int fake_quant_rows_launch(const void* x, const void* row_scale, void* y, int M,
                                      long long N, int q_n, int q_p, int bf16, int vec,
                                      void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = bf16
      ? rows_launch<__nv_bfloat16>(x, row_scale, y, M, N, q_n, q_p, vec, st)
      : rows_launch<float>(x, row_scale, y, M, N, q_n, q_p, vec, st);
  return static_cast<int>(err);
}
