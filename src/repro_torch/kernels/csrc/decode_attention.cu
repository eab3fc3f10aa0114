// Flash-decode attention over the pooled (optionally int8 / packed-int4) KV cache.
//
// Replaces the TPU kernel pooled_decode_attention of the JAX package
// (src/repro/kernels/decode_attention.py:137, body _flash_decode_kernel :74).
// Returns the UNNORMALIZED online-softmax triple (acc, m, l) so the caller can
// merge the chunk's own keys with one more online-softmax step.
//
// What bounds it on an H100: at decode (C = 1) each KV byte is used by the
// q_per_kv query rows of its kv head only, so the kernel is bound by the cache
// bytes it reads (int8 or packed int4 codes plus a f32 scale per (token,
// head)), and at the pool sizes the serving path uses (a few slots x a few
// hundred tokens) by launch latency and the serial walk over T. The design
// reads every code once, dequantizes it into shared memory, and never writes
// a dequantized cache or a score tensor to HBM. One block per (kv head, slot,
// tile of query rows) walks T in tiles of 32 keys: it stages K and V (values
// in the compute dtype, held as f32), computes the (rows x 32) scores with a
// sequential f32 dot over head_dim, applies softcap and the pos >= 0 /
// pos <= q_pos / ring-window masks in-kernel, updates the running max m and
// sum l with one warp per query row, casts P to the compute dtype, and
// accumulates P @ V in shared memory. GQA rows are (chunk token, q head in
// group) pairs of one kv head, so no head-repeated K/V exists. Masked scores
// are the finite NEG_INF: a fully masked row (idle slot, or a first prefill
// chunk against an empty cache) ends with m = NEG_INF and l > 0, so the
// caller's merge factor exp(m - m_new) is 0, never NaN. Plain FMA, no tensor
// cores (a later change can move QK and PV to mma).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BT = 32;          // keys per tile (one per lane in the row update)
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr float NEG_INF = -2.0e9f;

enum KvKind { KV_BF16 = 0, KV_F32 = 1, KV_INT8 = 2, KV_INT4 = 3 };

__device__ __forceinline__ float to_compute(float v, bool bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int KIND>
__device__ __forceinline__ float load_kv(const void* store, const float* scale,
                                         size_t row, int D, int d) {
  // row = (b * T + t) * Hkv + h
  if (KIND == KV_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(store)[row * D + d]);
  } else if (KIND == KV_F32) {
    return static_cast<const float*>(store)[row * D + d];
  } else if (KIND == KV_INT8) {
    const int code = static_cast<const int8_t*>(store)[row * D + d];
    return static_cast<float>(code) * scale[row];
  } else {
    const int b = static_cast<const int8_t*>(store)[row * (D / 2) + d / 2];
    const uint32_t u = static_cast<uint32_t>(b);
    const int code = (d & 1) ? (static_cast<int>(u << 24) >> 28)
                             : (static_cast<int>(u << 28) >> 28);
    return static_cast<float>(code) * scale[row];
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KIND, bool Q_BF16>
__global__ void __launch_bounds__(NTHREADS)
flash_decode_kernel(const void* __restrict__ q,      // (B, Hkv, G, D), pre-scaled
                    const void* __restrict__ k,      // (B, T, Hkv, D or D/2)
                    const void* __restrict__ v,
                    const float* __restrict__ ks,    // (B, T, Hkv) or null
                    const float* __restrict__ vs,
                    const int* __restrict__ pos,     // (B, T)
                    const int* __restrict__ qpos,    // (B, G)
                    float* __restrict__ acc_out,     // (B, Hkv, G, D)
                    float* __restrict__ m_out,       // (B, Hkv, G)
                    float* __restrict__ l_out,
                    int T, int Hkv, int G, int D, int GT, int window, float softcap) {
  // the compute dtype is q's: K, V and P are rounded to it
  constexpr bool CBF16 = Q_BF16;
  extern __shared__ __align__(16) float smem[];
  const int DP = D + 1;  // padded row: the 32 lanes of a warp hit 32 banks
  float* qs = smem;                       // [GT][D]
  float* accs = qs + GT * D;              // [GT][D]
  float* kt = accs + GT * D;              // [BT][DP]
  float* vt = kt + BT * DP;               // [BT][DP]
  float* sp = vt + BT * DP;               // [GT][BT + 1]
  float* mrow = sp + GT * (BT + 1);       // [GT]
  float* lrow = mrow + GT;                // [GT]
  float* arow = lrow + GT;                // [GT]
  int* kpos = reinterpret_cast<int*>(arow + GT);  // [BT]
  int* qp = kpos + BT;                    // [GT]

  const int h = blockIdx.x, b = blockIdx.y;
  const int g0 = blockIdx.z * GT;
  const int gn = min(GT, G - g0);
  const int tid = threadIdx.x;
  const size_t qbase = ((size_t)(b * Hkv + h) * G + g0) * D;

  for (int i = tid; i < gn * D; i += NTHREADS) {
    qs[i] = Q_BF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[qbase + i])
                   : static_cast<const float*>(q)[qbase + i];
    accs[i] = 0.f;
  }
  for (int g = tid; g < gn; g += NTHREADS) {
    mrow[g] = NEG_INF;
    lrow[g] = 0.f;
    qp[g] = qpos[(size_t)b * G + g0 + g];
  }

  for (int t0 = 0; t0 < T; t0 += BT) {
    __syncthreads();  // previous tile fully consumed; init visible
    for (int i = tid; i < BT * D; i += NTHREADS) {
      const int t = i / D, d = i % D;
      float kv = 0.f, vv = 0.f;
      if (t0 + t < T) {
        const size_t row = ((size_t)b * T + t0 + t) * Hkv + h;
        kv = to_compute(load_kv<KIND>(k, ks, row, D, d), CBF16);
        vv = to_compute(load_kv<KIND>(v, vs, row, D, d), CBF16);
      }
      kt[t * DP + d] = kv;
      vt[t * DP + d] = vv;
    }
    for (int t = tid; t < BT; t += NTHREADS)
      kpos[t] = (t0 + t < T) ? pos[(size_t)b * T + t0 + t] : -1;
    __syncthreads();

    // scores (gn x BT): sequential f32 dot over head_dim, softcap, masks
    for (int i = tid; i < gn * BT; i += NTHREADS) {
      const int g = i / BT, t = i % BT;
      const float* qr = qs + g * D;
      const float* kr = kt + t * DP;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int kp = kpos[t], qv = qp[g];
      bool valid = (kp >= 0) && (kp <= qv);
      if (window > 0) valid = valid && (kp > qv - window);
      sp[g * (BT + 1) + t] = valid ? s : NEG_INF;
    }
    __syncthreads();

    // online-softmax row update: one warp per query row, lane = key
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < gn; g += NWARPS) {
      const float s = sp[g * (BT + 1) + lane];
      const float m_prev = mrow[g];
      const float m_cur = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_cur);
      const float p = expf(s - m_cur);
      const float psum = warp_sum(p);
      sp[g * (BT + 1) + lane] = to_compute(p, CBF16);
      if (lane == 0) {
        lrow[g] = lrow[g] * alpha + psum;
        mrow[g] = m_cur;
        arow[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    for (int i = tid; i < gn * D; i += NTHREADS) {
      const int g = i / D, d = i % D;
      const float* pr = sp + g * (BT + 1);
      float pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < BT; ++t) pv = fmaf(pr[t], vt[t * DP + d], pv);
      accs[i] = accs[i] * arow[g] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < gn * D; i += NTHREADS) acc_out[qbase + i] = accs[i];
  const size_t rbase = (size_t)(b * Hkv + h) * G + g0;
  for (int g = tid; g < gn; g += NTHREADS) {
    m_out[rbase + g] = mrow[g];
    l_out[rbase + g] = lrow[g];
  }
}

size_t smem_bytes(int GT, int D) {
  const size_t floats = 2 * (size_t)GT * D + 2 * (size_t)BT * (D + 1) +
                        (size_t)GT * (BT + 1) + 3 * (size_t)GT;
  return (floats + BT + GT) * 4;
}

template <int KIND, bool Q_BF16>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* pos, const int* qpos, float* acc,
                   float* m, float* l, int B, int T, int Hkv, int G, int D, int GT,
                   int window, float softcap, cudaStream_t stream) {
  const size_t bytes = smem_bytes(GT, D);
  auto kern = flash_decode_kernel<KIND, Q_BF16>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  dim3 grid(Hkv, B, (G + GT - 1) / GT);
  kern<<<grid, NTHREADS, bytes, stream>>>(q, k, v, ks, vs, pos, qpos, acc, m, l,
                                          T, Hkv, G, D, GT, window, softcap);
  return cudaGetLastError();
}

template <bool Q_BF16>
cudaError_t dispatch(int kind, const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* pos, const int* qpos,
                     float* acc, float* m, float* l, int B, int T, int Hkv, int G, int D,
                     int GT, int window, float softcap, cudaStream_t stream) {
  switch (kind) {
    case KV_BF16:
      return launch<KV_BF16, Q_BF16>(q, k, v, ks, vs, pos, qpos, acc, m, l, B, T, Hkv, G,
                                     D, GT, window, softcap, stream);
    case KV_F32:
      return launch<KV_F32, Q_BF16>(q, k, v, ks, vs, pos, qpos, acc, m, l, B, T, Hkv, G,
                                    D, GT, window, softcap, stream);
    case KV_INT8:
      return launch<KV_INT8, Q_BF16>(q, k, v, ks, vs, pos, qpos, acc, m, l, B, T, Hkv, G,
                                     D, GT, window, softcap, stream);
    case KV_INT4:
      return launch<KV_INT4, Q_BF16>(q, k, v, ks, vs, pos, qpos, acc, m, l, B, T, Hkv, G,
                                     D, GT, window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory the kernel needs for a tile of GT query rows at head_dim D.
extern "C" long long decode_attention_smem_bytes(int GT, int D) {
  return static_cast<long long>(smem_bytes(GT, D));
}

// q (B, Hkv, G, D) bf16 (q_bf16 = 1) or f32, pre-scaled; k/v (B, T, Hkv, D)
// bf16 / f32 values or int8 codes, (B, T, Hkv, D/2) packed int4 codes;
// ks/vs (B, T, Hkv) f32 or null; pos (B, T) int32; qpos (B, G) int32;
// acc (B, Hkv, G, D), m / l (B, Hkv, G) f32. kv_kind: 0 bf16, 1 f32, 2 int8,
// 3 packed int4. GT = query rows per block. Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs, const void* pos,
                                       const void* qpos, void* acc, void* m, void* l,
                                       int B, int T, int Hkv, int G, int D, int GT,
                                       int kv_kind, int q_bf16, int window, float softcap,
                                       void* stream) {
  if (B <= 0 || G <= 0 || Hkv <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* posi = static_cast<const int*>(pos);
  const int* qpi = static_cast<const int*>(qpos);
  float* accf = static_cast<float*>(acc);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
  cudaError_t err =
      q_bf16 ? dispatch<true>(kv_kind, q, k, v, ksf, vsf, posi, qpi, accf, mf, lf, B, T,
                              Hkv, G, D, GT, window, softcap, s)
             : dispatch<false>(kv_kind, q, k, v, ksf, vsf, posi, qpi, accf, mf, lf, B, T,
                               Hkv, G, D, GT, window, softcap, s);
  return static_cast<int>(err);
}
