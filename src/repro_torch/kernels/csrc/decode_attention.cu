// Flash-decode attention over the pooled (optionally int8 / packed-int4) KV cache.
//
// Replaces the TPU kernel pooled_decode_attention of the JAX package
// (src/repro/kernels/decode_attention.py:137, body _flash_decode_kernel :74).
// Returns the UNNORMALIZED online-softmax triple (acc, m, l) so the caller can
// merge the chunk's own keys with one more online-softmax step.
//
// What bounds it on an H100: at decode (C = 1) each KV byte is used by the
// q_per_kv query rows of its kv head only, so the bound is the cache bytes
// it reads (int8 or packed int4 codes plus an f32 scale per (token, head)):
// well under a microsecond at the serving path's pool sizes (a few slots x a
// few hundred tokens). What it must beat is latency: (kv head, slot) pairs
// are too few to fill 132 SMs, and one block walking all T keys serially is
// a chain of dependent tiles.
//
// The design (flash-decoding): the grid is (kv head, slot, query-row tile x
// key split). A split is KS = 64 keys counted from key 0, a compile-time
// length that depends on nothing else (not B, not the live slots, not the
// card), so a row's bits depend only on its own keys. Each block stages its
// split's K and V once, dequantized into shared memory with 16-byte loads
// contiguous across a warp (int8 as code x scale in f32; int4 nibble-packed
// along head_dim, low nibble = even d; bf16 and f32 values), in the compute
// dtype (q's), computes the split's scores, applies softcap and the
// pos >= 0 / pos <= q_pos / ring-window masks, takes the split's max m and
// sum l, and P @ V with P rounded to the compute dtype against the split's
// max. bf16 compute: QK^T and P.V on the tensor cores (mma.sync m16n8k16,
// f32 accumulate); the query rows of one kv head (C x q_per_kv, GQA without
// repeating K/V) are the m16 side, one warp per 16 rows (at decode 4 rows
// padded to 16), and P stays in registers between the two products. f32
// compute (its bar admits no bf16 operand): f32 FMAs, a warp's lanes on 32
// keys (scores) or 32 head_dim columns (P.V), 4 query rows a thread.
//
// The merge: with one split the block writes the triple. With more, each
// block writes its split's (acc, m, l) to f32 scratch, and the last block of
// its (slot, kv head, row tile) to arrive (an integer ticket, left at zero)
// merges them in split order: m = the max over splits; a split whose m is
// NEG_INF (every key masked) is skipped, so idle capacity past the live keys
// (a larger T) changes no bit; the others add acc_s exp(m_s - m) and
// l_s exp(m_s - m). A fully masked row (idle slot, or a first prefill chunk
// against an empty cache) keeps split 0's triple: m = NEG_INF, l = its key
// count > 0, finite acc, so the caller's merge factor exp(m - m_new) is 0,
// never NaN. Keys past T are out of every sum (p = 0).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int KS = 64;            // keys of a split
constexpr int THREADS = 128;      // threads a block: they stage and merge together
constexpr float NEG_INF = -2.0e9f;

enum KvKind { KV_BF16 = 0, KV_F32 = 1, KV_INT8 = 2, KV_INT4 = 3 };

struct Args {
  const void* q;      // (B, C, H, D), the compute dtype; scaled here by qscale
  const void* k;      // (B, T, Hkv, D or D/2)
  const void* v;
  const float* ks;    // (B, T, Hkv) or null
  const float* vs;
  const int* pos;     // (B, T)
  const int* qpos;    // (B, C)
  float* acc;         // (B, C, H, D)
  float* m;           // (B, C, H)
  float* l;
  float* part_acc;    // (B * Hkv, NS, G, D) when NS > 1
  float* part_ml;     // (B * Hkv, NS, G, 2)
  int* tickets;       // (B * Hkv * row tiles), zero on entry and on exit
  int T, C, Hkv, qpk, G, D, GT, window;  // G = C * qpk rows a kv head
  float qscale, softcap;
};

// A block's place: slot b, kv head h, split s of NS, rows g0 .. g0 + gn - 1.
struct Place {
  int b, h, bh, s, NS, gt, g0, gn, t0;
};

__device__ __forceinline__ Place place(const Args& a) {
  Place p;
  p.h = blockIdx.x;
  p.b = blockIdx.y;
  p.bh = p.b * a.Hkv + p.h;
  p.NS = (a.T + KS - 1) / KS;
  p.s = blockIdx.z % p.NS;
  p.gt = blockIdx.z / p.NS;
  p.g0 = p.gt * a.GT;
  p.gn = min(a.GT, a.G - p.g0);
  p.t0 = p.s * KS;
  return p;
}

// Row g (0 .. G - 1: chunk token c = g / qpk, head h * qpk + g % qpk) of kv
// head h in q's (B, C, H) rows, which the outputs share.
__device__ __forceinline__ size_t out_row(const Args& a, const Place& p, int g) {
  const int c = g / a.qpk;
  return ((size_t)p.b * a.C + c) * a.Hkv * a.qpk + p.h * a.qpk + (g - c * a.qpk);
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

template <int KIND>
__device__ __forceinline__ float load_kv(const void* store, const float* scale, size_t row,
                                         int D, int d) {
  // row = (b * T + t) * Hkv + h
  if (KIND == KV_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(store)[row * D + d]);
  } else if (KIND == KV_F32) {
    return static_cast<const float*>(store)[row * D + d];
  } else if (KIND == KV_INT8) {
    return static_cast<float>(static_cast<const int8_t*>(store)[row * D + d]) * scale[row];
  } else {
    const uint32_t u =
        static_cast<uint32_t>(static_cast<const int8_t*>(store)[row * (D / 2) + d / 2]);
    const int code = static_cast<int>(u << ((d & 1) ? 24 : 28)) >> 28;
    return static_cast<float>(code) * scale[row];
  }
}

// Values a 16-byte chunk of the store holds, and the chunk's byte offset.
template <int KIND>
struct Chunk {
  static constexpr int V = KIND == KV_BF16 ? 8 : KIND == KV_F32 ? 4 : KIND == KV_INT8 ? 16 : 32;
  __device__ static size_t offset(size_t row, int D, int d0) {
    return KIND == KV_BF16 ? (row * D + d0) * 2
         : KIND == KV_F32  ? (row * D + d0) * 4
         : KIND == KV_INT8 ? row * D + d0
                           : row * (D / 2) + d0 / 2;
  }
};

template <int KIND>
__device__ __forceinline__ void decode_chunk(uint4 w, float sc, float (&v)[Chunk<KIND>::V]) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if (KIND == KV_BF16) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __uint_as_float((i & 1 ? u[i / 2] >> 16 : u[i / 2] & 0xffffu) << 16);
  } else if (KIND == KV_F32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(u[i]);
  } else if (KIND == KV_INT8) {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      v[i] = static_cast<float>(static_cast<int>(u[i / 4] << (24 - 8 * (i % 4))) >> 24) * sc;
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i)
      v[i] = static_cast<float>(static_cast<int>(u[i / 8] << (28 - 4 * (i % 8))) >> 28) * sc;
  }
}

// Stage the block's operands into shared memory in the compute dtype, bf16
// (CBF16) or f32: keys t0 .. t0 + KS - 1 of (b, h) of the K and V stores,
// row t at sk / sv + t * ld (rows past T zero); the tile's qrows query rows
// scaled by qscale in f32 and rounded, row g at sq + g * ldq (bf16) or
// transposed, column g of sq (f32; zero past gn); the keys' positions kpos
// and the rows' query positions qp (-1 past T / gn). 16-byte chunks, a
// thread's next STAGE_BATCH chunks loaded (the positions first) before any
// is stored, so their latencies overlap; where a K / V row is not a whole
// number of aligned chunks, its values one a thread. A small batch keeps the
// code short: under a cold L2 the kernel's instructions come from HBM too,
// and a deeper unrolled batch measured slower on the card (PERF.md §7).
constexpr int STAGE_BATCH = 4;

template <int KIND, bool CBF16>
__device__ __forceinline__ void stage(const Args& a, const Place& p, void* sq, int ldq,
                                      int qrows, void* sk, void* sv, int ld, int* kpos,
                                      int* qp) {
  using C = Chunk<KIND>;
  constexpr int QV = CBF16 ? 8 : 4;  // query values a chunk
  const int D = a.D, tid = threadIdx.x;
  const size_t row0 = ((size_t)p.b * a.T + p.t0) * a.Hkv + p.h;
  const int live = min(KS, a.T - p.t0);
  const int kp = tid < KS && tid < live ? a.pos[(size_t)p.b * a.T + p.t0 + tid] : -1;
  const int qv = tid < p.gn ? a.qpos[(size_t)p.b * a.C + (p.g0 + tid) / a.qpk] : -1;
  const bool vec = D % C::V == 0 && ((reinterpret_cast<uintptr_t>(a.k) |
                                      reinterpret_cast<uintptr_t>(a.v)) & 15) == 0;
  const int cpr = vec ? D / C::V : 0;  // chunks a K / V row
  const int per = KS * cpr;            // chunks of one store
  const int qcpr = D / QV, n = 2 * per + qrows * qcpr;
  for (int i0 = tid; i0 < n; i0 += STAGE_BATCH * blockDim.x) {
    uint4 w[STAGE_BATCH];
    float sc[STAGE_BATCH];
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int i = i0 + j * blockDim.x;
      w[j] = make_uint4(0u, 0u, 0u, 0u);
      sc[j] = 0.f;
      if (i < 2 * per) {
        const int v = i >= per, t = (i - v * per) / cpr;
        if (t < live) {
          const size_t row = row0 + (size_t)t * a.Hkv;
          w[j] = *reinterpret_cast<const uint4*>(static_cast<const char*>(v ? a.v : a.k) +
                                                 C::offset(row, D, ((i - v * per) % cpr) * C::V));
          if (KIND >= KV_INT8) sc[j] = (v ? a.vs : a.ks)[row];
        }
      } else if (i < n) {
        const int g = (i - 2 * per) / qcpr, d0 = ((i - 2 * per) % qcpr) * QV;
        if (g < p.gn)
          w[j] = *reinterpret_cast<const uint4*>(static_cast<const char*>(a.q) +
                                                 (out_row(a, p, p.g0 + g) * D + d0) * (16 / QV));
      }
    }
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int i = i0 + j * blockDim.x;
      if (i >= n) break;
      if (i < 2 * per) {
        const int v = i >= per, t = (i - v * per) / cpr, d0 = ((i - v * per) % cpr) * C::V;
        float x[C::V];
        decode_chunk<KIND>(w[j], sc[j], x);
        if (CBF16) {
          uint32_t* o = reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(v ? sv : sk) +
                                                    t * ld + d0);
#pragma unroll
          for (int e = 0; e < C::V / 2; ++e) o[e] = pack_bf16(x[2 * e], x[2 * e + 1]);
        } else {
          float* o = static_cast<float*>(v ? sv : sk) + t * ld + d0;
#pragma unroll
          for (int e = 0; e < C::V; ++e) o[e] = x[e];
        }
      } else {
        const int g = (i - 2 * per) / qcpr, d0 = ((i - 2 * per) % qcpr) * QV;
        const uint32_t u[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
        if (CBF16) {  // 8 bf16 values
          uint32_t o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[e] = pack_bf16(__fmul_rn(__uint_as_float(u[e] << 16), a.qscale),
                             __fmul_rn(__uint_as_float(u[e] & 0xffff0000u), a.qscale));
          *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(sq) + g * ldq + d0) =
              make_uint4(o[0], o[1], o[2], o[3]);
        } else {  // 4 f32 values, into column g
#pragma unroll
          for (int e = 0; e < 4; ++e)
            static_cast<float*>(sq)[(d0 + e) * ldq + g] =
                __fmul_rn(__uint_as_float(u[e]), a.qscale);
        }
      }
    }
  }
  if (tid < KS) kpos[tid] = kp;
  if (tid < a.GT) qp[tid] = qv;
  if (vec) return;
  for (int i = tid; i < 2 * KS * D; i += blockDim.x) {
    const int v = i >= KS * D, t = (i - v * KS * D) / D, d = i % D;
    const float x = t < live ? load_kv<KIND>(v ? a.v : a.k, v ? a.vs : a.ks,
                                             row0 + (size_t)t * a.Hkv, D, d)
                             : 0.f;
    if (CBF16) static_cast<__nv_bfloat16*>(v ? sv : sk)[t * ld + d] = __float2bfloat16_rn(x);
    else static_cast<float*>(v ? sv : sk)[t * ld + d] = x;
  }
}

// Score of key t (of the split) for a query at qv: softcap, masks; -inf past T.
__device__ __forceinline__ float masked(const Args& a, const Place& p, float s, int t, int kp,
                                        int qv) {
  if (p.t0 + t >= a.T) return -INFINITY;
  if (a.softcap > 0.f) s = a.softcap * tanhf(s / a.softcap);
  bool valid = (kp >= 0) && (kp <= qv);
  if (a.window > 0) valid = valid && (kp > qv - a.window);
  return valid ? s : NEG_INF;
}

// Where a block writes row g of its tile: the outputs (one split) or its
// split's scratch.
__device__ __forceinline__ float* acc_row(const Args& a, const Place& p, int g) {
  return p.NS == 1 ? a.acc + out_row(a, p, p.g0 + g) * a.D
                   : a.part_acc + (((size_t)p.bh * p.NS + p.s) * a.G + p.g0 + g) * a.D;
}

__device__ __forceinline__ void put_ml(const Args& a, const Place& p, int g, float m, float l) {
  if (p.NS == 1) {
    const size_t r = out_row(a, p, p.g0 + g);
    a.m[r] = m;
    a.l[r] = l;
  } else {
    float* ml = a.part_ml + 2 * (((size_t)p.bh * p.NS + p.s) * a.G + p.g0 + g);
    ml[0] = m;
    ml[1] = l;
  }
}

// With several splits: the last block of the (slot, head, row tile) to arrive
// merges them, in split order, a (row, W columns) element a thread: first
// the row's m, the max over the splits' m; then acc (and, at column 0, l)
// over the splits, SG splits' loads in flight together. A split whose m is
// NEG_INF (no unmasked key) adds nothing; where every split's is, the row
// keeps split 0's triple.
constexpr int SG = 4;

template <int W>
__device__ __forceinline__ void merge_rows(const Args& a, const Place& p) {
  const int D = a.D, dw = D / W;
  const size_t sa = (size_t)a.G * D, sm = 2 * (size_t)a.G;
  for (int i = threadIdx.x; i < p.gn * dw; i += blockDim.x) {
    const int g = i / dw, d = (i % dw) * W;
    const float* pa = a.part_acc + (size_t)p.bh * p.NS * sa + (size_t)(p.g0 + g) * D + d;
    const float* pm = a.part_ml + (size_t)p.bh * p.NS * sm + 2 * (size_t)(p.g0 + g);
    float mx = NEG_INF, l = 0.f, acc[W];
#pragma unroll
    for (int j = 0; j < W; ++j) acc[j] = 0.f;
    for (int s0 = 0; s0 < p.NS; s0 += SG)
#pragma unroll
      for (int u = 0; u < SG; ++u)
        if (s0 + u < p.NS) mx = fmaxf(mx, __ldcg(pm + (s0 + u) * sm));
    for (int s0 = 0; s0 < p.NS; s0 += SG) {
      float ms[SG], ls[SG], v[SG][W];
#pragma unroll
      for (int u = 0; u < SG; ++u) {
        const int s = min(s0 + u, p.NS - 1);
        ms[u] = __ldcg(pm + s * sm);
        ls[u] = __ldcg(pm + s * sm + 1);
#pragma unroll
        for (int j = 0; j < W; ++j) v[u][j] = __ldcg(pa + s * sa + j);
      }
#pragma unroll
      for (int u = 0; u < SG; ++u) {
        if (s0 + u >= p.NS) break;
        if (mx == NEG_INF) {  // every key masked: split 0's acc and l
          if (s0 + u == 0) {
            l = ls[u];
#pragma unroll
            for (int j = 0; j < W; ++j) acc[j] = v[u][j];
          }
        } else if (ms[u] != NEG_INF) {
          const float f = expf(ms[u] - mx);
          l = __fadd_rn(l, __fmul_rn(ls[u], f));
#pragma unroll
          for (int j = 0; j < W; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[u][j], f));
        }
      }
    }
    const size_t r = out_row(a, p, p.g0 + g);
#pragma unroll
    for (int j = 0; j < W; ++j) a.acc[r * D + d + j] = acc[j];
    if (d == 0) {
      a.m[r] = mx;
      a.l[r] = l;
    }
  }
}

__device__ __forceinline__ void merge(const Args& a, const Place& p, int* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int ngt = (a.G + a.GT - 1) / a.GT;
    int* ticket = a.tickets + (size_t)p.bh * ngt + p.gt;
    *last = atomicAdd(ticket, 1) == p.NS - 1;
    if (*last) *ticket = 0;
  }
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (a.D % 4 == 0) merge_rows<4>(a, p);
  else merge_rows<1>(a, p);
}

// bf16 compute: one warp per 16 query rows; QK^T and P.V on mma.sync.
template <int KIND>
__global__ void __launch_bounds__(THREADS) decode_tc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const Place p = place(a);
  const int D = a.D, LD = D + 8;  // rows padded by 8 bf16: ldmatrix without bank conflicts
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + a.GT * LD;
  __nv_bfloat16* sv = sk + KS * LD;
  int* kpos = reinterpret_cast<int*>(sv + KS * LD);
  int* qp = kpos + KS;

  stage<KIND, true>(a, p, sq, LD, a.GT, sk, sv, LD, kpos, qp);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane / 4, c = lane % 4;
  const int w0 = warp * 16;  // this warp's first row of the tile
  if (w0 < p.gn) {
    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
    float sc[KS / 8][4];
#pragma unroll
    for (int j = 0; j < KS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      ldsm_x4<false>(af, sq + (w0 + (lane / 8) % 2 * 8 + lane % 8) * LD + kk * 16 + lane / 16 * 8);
#pragma unroll
      for (int j2 = 0; j2 < KS / 16; ++j2) {
        uint32_t bf[4];
        ldsm_x4<false>(bf, sk + ((2 * j2 + lane / 16) * 8 + lane % 8) * LD + kk * 16 +
                               (lane / 8) % 2 * 8);
        mma_bf16(sc[2 * j2], af, bf[0], bf[1]);
        mma_bf16(sc[2 * j2 + 1], af, bf[2], bf[3]);
      }
    }
    // masks, the split's row max and sum (rows r and r + 8 of the warp; a
    // row's 64 keys lie on the 4 lanes of a quad)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < KS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = j * 8 + 2 * c + (e & 1);
        sc[j][e] = masked(a, p, sc[j][e], t, kpos[t], qp[w0 + r + (e >> 1) * 8]);
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    // P, rounded to bf16 as the A fragments of P.V (a C fragment pair of two
    // key n-tiles is one A fragment of 16 keys)
    uint32_t pa[KS / 16][4];
#pragma unroll
    for (int j = 0; j < KS / 8; ++j) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = expf(sc[j][e] - mx[e >> 1]);
        sum[e >> 1] += pe[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(pe[0], pe[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }
    // O = P V, 16 columns of head_dim at a time, written as they finish
    for (int dc = 0; dc < D / 16; ++dc) {
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t bf[4];
        ldsm_x4<true>(bf, sv + (kk * 16 + (lane / 8) % 2 * 8 + lane % 8) * LD + dc * 16 +
                              lane / 16 * 8);
        mma_bf16(o[0], pa[kk], bf[0], bf[1]);
        mma_bf16(o[1], pa[kk], bf[2], bf[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int g = w0 + r + hf * 8;
          if (g < p.gn)
            *reinterpret_cast<float2*>(acc_row(a, p, g) + dc * 16 + nt * 8 + 2 * c) =
                make_float2(o[nt][2 * hf], o[nt][2 * hf + 1]);
        }
    }
    if (c == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int g = w0 + r + hf * 8;
        if (g < p.gn) put_ml(a, p, g, mx[hf], sum[hf]);
      }
    }
  }
  if (p.NS > 1) merge(a, p, &last);
}

// f32 compute: f32 FMAs, each thread 4 rows of one key (scores) or of one
// head_dim column (P.V), a warp on 32 keys or columns of a row group, so one
// float4 of Q (or P) and one K (or V) value feed 4 FMAs.
template <int KIND>
__global__ void __launch_bounds__(THREADS) decode_f32_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const Place p = place(a);
  const int D = a.D, DP = D + 1;        // K / V rows padded: 32 keys hit 32 banks
  const int G4 = (a.GT + 3) / 4 * 4, GP = G4 + 4;  // rows of a key or column, padded
  float* sqt = reinterpret_cast<float*>(smem);  // [D][GP]: Q transposed
  float* spt = sqt + D * GP;                    // [KS][GP]: scores, then P, transposed
  float* sk = spt + KS * GP;                    // [KS][DP]
  float* sv = sk + KS * DP;                     // [KS][DP]
  float* rm = sv + KS * DP;                     // [G4]
  float* rl = rm + G4;                          // [G4]
  int* kpos = reinterpret_cast<int*>(rl + G4);  // [KS]
  int* qp = kpos + KS;                          // [GT]

  stage<KIND, false>(a, p, sqt, GP, G4, sk, sv, DP, kpos, qp);
  __syncthreads();

  for (int i = threadIdx.x; i < G4 / 4 * KS; i += blockDim.x) {
    const int t = i % KS, g0 = (i / KS) * 4;
    const float* kr = sk + t * DP;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 q4 = *reinterpret_cast<const float4*>(sqt + d * GP + g0);
      const float kv = kr[d];
      sc[0] = fmaf(q4.x, kv, sc[0]);
      sc[1] = fmaf(q4.y, kv, sc[1]);
      sc[2] = fmaf(q4.z, kv, sc[2]);
      sc[3] = fmaf(q4.w, kv, sc[3]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      spt[t * GP + g0 + r] = g0 + r < p.gn ? masked(a, p, sc[r], t, kpos[t], qp[g0 + r]) : NEG_INF;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < p.gn; g += THREADS / 32) {
    float* s0 = spt + lane * GP + g;
    float* s1 = spt + (lane + 32) * GP + g;
    const float mx = warp_max(fmaxf(*s0, *s1));
    const float p0 = expf(*s0 - mx), p1 = expf(*s1 - mx);
    const float sum = warp_sum(p0 + p1);
    *s0 = p0;
    *s1 = p1;
    if (lane == 0) {
      rm[g] = mx;
      rl[g] = sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G4 / 4 * D; i += blockDim.x) {
    const int d = i % D, g0 = (i / D) * 4;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int t = 0; t < KS; ++t) {
      const float4 p4 = *reinterpret_cast<const float4*>(spt + t * GP + g0);
      const float vv = sv[t * DP + d];
      o[0] = fmaf(p4.x, vv, o[0]);
      o[1] = fmaf(p4.y, vv, o[1]);
      o[2] = fmaf(p4.z, vv, o[2]);
      o[3] = fmaf(p4.w, vv, o[3]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (g0 + r < p.gn) acc_row(a, p, g0 + r)[d] = o[r];
  }
  for (int g = threadIdx.x; g < p.gn; g += blockDim.x) put_ml(a, p, g, rm[g], rl[g]);
  if (p.NS > 1) merge(a, p, &last);
}

size_t smem_bytes(int GT, int D, bool q_bf16) {
  if (q_bf16) return (size_t)(GT + 2 * KS) * (D + 8) * 2 + (size_t)(KS + GT) * 4;
  const size_t g4 = (GT + 3) / 4 * 4, gp = g4 + 4;
  return ((size_t)D * gp + KS * gp + 2 * (size_t)KS * (D + 1) + 2 * g4 + KS + GT) * 4;
}

template <class K>
cudaError_t launch(K kern, const Args& a, int B, int threads, size_t bytes, int& smem_set,
                   cudaStream_t stream) {
  if (smem_set < (int)bytes) {  // per instance: raised once, to the largest size asked
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    smem_set = static_cast<int>(bytes);
  }
  const int NS = (a.T + KS - 1) / KS, ngt = (a.G + a.GT - 1) / a.GT;
  dim3 grid(a.Hkv, B, NS * ngt);
  kern<<<grid, threads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch(const Args& a, int B, bool q_bf16, cudaStream_t stream) {
  static int set_tc = 0, set_f32 = 0;
  const size_t bytes = smem_bytes(a.GT, a.D, q_bf16);
  if (q_bf16) return launch(decode_tc_kernel<KIND>, a, B, THREADS, bytes, set_tc, stream);
  return launch(decode_f32_kernel<KIND>, a, B, THREADS, bytes, set_f32, stream);
}

}  // namespace

// Keys of a split (the wrapper's plan checks it).
extern "C" int decode_attention_split(void) { return KS; }

// Dynamic shared memory a block of GT query rows at head_dim D needs.
extern "C" long long decode_attention_smem_bytes(int GT, int D, int q_bf16) {
  return static_cast<long long>(smem_bytes(GT, D, q_bf16 != 0));
}

// q (B, C, H, D) bf16 (q_bf16 = 1, D % 16 == 0, GT <= 64 a multiple of 16)
// or f32 (GT <= 64), scaled here by qscale (f32, then rounded to q's dtype);
// H = Hkv * qpk, and a kv head's rows are its C * qpk (token, head) pairs;
// k/v (B, T, Hkv, D) bf16 / f32 values or int8 codes, (B, T, Hkv, D/2)
// packed int4 codes; ks/vs (B, T, Hkv) f32 or null; pos (B, T) int32; qpos
// (B, C) int32; acc (B, C, H, D), m / l (B, C, H) f32; with NS = ceil(T /
// 64) > 1 splits, part_acc (B * Hkv, NS, C * qpk, D) and part_ml (B * Hkv,
// NS, C * qpk, 2) f32 scratch and B * Hkv * ceil(C * qpk / GT) int32
// tickets, zero on entry (left zero). kv_kind: 0 bf16, 1 f32, 2 int8, 3
// packed int4. Returns cudaGetLastError().
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs, const void* pos,
                                       const void* qpos, void* acc, void* m, void* l,
                                       void* part_acc, void* part_ml, void* tickets, int B,
                                       int T, int C, int Hkv, int qpk, int D, int GT,
                                       int kv_kind, int q_bf16, int window, float qscale,
                                       float softcap, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || qpk <= 0) return 0;
  if (T <= 0 || GT <= 0 || GT > 64 || D % 4 || (q_bf16 && (D % 16 || GT % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, static_cast<const float*>(ks), static_cast<const float*>(vs),
         static_cast<const int*>(pos), static_cast<const int*>(qpos), static_cast<float*>(acc),
         static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), static_cast<int*>(tickets), T, C, Hkv, qpk, C * qpk, D,
         GT, window, qscale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kv_kind) {
    case KV_BF16: err = dispatch<KV_BF16>(a, B, q_bf16, s); break;
    case KV_F32: err = dispatch<KV_F32>(a, B, q_bf16, s); break;
    case KV_INT8: err = dispatch<KV_INT8>(a, B, q_bf16, s); break;
    case KV_INT4: err = dispatch<KV_INT4>(a, B, q_bf16, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
