// Quantizer steps shared by the port's CUDA sources, written so that NaN
// passes through them as it does through the reference's jnp.clip /
// jnp.maximum (src/repro/kernels/quant_matmul.py:53-60): fminf / fmaxf return
// the operand that is not NaN, so alone they would turn a NaN input, weight
// or scale into a clipped code and a finite output. Every input that is not
// NaN keeps the bits of the fminf / fmaxf form; ±Inf clips to the range's end
// (rintf keeps it infinite), as in jnp.clip. Each source that includes this
// header is its own library (build.py hashes the header with it).
#pragma once

namespace {

// clip(rint(u), lo, hi), NaN for a NaN u.
__device__ __forceinline__ float clip_code(float u, float lo, float hi) {
  const float q = fminf(fmaxf(rintf(u), lo), hi);
  return u != u ? u : q;
}

// max(s, eps), NaN for a NaN s.
__device__ __forceinline__ float floor_scale(float s, float eps) {
  const float f = fmaxf(s, eps);
  return s != s ? s : f;
}

// v * mf for an Eq. 6 mask mf in {0, 1}, as the reference computes it: XLA
// turns a product with a mask converted from a predicate into a select, so a
// masked NaN or Inf gives a zero; a finite v keeps the product's bits (a
// masked v gives the zero of v's sign).
__device__ __forceinline__ float mask_mul(float v, float mf) {
  return mf != 0.f ? v : copysignf(0.f, v);
}

}  // namespace
