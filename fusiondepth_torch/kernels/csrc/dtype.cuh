// Storage types of the kernels: float32, and bfloat16 for
// compute_dtype="bfloat16". A bfloat16 kernel loads its bf16 operands as
// they are stored, widens them to float32 in registers (exact: bf16 is the
// top half of a float32), computes in float32 and rounds once where it
// stores bf16 (round to nearest even, as torch's and XLA's conversions
// do). The float32 overloads are the plain loads and stores the kernels
// used before the bf16 entries existed, so their instantiations compile
// to the same code.
//
// The bf16 accesses go through the raw 16 bits (unsigned short), whose
// read-only and cache-hinted intrinsics exist on every toolkit, and
// cuda_bf16.h's conversions.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

static __device__ __forceinline__ float bits_to_f(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}

static __device__ __forceinline__ unsigned short f_to_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v rounded to bf16 and widened back: the value a bf16 tensor op stores
static __device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// read-only load through the texture path
static __device__ __forceinline__ float ldg_f(const float* p) {
  return __ldg(p);
}
static __device__ __forceinline__ float ldg_f(const bf16* p) {
  return bits_to_f(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// plain load (shared or global, no cache hint)
static __device__ __forceinline__ float ld_f(const float* p) { return *p; }
static __device__ __forceinline__ float ld_f(const bf16* p) {
  return bits_to_f(*reinterpret_cast<const unsigned short*>(p));
}

// evict-first load and store of data touched once
static __device__ __forceinline__ float ldcs_f(const float* p) {
  return __ldcs(p);
}
static __device__ __forceinline__ float ldcs_f(const bf16* p) {
  return bits_to_f(__ldcs(reinterpret_cast<const unsigned short*>(p)));
}
static __device__ __forceinline__ void stcs_f(float* p, float v) {
  __stcs(p, v);
}
static __device__ __forceinline__ void stcs_f(bf16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p), f_to_bits(v));
}

// plain store, rounded once for bf16
static __device__ __forceinline__ void st_f(float* p, float v) { *p = v; }
static __device__ __forceinline__ void st_f(bf16* p, float v) {
  *reinterpret_cast<unsigned short*>(p) = f_to_bits(v);
}

// two neighbouring values, 8 (float) or 4 (bf16) bytes, aligned to that
static __device__ __forceinline__ void st2_f(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}
static __device__ __forceinline__ void st2_f(bf16* p, float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}
