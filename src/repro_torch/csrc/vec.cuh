// Shared pieces of the port's hand-written kernels: fp32 column vectors of
// width 1 or 4 (float4 columns give one 16-byte load per lane, the fastest
// coalesced access on Hopper) and a fixed-order warp sum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

template <int VEC>
struct Vec;

template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ void add(float& a, float b) { a += b; }
  // a += w * b
  static __device__ __forceinline__ void axpy(float& a, float w, float b) {
    a += w * b;
  }
  static __device__ __forceinline__ float dot(float a, float b) {
    return a * b;
  }
};

template <>
struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void add(float4& a, float4 b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  static __device__ __forceinline__ void axpy(float4& a, float w, float4 b) {
    a.x += w * b.x;
    a.y += w * b.y;
    a.z += w * b.z;
    a.w += w * b.w;
  }
  static __device__ __forceinline__ float dot(float4 a, float4 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
};

// Butterfly sum over the 32 lanes: every lane gets the same value, and the
// order of the additions is fixed, so the result is the same on every run.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

}  // namespace repro_torch
