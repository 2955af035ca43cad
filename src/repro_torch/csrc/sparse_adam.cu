// K5: in-place row-sparse Adam, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `sparse_adam_pallas` in
// src/repro/kernels/sparse_adam/kernel.py (`_products_kernel` and
// `_update_kernel`). For every row r of `rows` (unique ids into the (N, D)
// tables w, m, v), in place:
//
//   m' = beta1 * m[row] + cm[r]          cm = (1 - beta1) * g, from the host
//   v' = beta2 * v[row] + cv[r]          cv = (1 - beta2) * g * g, from the host
//   w' = w[row] - (lr * (m' / bc1[r])) / (sqrt(v' / bc2[r]) + eps)
//
// Rows not in `rows` are never read or written, so they keep their bytes.
//
// The contract is bitwise: the result must equal NumPy's float32 update
// (the oracle of tests/test_embedding_oracle.py), which rounds after every
// operation. The TPU split the update into two programs only so that XLA
// could not contract a multiply and an add into one fused multiply-add.
// Here it is one kernel and every operation is a correctly rounded
// intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which
// nvcc never contracts, whatever -fmad says. The terms that depend on the
// host's rounding stay on the host: (1 - beta) * g is computed there in
// float32 from the double (1 - beta), and the bias corrections
// 1 - beta ** t need powf. beta1, beta2, lr and eps arrive as float32.
//
// Design: one warp per row, grid-stride over rows; lanes walk the row's D
// columns in float4 where D % 4 == 0 and every base is 16-byte aligned
// (D = 128: one float4 per lane), else one float per lane. The per-row
// bias corrections come as (R,) vectors, not broadcast to (R, D).
//
// Bound on an H100 SXM (3.35 TB/s): memory. The least traffic is each
// touched row of w, m and v read once and written once, cm and cv read
// once, and the row id and both corrections once a row:
// R * (8 * D * 4 + 12) bytes. The arithmetic is 10 flops an element
// (about 0.3 flops a byte), far below the card's fp32 rate. At R = 100,000
// and D = 128 that is 411 MB, 0.12 ms; chip_smoke.py times the kernel
// against it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Hyper {
  float beta1, beta2, lr, eps;
};

__device__ __forceinline__ void adam(float& w, float& m, float& v, float cm,
                                     float cv, float bc1, float bc2,
                                     const Hyper& h) {
  const float mm = __fadd_rn(__fmul_rn(h.beta1, m), cm);
  const float vv = __fadd_rn(__fmul_rn(h.beta2, v), cv);
  const float mhat = __fdiv_rn(mm, bc1);
  const float vhat = __fdiv_rn(vv, bc2);
  const float den = __fadd_rn(__fsqrt_rn(vhat), h.eps);
  w = __fsub_rn(w, __fdiv_rn(__fmul_rn(h.lr, mhat), den));
  m = mm;
  v = vv;
}

constexpr int kWarps = 8;
constexpr unsigned kThreads = 32 * kWarps;

template <bool VEC4>
__global__ void sparse_adam_kernel(float* __restrict__ w,
                                   float* __restrict__ m,
                                   float* __restrict__ v,
                                   const int32_t* __restrict__ rows,
                                   const float* __restrict__ cm,
                                   const float* __restrict__ cv,
                                   const float* __restrict__ bc1,
                                   const float* __restrict__ bc2, int64_t R,
                                   int64_t D, Hyper h) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); r < R;
       r += warps) {
    const int64_t row = (int64_t)__ldg(rows + r) * D;
    const int64_t seq = r * D;
    const float b1 = __ldg(bc1 + r);
    const float b2 = __ldg(bc2 + r);
    if (VEC4) {
      float4* w4 = reinterpret_cast<float4*>(w + row);
      float4* m4 = reinterpret_cast<float4*>(m + row);
      float4* v4 = reinterpret_cast<float4*>(v + row);
      const float4* cm4 = reinterpret_cast<const float4*>(cm + seq);
      const float4* cv4 = reinterpret_cast<const float4*>(cv + seq);
      for (int64_t c = lane; c < D / 4; c += 32) {
        float4 a = w4[c], b = m4[c], e = v4[c];
        const float4 gm = __ldg(cm4 + c), gv = __ldg(cv4 + c);
        adam(a.x, b.x, e.x, gm.x, gv.x, b1, b2, h);
        adam(a.y, b.y, e.y, gm.y, gv.y, b1, b2, h);
        adam(a.z, b.z, e.z, gm.z, gv.z, b1, b2, h);
        adam(a.w, b.w, e.w, gm.w, gv.w, b1, b2, h);
        w4[c] = a;
        m4[c] = b;
        v4[c] = e;
      }
    } else {
      for (int64_t c = lane; c < D; c += 32) {
        float a = w[row + c], b = m[row + c], e = v[row + c];
        adam(a, b, e, __ldg(cm + seq + c), __ldg(cv + seq + c), b1, b2, h);
        w[row + c] = a;
        m[row + c] = b;
        v[row + c] = e;
      }
    }
  }
}

}  // namespace

extern "C" int sparse_adam_f32(void* w, void* m, void* v, const void* rows,
                               const void* cm, const void* cv,
                               const void* bc1, const void* bc2, long long R,
                               long long D, float beta1, float beta2,
                               float lr, float eps, int vec4, void* stream) {
  if (R > 0 && D > 0) {
    const int64_t want = (R + kWarps - 1) / kWarps;
    const unsigned blocks = (unsigned)(want < 65535 * 16 ? want : 65535 * 16);
    const Hyper h{beta1, beta2, lr, eps};
    if (vec4) {
      sparse_adam_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          (float*)w, (float*)m, (float*)v, (const int32_t*)rows,
          (const float*)cm, (const float*)cv, (const float*)bc1,
          (const float*)bc2, R, D, h);
    } else {
      sparse_adam_kernel<false><<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
          (float*)w, (float*)m, (float*)v, (const int32_t*)rows,
          (const float*)cm, (const float*)cv, (const float*)bc1,
          (const float*)bc2, R, D, h);
    }
  }
  return (int)cudaGetLastError();
}
