// K2: masked segment-sum, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `segment_sum_pallas` in
// src/repro/kernels/segment_sum/kernel.py (body `_kernel`), which turned the
// scatter into a one-hot MXU matmul because the TPU has no fast scatter.
// Hopper needs no matmul for a reduction keyed by destination, so this kernel
// is a plain gather-reduce over a destination-grouped edge order:
//
//   out[d, f] = sum_{i in [offsets[d], offsets[d+1])} msg[order[i], f]
//
// `order` is a STABLE sort of the edges by key (dst if the mask is set, else
// num_dst) and `offsets` the CSR offsets of the live keys; the caller builds
// both once per block on the card (torch.sort(stable=True) and
// torch.searchsorted, repro_torch/kernels/dst_groups.py) and shares them
// with K1.
// Padded edges sort past offsets[num_dst] and are never read.
//
// Design: one thread per output element (d, f), flattened, so F = 1 (the
// masked in-degree `_degrees` on the GraphSAGE path) runs one thread per
// destination instead of a block per destination, and F = 256 puts
// neighbouring threads on neighbouring features of one message row
// (coalesced row reads). Each thread sums its destination's edges in the
// stable order in fp32 with no atomics: the result is deterministic and adds
// in the same order as the reference's sequential scatter. bf16 input is
// accumulated in fp32 and rounded to bf16 once, on the store.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The least traffic the function
// needs is the mask of every slot (E bytes), the destination index and
// message row of every live edge (E_live * (4 + F * itemsize)) and the
// output (num_dst * F * itemsize). The arithmetic is one add per live edge
// and feature, so the bytes bound it at every width this repo uses. The
// design reads `order` and the message rows of live edges only (the mask
// is folded into the order when it is built), every live message row
// exactly once per feature column, each row segment coalesced across a
// warp. As `_degrees` on layer 0 of the paper's batch (E = 990,000 slots,
// 54,221 live, 66,000 destinations, F = 1) that is 1.7 MB, 0.50 us;
// chip_smoke.py computes it from each run's data and times the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ msg,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ offsets,
                                   T* __restrict__ out, int64_t num_dst,
                                   int64_t F) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_dst * F) return;
  const int64_t d = t / F;
  const int64_t f = t - d * F;
  const int32_t beg = offsets[d];
  const int32_t end = offsets[d + 1];
  float acc = 0.0f;
  for (int32_t i = beg; i < end; ++i) {
    acc += load_f32(msg + (int64_t)__ldg(order + i) * F + f);
  }
  store_f32(out + t, acc);
}

constexpr int kThreads = 256;

template <typename T>
int launch(const void* msg, const void* order, const void* offsets, void* out,
           long long num_dst, long long F, void* stream) {
  const int64_t n = (int64_t)num_dst * F;
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    segment_sum_kernel<T><<<(unsigned)blocks, kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const T*)msg, (const int32_t*)order, (const int32_t*)offsets,
        (T*)out, num_dst, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int segment_sum_f32(const void* msg, const void* order,
                               const void* offsets, void* out,
                               long long num_dst, long long F, void* stream) {
  return launch<float>(msg, order, offsets, out, num_dst, F, stream);
}

extern "C" int segment_sum_bf16(const void* msg, const void* order,
                                const void* offsets, void* out,
                                long long num_dst, long long F,
                                void* stream) {
  return launch<__nv_bfloat16>(msg, order, offsets, out, num_dst, F, stream);
}
