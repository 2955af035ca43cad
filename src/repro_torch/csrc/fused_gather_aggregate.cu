// K1: fused gather -> masked segment-sum, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_gather_aggregate_pallas` in
// src/repro/kernels/fused_gather_aggregate/kernel.py (body `_kernel`). That
// kernel held a (V, FB) slab of the source table in VMEM, because "V is
// thousands", and folded each gathered (EB, FB) tile into the output with a
// one-hot MXU matmul. Neither carries over: at the paper's batch of 1000 the
// input layer has V = 1,056,000 source rows, far past any on-chip memory,
// and a reduction keyed by destination needs no matmul on Hopper. Here the
// rows stream from HBM and L2:
//
//   out[d, :] = sum_{i in [offsets[d], offsets[d+1])} h_src[edge_src[order[i]], :]
//
// `order` / `offsets` are the destination-grouped edge order shared with K2
// (a stable sort of the masked dst keys, built once per block with
// torch.sort(stable=True) and torch.searchsorted,
// repro_torch/kernels/dst_groups.py). Padded edges sort past
// offsets[num_dst] and are never read. The (E, F) message array is never
// materialised.
//
// Design: one warp per destination row, its 32 lanes across the features
// (float4 columns when F % 4 == 0 and the rows are 16-byte aligned, which
// holds for F = 100 and F = 256; scalar columns otherwise, and a masked tail
// lane set when F / VEC is not a multiple of 32). The warp walks its edges
// in the stable order, 32 at a time: each lane loads one source index and
// the warp broadcasts them with __shfl_sync, so every gathered row is one
// coalesced read of F * 4 bytes. Each lane accumulates in fp32 registers
// and writes its columns once. No float atomics: the sum is deterministic
// and runs in each destination's edge order, the order of the reference's
// sequential scatter, which the byte-identical micro-batched serving
// contract needs.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The least traffic the function
// needs is the mask of every slot (E bytes), the source and destination
// index of every live edge (E_live * 8), the referenced source rows read
// once (unique live edge_src * F * 4) and the output (num_dst * F * 4);
// the arithmetic is one fp32 add per live edge and feature. The kernel
// itself reads `order` and `edge_src` for live edges only (the mask is
// folded into the order when it is built) and writes each output once. A
// source row referenced by several destinations is read again by each
// warp; those re-reads are what L2 (50 MB) absorbs, since a block's
// referenced rows (at most the graph's node count) fit in it at the sizes
// this repo serves. At the paper's batch (layer 0 of a product-sim
// scale-14 batch of 1000: E = 990,000 slots, 54,221 live, 6,927 referenced
// rows, 66,000 x 100 out) that is 30.6 MB, 9.1 us; chip_smoke.py computes
// it from each run's data and times the kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ void add(float& a, float b) { a += b; }
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
};

constexpr int kWarpsPerBlock = 4;

template <int VEC>
__global__ void fused_gather_aggregate_kernel(
    const float* __restrict__ h_src, const int32_t* __restrict__ edge_src,
    const int32_t* __restrict__ order, const int32_t* __restrict__ offsets,
    float* __restrict__ out, int64_t num_dst, int64_t F) {
  using V = typename Vec<VEC>::type;
  // d is the same for all 32 lanes, so a warp leaves (or stays) as a whole
  // and every __shfl_sync below has its full mask.
  const int64_t d = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= num_dst) return;
  const int32_t beg = offsets[d];
  const int32_t end = offsets[d + 1];
  const int64_t cols = F / VEC;
  const V* rows = reinterpret_cast<const V*>(h_src);
  V* dst_row = reinterpret_cast<V*>(out) + d * cols;
  for (int64_t c0 = 0; c0 < cols; c0 += 32) {
    const int64_t c = c0 + lane;
    const bool live = c < cols;
    V acc = Vec<VEC>::zero();
    for (int32_t base = beg; base < end; base += 32) {
      const int n = min(32, end - base);
      const int32_t mine = lane < n ? __ldg(edge_src + __ldg(order + base + lane)) : 0;
      for (int k = 0; k < n; ++k) {
        const int32_t s = __shfl_sync(0xffffffffu, mine, k);
        if (live) Vec<VEC>::add(acc, __ldg(rows + (int64_t)s * cols + c));
      }
    }
    if (live) dst_row[c] = acc;
  }
}

template <int VEC>
int launch(const void* h_src, const void* edge_src, const void* order,
           const void* offsets, void* out, long long num_dst, long long F,
           void* stream) {
  if (num_dst > 0 && F > 0) {
    const int64_t blocks = (num_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
    fused_gather_aggregate_kernel<VEC>
        <<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
            (const float*)h_src, (const int32_t*)edge_src,
            (const int32_t*)order, (const int32_t*)offsets, (float*)out,
            num_dst, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vec4 != 0 takes the float4 columns; the caller checks F % 4 == 0 and the
// 16-byte alignment of h_src and out.
extern "C" int fused_gather_aggregate_f32(const void* h_src,
                                          const void* edge_src,
                                          const void* order,
                                          const void* offsets, void* out,
                                          long long num_dst, long long F,
                                          int vec4, void* stream) {
  if (vec4) {
    return launch<4>(h_src, edge_src, order, offsets, out, num_dst, F, stream);
  }
  return launch<1>(h_src, edge_src, order, offsets, out, num_dst, F, stream);
}
