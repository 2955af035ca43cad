// K3: the GAT attention tail (edge softmax -> weighted gather -> aggregate)
// and its backward into the scores, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_edge_softmax_aggregate_pallas` in
// src/repro/kernels/fused_edge_softmax_aggregate/kernel.py. Its phase 1 is
// K4's statistics kernel (edge_softmax.cu, launched first by the wrapper);
// its phase 2, `_agg_kernel`, kept the whole (V, H*Dh) projected table in
// VMEM and folded each (EB, F) weighted message tile into the output with a
// one-hot MXU matmul. On Hopper the table (1,056,000 x 256 floats at the
// paper's layer 0) streams from HBM and L2, and each destination walks its
// own live edges in the destination-grouped order
// (repro_torch/kernels/dst_groups.py):
//
//   forward:  out[d, h*Dh + k] = sum_{live e -> d} alpha[e, h] * h_proj[src_e, h, k]
//             alpha[e, h] = exp(s[e, h] - m[d, h]) / max(z[d, h], 1e-30)
//   backward: ds[e, h] = alpha[e, h] * (<G[d, h, :], h_proj[src_e, h, :]>
//                                       - <G[d, h, :], out[d, h, :]>)
//
// The backward is FlashAttention's identity: sum_e alpha[e,h] h_proj[src_e,h]
// is out[d, h], saved by the forward, so the softmax's backward needs no
// second per-destination reduction over the edges. alpha comes from K4's
// normalize kernel on the saved statistics. The gradient into h_proj is the
// source-keyed src_scatter.cu with weights alpha.
//
// Design. Forward: one warp per destination, lanes across the H*Dh columns
// (float4 when Dh % 4 == 0 and the rows are 16-byte aligned), 32 edges'
// (edge, source) pairs loaded at a time and broadcast with __shfl_sync as
// K1 does; each lane computes alpha for its own head with the same
// expression as K4's normalize kernel (so forward and backward see the same
// alpha bytes) and accumulates alpha * h_proj in fp32 registers. The
// (E, H*Dh) message array is never materialised. Backward: one warp per
// destination; per head, the lanes split the head's Dh columns, and a fixed
// butterfly warp sum gives each dot product. No atomics anywhere: two runs
// give the same bytes.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Forward: the mask of every slot,
// source and destination index and H scores of every live edge, the
// statistics, each referenced h_proj row once (unique live edge_src * F * 4)
// and the output; the arithmetic (an exp and a divide per live edge and
// column, 2 flops per column) is far below the fp32 rate. Backward: the
// same indices, alpha of every live edge, G and out (num_dst * F * 4 each),
// each referenced h_proj row once, and ds (E * H * 4).
#include "vec.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::kWarpsPerBlock;
using repro_torch::Vec;
using repro_torch::warp_sum;

constexpr int kMaxHeads = 8;

template <int VEC>
__global__ void fused_edge_softmax_aggregate_kernel(
    const float* __restrict__ h_proj, const float* __restrict__ scores,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, const float* __restrict__ m,
    const float* __restrict__ z, float* __restrict__ out, int64_t num_dst,
    int H, int64_t Dh) {
  using V = typename Vec<VEC>::type;
  // d is the same for all 32 lanes, so a warp leaves (or stays) as a whole
  // and every __shfl_sync below has its full mask.
  const int64_t d = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= num_dst) return;
  const int32_t beg = offsets[d];
  const int32_t end = offsets[d + 1];
  const int64_t cols = H * Dh / VEC;
  const V* rows = reinterpret_cast<const V*>(h_proj);
  V* out_row = reinterpret_cast<V*>(out) + d * cols;
  for (int64_t c0 = 0; c0 < cols; c0 += 32) {
    const int64_t c = c0 + lane;
    const bool live = c < cols;
    const int h = live ? (int)((c * VEC) / Dh) : 0;
    const float mh = __ldg(m + d * H + h);
    const float zh = fmaxf(__ldg(z + d * H + h), 1e-30f);
    V acc = Vec<VEC>::zero();
    for (int32_t base = beg; base < end; base += 32) {
      const int n = min(32, end - base);
      const int32_t my_edge = lane < n ? __ldg(order + base + lane) : 0;
      const int32_t my_src = lane < n ? __ldg(edge_src + my_edge) : 0;
      for (int k = 0; k < n; ++k) {
        const int32_t e = __shfl_sync(kFullMask, my_edge, k);
        const int32_t s = __shfl_sync(kFullMask, my_src, k);
        if (!live) continue;
        const float alpha = expf(__ldg(scores + (int64_t)e * H + h) - mh) / zh;
        Vec<VEC>::axpy(acc, alpha, __ldg(rows + (int64_t)s * cols + c));
      }
    }
    if (live) out_row[c] = acc;
  }
}

// <a[0:n], b[0:n]> over one head's columns, split across the warp's lanes.
template <int VEC>
__device__ __forceinline__ float head_dot(const typename Vec<VEC>::type* a,
                                          const typename Vec<VEC>::type* b,
                                          int64_t n, int lane) {
  float part = 0.0f;
  for (int64_t c = lane; c < n; c += 32) part += Vec<VEC>::dot(__ldg(a + c), __ldg(b + c));
  return warp_sum(part);
}

template <int VEC>
__global__ void fused_edge_softmax_aggregate_bwd_kernel(
    const float* __restrict__ grad, const float* __restrict__ h_proj,
    const float* __restrict__ out, const float* __restrict__ alpha,
    const int32_t* __restrict__ edge_src, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, float* __restrict__ dscores,
    int64_t num_dst, int H, int64_t Dh) {
  using V = typename Vec<VEC>::type;
  const int64_t d = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= num_dst) return;
  const int32_t beg = offsets[d];
  const int32_t end = offsets[d + 1];
  if (beg == end) return;
  const int64_t hcols = Dh / VEC;          // vector columns per head
  const int64_t cols = H * hcols;
  const V* g_row = reinterpret_cast<const V*>(grad) + d * cols;
  const V* o_row = reinterpret_cast<const V*>(out) + d * cols;
  const V* rows = reinterpret_cast<const V*>(h_proj);
  float g_dot_out[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    g_dot_out[h] = h < H ? head_dot<VEC>(g_row + h * hcols, o_row + h * hcols,
                                         hcols, lane)
                         : 0.0f;
  }
  for (int32_t i = beg; i < end; ++i) {
    const int32_t e = __ldg(order + i);
    const V* src_row = rows + (int64_t)__ldg(edge_src + e) * cols;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h >= H) break;
      const float dot = head_dot<VEC>(g_row + h * hcols, src_row + h * hcols,
                                      hcols, lane);
      if (lane == 0) {
        const int64_t t = (int64_t)e * H + h;
        dscores[t] = __ldg(alpha + t) * (dot - g_dot_out[h]);
      }
    }
  }
}

unsigned warp_blocks(int64_t n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int VEC>
int launch_forward(const void* h_proj, const void* scores,
                   const void* edge_src, const void* order,
                   const void* offsets, const void* m, const void* z,
                   void* out, long long num_dst, int H, long long Dh,
                   void* stream) {
  if (num_dst > 0 && H > 0 && Dh > 0) {
    fused_edge_softmax_aggregate_kernel<VEC>
        <<<warp_blocks(num_dst), 32 * kWarpsPerBlock, 0,
           (cudaStream_t)stream>>>(
            (const float*)h_proj, (const float*)scores,
            (const int32_t*)edge_src, (const int32_t*)order,
            (const int32_t*)offsets, (const float*)m, (const float*)z,
            (float*)out, num_dst, H, Dh);
  }
  return (int)cudaGetLastError();
}

template <int VEC>
int launch_backward(const void* grad, const void* h_proj, const void* out,
                    const void* alpha, const void* edge_src,
                    const void* order, const void* offsets, void* dscores,
                    long long num_dst, int H, long long Dh, void* stream) {
  if (num_dst > 0 && H > 0 && Dh > 0) {
    fused_edge_softmax_aggregate_bwd_kernel<VEC>
        <<<warp_blocks(num_dst), 32 * kWarpsPerBlock, 0,
           (cudaStream_t)stream>>>(
            (const float*)grad, (const float*)h_proj, (const float*)out,
            (const float*)alpha, (const int32_t*)edge_src,
            (const int32_t*)order, (const int32_t*)offsets, (float*)dscores,
            num_dst, H, Dh);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// m and z are K4's statistics for the same groups. vec4 != 0 takes float4
// columns: the caller checks Dh % 4 == 0 and 16-byte alignment of h_proj
// and out.
extern "C" int fused_edge_softmax_aggregate_f32(
    const void* h_proj, const void* scores, const void* edge_src,
    const void* order, const void* offsets, const void* m, const void* z,
    void* out, long long num_dst, int H, long long Dh, int vec4,
    void* stream) {
  return vec4 ? launch_forward<4>(h_proj, scores, edge_src, order, offsets,
                                  m, z, out, num_dst, H, Dh, stream)
              : launch_forward<1>(h_proj, scores, edge_src, order, offsets,
                                  m, z, out, num_dst, H, Dh, stream);
}

// Writes ds for the live edges only; the caller zero-fills dscores so that
// padded edges get 0. H <= 8. vec4 != 0 takes float4 columns: the caller
// checks Dh % 4 == 0 and 16-byte alignment of grad, h_proj and out.
extern "C" int fused_edge_softmax_aggregate_bwd_f32(
    const void* grad, const void* h_proj, const void* out, const void* alpha,
    const void* edge_src, const void* order, const void* offsets,
    void* dscores, long long num_dst, int H, long long Dh, int vec4,
    void* stream) {
  if (H > kMaxHeads) return (int)cudaErrorInvalidValue;
  return vec4 ? launch_backward<4>(grad, h_proj, out, alpha, edge_src, order,
                                   offsets, dscores, num_dst, H, Dh, stream)
              : launch_backward<1>(grad, h_proj, out, alpha, edge_src, order,
                                   offsets, dscores, num_dst, H, Dh, stream);
}
