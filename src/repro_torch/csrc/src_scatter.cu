// Source-keyed weighted gather-sum, hand-written for Hopper (sm_90a): the
// backward kernel of K1 and of K3's projected-feature input.
//
// The TPU kernels it differentiates, `fused_gather_aggregate_pallas`
// (src/repro/kernels/fused_gather_aggregate/kernel.py) and
// `fused_edge_softmax_aggregate_pallas`
// (src/repro/kernels/fused_edge_softmax_aggregate/kernel.py), had no
// backward of their own: the reference differentiates their plain versions
// with jax.value_and_grad, whose scatter-adds into source rows a GPU would
// run with float atomics. Here each source row is summed by one warp:
//
//   out[v, c] = sum_{i in [offsets[v], offsets[v+1])}
//                   w(e_i, c) * G[row_idx[e_i], c],      e_i = order[i]
//
// with `order` / `offsets` the source-grouped edge order (a stable sort of
// the masked `edge_src` keys, repro_torch/kernels/dst_groups.py), row_idx =
// edge_dst, and w = 1 (K1's backward: grad_h[v] = sum of the live edges'
// grad_out[dst]) or w(e, c) = alpha[e, c / Dh] (K3's backward into h_proj:
// d h_proj[v, h, :] = sum of alpha[e, h] * G[dst_e, h, :]). Rows no live
// edge reads (most of the padded source capacity) get zeros.
//
// Design: K1's, keyed by source. One warp per source row, its lanes across
// the F columns (float4 when F % 4 == 0, Dh % 4 == 0 and the rows are 16-byte
// aligned; scalar otherwise); the warp loads 32 of its edges' (edge, row)
// pairs at a time and broadcasts them with __shfl_sync, so each gathered
// gradient row is one coalesced read. Sums are fp32 in registers in the
// edges' original order, written once: no atomics, so two runs give the
// same bytes, which the reference's byte-identical replay needs.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The least traffic is the mask
// of every slot, the source and destination index of every live edge
// (8 bytes each), the weights of live edges (E_live * H * 4), each gradient
// row that a live edge reads once (unique live edge_dst * F * 4) and the
// output (V * F * 4); one fma per live edge and column. At K3's layer 0 of
// the paper's GAT batch the output alone is 1,056,000 x 256 x 4 bytes, so
// writing zeros into unreferenced rows is most of the time.
#include "vec.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::kWarpsPerBlock;
using repro_torch::Vec;

template <int VEC, bool WEIGHTED>
__global__ void src_scatter_kernel(const float* __restrict__ grad,
                                   const int32_t* __restrict__ row_idx,
                                   const float* __restrict__ weights,
                                   const int32_t* __restrict__ order,
                                   const int32_t* __restrict__ offsets,
                                   float* __restrict__ out, int64_t num_rows,
                                   int64_t F, int H, int64_t Dh) {
  using V = typename Vec<VEC>::type;
  // v is the same for all 32 lanes, so a warp leaves (or stays) as a whole
  // and every __shfl_sync below has its full mask.
  const int64_t v = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (v >= num_rows) return;
  const int32_t beg = offsets[v];
  const int32_t end = offsets[v + 1];
  const int64_t cols = F / VEC;
  const V* rows = reinterpret_cast<const V*>(grad);
  V* out_row = reinterpret_cast<V*>(out) + v * cols;
  for (int64_t c0 = 0; c0 < cols; c0 += 32) {
    const int64_t c = c0 + lane;
    const bool live = c < cols;
    const int head = WEIGHTED && live ? (int)((c * VEC) / Dh) : 0;
    V acc = Vec<VEC>::zero();
    for (int32_t base = beg; base < end; base += 32) {
      const int n = min(32, end - base);
      const int32_t my_edge = lane < n ? __ldg(order + base + lane) : 0;
      const int32_t my_row = lane < n ? __ldg(row_idx + my_edge) : 0;
      for (int k = 0; k < n; ++k) {
        const int32_t e = __shfl_sync(kFullMask, my_edge, k);
        const int32_t r = __shfl_sync(kFullMask, my_row, k);
        if (!live) continue;
        const V g = __ldg(rows + (int64_t)r * cols + c);
        if (WEIGHTED) {
          Vec<VEC>::axpy(acc, __ldg(weights + (int64_t)e * H + head), g);
        } else {
          Vec<VEC>::add(acc, g);
        }
      }
    }
    if (live) out_row[c] = acc;
  }
}

template <int VEC, bool WEIGHTED>
int launch(const void* grad, const void* row_idx, const void* weights,
           const void* order, const void* offsets, void* out,
           long long num_rows, long long F, int H, long long Dh,
           void* stream) {
  if (num_rows > 0 && F > 0) {
    const int64_t blocks = (num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    src_scatter_kernel<VEC, WEIGHTED>
        <<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(
            (const float*)grad, (const int32_t*)row_idx,
            (const float*)weights, (const int32_t*)order,
            (const int32_t*)offsets, (float*)out, num_rows, F, H, Dh);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// weights == nullptr sums unweighted (H and Dh unused); otherwise weights
// is (E, H) and column c takes head c / Dh. vec4 != 0 takes float4
// columns: the caller checks F % 4 == 0, Dh % 4 == 0 and 16-byte alignment
// of grad and out.
extern "C" int src_scatter_f32(const void* grad, const void* row_idx,
                               const void* weights, const void* order,
                               const void* offsets, void* out,
                               long long num_rows, long long F, int H,
                               long long Dh, int vec4, void* stream) {
  if (weights == nullptr) {
    return vec4 ? launch<4, false>(grad, row_idx, weights, order, offsets,
                                   out, num_rows, F, H, Dh, stream)
                : launch<1, false>(grad, row_idx, weights, order, offsets,
                                   out, num_rows, F, H, Dh, stream);
  }
  return vec4 ? launch<4, true>(grad, row_idx, weights, order, offsets, out,
                                num_rows, F, H, Dh, stream)
              : launch<1, true>(grad, row_idx, weights, order, offsets, out,
                                num_rows, F, H, Dh, stream);
}
