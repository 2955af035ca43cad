// K4: per-destination masked edge softmax, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `edge_softmax_pallas` in
// src/repro/kernels/edge_softmax/kernel.py: its `_stats_kernel` (phase 1,
// which K3's `fused_edge_softmax_aggregate_pallas` also runs) and its
// `_norm_kernel` (phase 2). Both phases matched edges to destinations with
// a one-hot (EB, NB) MXU matmul over every (edge block, dst block) pair;
// Hopper reduces over the destination-grouped edge order instead
// (repro_torch/kernels/dst_groups.py), so each destination reads only its
// own live edges and padded edges are never read.
//
//   stats:     m[d, h] = max over live e -> d of s[e, h]   (0 if d has none)
//              z[d, h] = sum over live e -> d of exp(s[e, h] - m[d, h])
//   normalize: alpha[e, h] = exp(s[e, h] - m[dst_e, h]) / max(z[dst_e, h], 1e-30)
//              on live edges, 0 on padded ones
//
// These are the rules of the reference's oracle (edge_softmax/ref.py):
// masked scores are -1e30, a destination whose max stays at or below -5e29
// gets max 0 (and, since exp(-5e29) is 0 in fp32, denominator 0), and the
// denominator is clamped at 1e-30.
//
// Design. Stats: one thread per (destination, head), neighbouring threads
// on neighbouring heads and destinations, each walking its destination's
// live edges in their stable original order with the online-rescaled max
// and denominator of FlashAttention (one pass, fp32 registers, no atomics:
// deterministic). With H = 2 heads this keeps every lane busy where a warp
// per destination would leave 30 of 32 lanes idle. Normalize: one thread
// per (edge, head), reading the statistics of its destination.
//
// Bound on an H100 SXM (3.35 TB/s): memory, and the launch at this repo's
// sizes. Stats need the mask of every slot, the destination index and H
// scores of every live edge, and write 2 * num_dst * H floats; normalize
// reads every slot's mask, destination and scores and the statistics, and
// writes E * H floats. Both are a few hundred kilobytes at the paper's
// batch, a fraction of a microsecond of bandwidth, so a launch is latency.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

__global__ void edge_softmax_stats_kernel(const float* __restrict__ scores,
                                          const int32_t* __restrict__ order,
                                          const int32_t* __restrict__ offsets,
                                          float* __restrict__ m_out,
                                          float* __restrict__ z_out,
                                          int64_t num_dst, int H) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_dst * H) return;
  const int64_t d = t / H;
  const int h = (int)(t - d * H);
  const int32_t beg = offsets[d];
  const int32_t end = offsets[d + 1];
  float m = kNeg;
  float z = 0.0f;
  for (int32_t i = beg; i < end; ++i) {
    const float s = __ldg(scores + (int64_t)__ldg(order + i) * H + h);
    if (s > m) {
      z = z * expf(m - s) + 1.0f;
      m = s;
    } else {
      z += expf(s - m);
    }
  }
  if (m <= kNeg / 2) {  // no live edge (the reference's empty-dst rule)
    m = 0.0f;
    z = 0.0f;
  }
  m_out[t] = m;
  z_out[t] = z;
}

__global__ void edge_softmax_norm_kernel(const float* __restrict__ scores,
                                         const int32_t* __restrict__ edge_dst,
                                         const bool* __restrict__ mask,
                                         const float* __restrict__ m,
                                         const float* __restrict__ z,
                                         float* __restrict__ alpha,
                                         int64_t E, int H) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= E * H) return;
  const int64_t e = t / H;
  if (!mask[e]) {
    alpha[t] = 0.0f;
    return;
  }
  const int64_t k = (int64_t)__ldg(edge_dst + e) * H + (t - e * H);
  alpha[t] = expf(__ldg(scores + t) - __ldg(m + k)) / fmaxf(__ldg(z + k), 1e-30f);
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int edge_softmax_stats_f32(const void* scores, const void* order,
                                      const void* offsets, void* m, void* z,
                                      long long num_dst, int H,
                                      void* stream) {
  const int64_t n = (int64_t)num_dst * H;
  if (n > 0) {
    edge_softmax_stats_kernel<<<blocks_for(n), kThreads, 0,
                                (cudaStream_t)stream>>>(
        (const float*)scores, (const int32_t*)order, (const int32_t*)offsets,
        (float*)m, (float*)z, num_dst, H);
  }
  return (int)cudaGetLastError();
}

extern "C" int edge_softmax_norm_f32(const void* scores, const void* edge_dst,
                                     const void* mask, const void* m,
                                     const void* z, void* alpha, long long E,
                                     int H, void* stream) {
  const int64_t n = (int64_t)E * H;
  if (n > 0) {
    edge_softmax_norm_kernel<<<blocks_for(n), kThreads, 0,
                               (cudaStream_t)stream>>>(
        (const float*)scores, (const int32_t*)edge_dst, (const bool*)mask,
        (const float*)m, (const float*)z, (float*)alpha, E, H);
  }
  return (int)cudaGetLastError();
}
