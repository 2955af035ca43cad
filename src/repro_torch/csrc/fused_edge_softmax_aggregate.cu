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
// Exactness: each output column is summed from 0 in fp32, one edge at a time
// in the group's stable order (Vec::axpy), and each (edge, head) dot product
// is a lane's partial sums over the head's columns in column order, reduced
// by warp_sum's xor butterfly. No float atomics: two runs give the same
// bytes. The order of the loads is free; the order of the arithmetic is not.
//
// What sets the pace is the chain of dependent memory round trips (offsets,
// order, edge_src, then the rows), not the bytes. Design:
//
// * Forward: one warp per destination, lanes across the row, NV column
//   vectors a lane (float4 when Dh % 4 == 0 and the rows are 16-byte
//   aligned, scalar columns otherwise), so that at F = 256 the edges are
//   walked once (a row wider than 32 * kMaxVecsPerLane vectors takes more
//   warps, one slab each, as K1 does). A batch of 32 live edges loads its
//   `order` entries, then their `edge_src` and H scores, one edge a lane;
//   lane k computes alpha of edge k for the heads of its chunk (at most
//   kMaxHeads at a time, so any H is taken) with K4's normalize
//   expression, from the destination's m and z held in registers, so the
//   forward and the backward see the same alpha bytes. The warp then
//   gathers U source rows into registers before it adds the first of them;
//   the adds run in the stable order, each column taking its head's alpha
//   from lane k with __shfl_sync. The (E, H*Dh) message array is never
//   materialised.
// * Backward: one warp per destination (a destination with no live edge
//   returns at once), its slice of G in registers and <G, out> computed
//   once a head. A batch of 32 edges loads (edge, source) and alpha, one
//   edge a lane; U source rows are gathered before any dot product, and
//   the U x H butterflies interleave. Heads of at most kSmallHeadVecs
//   column vectors (the last layer's Dh = 8) take sub-warps: a head gets
//   its column vectors' count of lanes rounded up to a power of two, the
//   spare lanes holding zero; a sub-warp of W =
//   H times that lanes takes an edge of its own, and a head's dot is
//   reduced by the same butterfly restricted to offsets below its lanes.
//   Adding exact zeros changes no bit, and the restricted butterfly builds
//   the tree that the full-warp butterfly builds over the same values
//   padded with zeros, so every ds is bitwise what one edge a warp gives.
// * U is a compile-time constant (unrolled, so the loads issue back to
//   back): kGatherFloats gathered floats a lane over the floats a lane
//   holds of a row. No bit of either output depends on it. The backward's
//   warp kernel is held to 64 registers (kBwdMinBlocks resident blocks an
//   SM): at the step's layer 0 (33,792 destinations, 2.9 live edges each)
//   its chains run in many waves and resident warps pay more than rows in
//   flight. One host function a kernel (forward_plan, backward_plan)
//   chooses the launch's Plan, which the launchers instantiate and
//   fused_edge_softmax_aggregate_plan exports. The constants were chosen on
//   the card with
//   `python -m repro_torch.kernels.fused_edge_softmax_aggregate.sweep`
//   (PERF.md, section 6); the wrappers check them against kernel.py's
//   through fused_edge_softmax_aggregate_design.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Forward: the mask of every slot,
// source and destination index and H scores of every live edge, the
// statistics, each referenced h_proj row once (unique live edge_src * F * 4)
// and the output; the arithmetic (an exp and a divide per live edge and
// head, 2 flops per live edge and column) is far below the fp32 rate.
// Backward: the same indices, alpha of every live edge, G and out (num_dst *
// F * 4 each), each referenced h_proj row once, and ds (E * H * 4).
#include "vec.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::kWarpsPerBlock;
using repro_torch::Vec;

// floats of gathered rows a lane holds before the arithmetic; column
// vectors a lane holds of a row at most; the heads whose alphas a forward
// lane holds at once where H > 2 (2 where H <= 2), the most heads a
// backward slab holds and the most heads the backward takes; heads of at
// most kSmallHeadVecs column vectors take sub-warps in the backward.
constexpr int kGatherFloats = 8;
constexpr int kMaxVecsPerLane = 8;
constexpr int kMaxHeads = 8;
constexpr int kSmallHeadVecs = 8;
// resident blocks an SM the backward's warp kernel asks of the compiler
// (8 blocks of 4 warps: at most 64 registers a thread)
constexpr int kBwdMinBlocks = 8;

// Rows gathered before the arithmetic, for `floats` floats of a row a lane.
constexpr int rows_in_flight(int gf, int floats) {
  return gf / floats < 1 ? 1 : gf / floats > 32 ? 32 : gf / floats;
}

constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

int host_min(int a, int b) { return a < b ? a : b; }

// The first `count` of x, each summed over the aligned groups of `lanes`
// lanes (a power of two, the same on every lane) by warp_sum's butterfly
// restricted to the offsets below `lanes`; the sums interleave, each one's
// additions in warp_sum's order.
template <int N>
__device__ __forceinline__ void group_sums(float (&x)[N], int count,
                                           int lanes) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (o < lanes) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if (i < count) x[i] += __shfl_xor_sync(kFullMask, x[i], o);
      }
    }
  }
}

// part + <a, b>, rounded as the compiled `part += Vec<VEC>::dot(a, b)` of
// the kernel this one replaced rounds it (read from its SASS): a float4's
// products fused as fma(w, fma(z, fma(x, y * y'))), then one add; a scalar
// column fused into the sum. Left to the compiler, the contraction of the
// same expression differed between two instantiations of one kernel (x and
// y swapped), which moves last bits; the intrinsics are never re-fused.
__device__ __forceinline__ float dot_add(float part, float a, float b) {
  return __fmaf_rn(a, b, part);
}
__device__ __forceinline__ float dot_add(float part, float4 a, float4 b) {
  return __fadd_rn(
      part, __fmaf_rn(a.w, b.w,
                      __fmaf_rn(a.z, b.z,
                                __fmaf_rn(a.x, b.x, __fmul_rn(a.y, b.y)))));
}

// m[d, hc + h] and max(z[d, hc + h], 1e-30) for the nh heads of a chunk.
template <int HC>
__device__ __forceinline__ void load_stats(const float* __restrict__ m,
                                           const float* __restrict__ z,
                                           int64_t d, int H, int hc, int nh,
                                           float (&mh)[HC], float (&zh)[HC]) {
#pragma unroll
  for (int h = 0; h < HC; ++h) {
    mh[h] = h < nh ? __ldg(m + d * H + hc + h) : 0.0f;
    zh[h] = h < nh ? fmaxf(__ldg(z + d * H + hc + h), 1e-30f) : 1.0f;
  }
}

// Warp `blockIdx.x * kWarpsPerBlock + warp` aggregates destination d over
// slab blockIdx.y of the row: NV column vectors a lane, the alphas of HC
// heads a lane at a time, U rows in flight. hcols: column vectors a head.
template <int VEC, int NV, int HC, int U>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    fused_edge_softmax_aggregate_kernel(
        const float* __restrict__ h_proj, const float* __restrict__ scores,
        const int32_t* __restrict__ edge_src,
        const int32_t* __restrict__ order, const int32_t* __restrict__ offsets,
        const float* __restrict__ m, const float* __restrict__ z,
        float* __restrict__ out, int64_t num_dst, int H, int hcols) {
  using V = typename Vec<VEC>::type;
  // d is the same for all 32 lanes, so a warp leaves (or stays) as a whole
  // and every __shfl_sync below has its full mask.
  const int64_t d = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= num_dst) return;
  const int cols = H * hcols;
  const int32_t beg = __ldg(offsets + d);
  const int32_t end = __ldg(offsets + d + 1);
  const int first = (int)blockIdx.y * NV * 32;
  V acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) acc[j] = Vec<VEC>::zero();
  if (beg < end) {
    // the heads of the slab's columns, walked in chunks of HC
    const int h_lo = first / hcols;
    const int h_hi = (min(first + NV * 32, cols) - 1) / hcols;
    const bool one_chunk = h_hi - h_lo < HC;
    float mh[HC], zh[HC];
    if (one_chunk) load_stats(m, z, d, H, h_lo, h_hi + 1 - h_lo, mh, zh);
    const V* rows = reinterpret_cast<const V*>(h_proj);
    for (int32_t base = beg; base < end; base += 32) {
      const int n = min(32, end - base);
      const int32_t my_edge = lane < n ? __ldg(order + base + lane) : 0;
      const int32_t my_src = lane < n ? __ldg(edge_src + my_edge) : 0;
      for (int hc = h_lo; hc <= h_hi; hc += HC) {
        const int nh = min(HC, h_hi + 1 - hc);
        if (!one_chunk) load_stats(m, z, d, H, hc, nh, mh, zh);
        // lane k: alpha of edge k for the chunk's heads (K4's expression)
        float a[HC];
#pragma unroll
        for (int h = 0; h < HC; ++h) {
          a[h] = lane < n && h < nh
                     ? expf(__ldg(scores + (int64_t)my_edge * H + hc + h) -
                            mh[h]) / zh[h]
                     : 0.0f;
        }
        // each column's head in the chunk, -1 where the column is not in it
        int hr[NV];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int c = first + j * 32 + lane;
          hr[j] = c < cols && c / hcols - hc < nh ? c / hcols - hc : -1;
        }
        for (int k0 = 0; k0 < n; k0 += U) {
          V g[U][NV];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (k0 + u < n) {
              const int32_t s = __shfl_sync(kFullMask, my_src, k0 + u);
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                g[u][j] = hr[j] >= 0 ? __ldg(rows + (int64_t)s * cols +
                                             first + j * 32 + lane)
                                     : Vec<VEC>::zero();
              }
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if (k0 + u < n) {
              float w[NV];
#pragma unroll
              for (int j = 0; j < NV; ++j) w[j] = 0.0f;
#pragma unroll
              for (int h = 0; h < HC; ++h) {
                if (h < nh) {
                  const float v = __shfl_sync(kFullMask, a[h], k0 + u);
#pragma unroll
                  for (int j = 0; j < NV; ++j) {
                    if (hr[j] == h) w[j] = v;
                  }
                }
              }
#pragma unroll
              for (int j = 0; j < NV; ++j) {
                if (hr[j] >= 0) Vec<VEC>::axpy(acc[j], w[j], g[u][j]);
              }
            }
          }
        }
      }
    }
  }
  V* dst_row = reinterpret_cast<V*>(out) + d * cols;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = first + j * 32 + lane;
    if (c < cols) dst_row[c] = acc[j];
  }
}

// The backward, one warp per destination and slab blockIdx.y of HS heads;
// a lane holds NVH column vectors of each head (column lane + 32 i of the
// head; columns past 32 * NVH, in rows of more than 256 floats, are read
// in a loop). MIN_BLOCKS resident blocks an SM cap its registers.
template <int VEC, int NVH, int HS, int U, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, MIN_BLOCKS)
    fused_edge_softmax_aggregate_bwd_kernel(
        const float* __restrict__ grad, const float* __restrict__ h_proj,
        const float* __restrict__ out, const float* __restrict__ alpha,
        const int32_t* __restrict__ edge_src,
        const int32_t* __restrict__ order, const int32_t* __restrict__ offsets,
        float* __restrict__ dscores, int64_t num_dst, int H, int hcols) {
  using V = typename Vec<VEC>::type;
  const int64_t d = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= num_dst) return;
  const int32_t beg = __ldg(offsets + d);
  const int32_t end = __ldg(offsets + d + 1);
  if (beg == end) return;
  // the first batch's order entries go out before <G, out>'s butterflies
  int n = min(32, end - beg);
  int32_t my_edge = lane < n ? __ldg(order + beg + lane) : 0;
  const int cols = H * hcols;
  const int h0 = (int)blockIdx.y * HS;
  const int hs = min(HS, H - h0);
  const bool tail = hcols > 32 * NVH;
  const V* g_row = reinterpret_cast<const V*>(grad) + d * cols + h0 * hcols;
  const V* o_row = reinterpret_cast<const V*>(out) + d * cols + h0 * hcols;
  const V* rows = reinterpret_cast<const V*>(h_proj) + h0 * hcols;
  V g[HS][NVH];
  float gdo[HS];
#pragma unroll
  for (int h = 0; h < HS; ++h) {
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < NVH; ++i) {
      const bool on = h < hs && lane + 32 * i < hcols;
      g[h][i] = on ? __ldg(g_row + h * hcols + lane + 32 * i)
                   : Vec<VEC>::zero();
      if (on) {
        part = dot_add(part, g[h][i],
                       __ldg(o_row + h * hcols + lane + 32 * i));
      }
    }
    if (tail && h < hs) {
      for (int c = lane + 32 * NVH; c < hcols; c += 32) {
        part = dot_add(part, __ldg(g_row + h * hcols + c),
                       __ldg(o_row + h * hcols + c));
      }
    }
    gdo[h] = part;
  }
  group_sums(gdo, HS, 32);
  for (int32_t base = beg;;) {
    const int32_t my_src = lane < n ? __ldg(edge_src + my_edge) : 0;
    float al[HS];
#pragma unroll
    for (int h = 0; h < HS; ++h) {
      al[h] = lane < n && h < hs
                  ? __ldg(alpha + (int64_t)my_edge * H + h0 + h)
                  : 0.0f;
    }
    for (int k0 = 0; k0 < n; k0 += U) {
      V r[U][HS][NVH];
      int32_t src[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u < n) {
          src[u] = __shfl_sync(kFullMask, my_src, k0 + u);
#pragma unroll
          for (int h = 0; h < HS; ++h) {
#pragma unroll
            for (int i = 0; i < NVH; ++i) {
              r[u][h][i] = h < hs && lane + 32 * i < hcols
                               ? __ldg(rows + (int64_t)src[u] * cols +
                                       h * hcols + lane + 32 * i)
                               : Vec<VEC>::zero();
            }
          }
        }
      }
      float p[U * HS];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int h = 0; h < HS; ++h) {
          float part = 0.0f;
          if (k0 + u < n) {
#pragma unroll
            for (int i = 0; i < NVH; ++i) {
              if (h < hs && lane + 32 * i < hcols) {
                part = dot_add(part, g[h][i], r[u][h][i]);
              }
            }
            if (tail && h < hs) {
              const V* src_row = rows + (int64_t)src[u] * cols + h * hcols;
              for (int c = lane + 32 * NVH; c < hcols; c += 32) {
                part = dot_add(part, __ldg(g_row + h * hcols + c),
                               __ldg(src_row + c));
              }
            }
          }
          p[u * HS + h] = part;
        }
      }
      group_sums(p, min(U, n - k0) * HS, 32);
      // lane k0 + u holds edge k0 + u and its alpha
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane == k0 + u && k0 + u < n) {
#pragma unroll
          for (int h = 0; h < HS; ++h) {
            if (h < hs) {
              dscores[(int64_t)my_edge * H + h0 + h] =
                  al[h] * (p[u * HS + h] - gdo[h]);
            }
          }
        }
      }
    }
    base += 32;
    if (base >= end) break;
    n = min(32, end - base);
    my_edge = lane < n ? __ldg(order + base + lane) : 0;
  }
}

// The backward for heads of at most kSmallHeadVecs column vectors: each
// head `lanes` lanes (a power of two, one column vector a lane, the lanes
// past hcols holding zero), a sub-warp of W = H * lanes lanes an edge, the
// warp's 32 / W sub-warps taking edges q, q + S, q + 2S, ... of a batch.
template <int VEC, int U>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    fused_edge_softmax_aggregate_bwd_small_kernel(
        const float* __restrict__ grad, const float* __restrict__ h_proj,
        const float* __restrict__ out, const float* __restrict__ alpha,
        const int32_t* __restrict__ edge_src,
        const int32_t* __restrict__ order, const int32_t* __restrict__ offsets,
        float* __restrict__ dscores, int64_t num_dst, int H, int hcols,
        int lanes) {
  using V = typename Vec<VEC>::type;
  const int64_t d = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= num_dst) return;
  const int32_t beg = __ldg(offsets + d);
  const int32_t end = __ldg(offsets + d + 1);
  if (beg == end) return;
  int n = min(32, end - beg);
  int32_t my_edge = lane < n ? __ldg(order + beg + lane) : 0;
  const int cols = H * hcols;
  const int W = H * lanes;
  const int S = 32 / W;              // sub-warps; lanes past S * W idle
  const int q = lane / W;
  const int h = (lane - q * W) / lanes;
  const int c = lane - q * W - h * lanes;
  const bool on = q < S && c < hcols;
  const int hc = h * hcols + c;      // the lane's column vector in a row
  const V gv = on ? __ldg(reinterpret_cast<const V*>(grad) + d * cols + hc)
                  : Vec<VEC>::zero();
  float gdo[1] = {0.0f};
  if (on) {
    gdo[0] = dot_add(
        gdo[0], gv, __ldg(reinterpret_cast<const V*>(out) + d * cols + hc));
  }
  group_sums(gdo, 1, lanes);
  const V* rows = reinterpret_cast<const V*>(h_proj);
  for (int32_t base = beg;;) {
    const int32_t my_src = lane < n ? __ldg(edge_src + my_edge) : 0;
    const int per = (n + S - 1) / S;   // the most edges a sub-warp takes
    for (int i0 = 0; i0 < per; i0 += U) {
      V r[U];
      float a[U];
      int32_t e[U];
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = q + S * (i0 + u);
        live[u] = q < S && k < n;
        if (i0 + u < per) {
          e[u] = __shfl_sync(kFullMask, my_edge, live[u] ? k : 0);
          const int32_t s = __shfl_sync(kFullMask, my_src, live[u] ? k : 0);
          r[u] = live[u] && on ? __ldg(rows + (int64_t)s * cols + hc)
                               : Vec<VEC>::zero();
          a[u] = live[u] && c == 0 ? __ldg(alpha + (int64_t)e[u] * H + h)
                                   : 0.0f;
        }
      }
      float p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = 0.0f;
        if (i0 + u < per && live[u] && on) p[u] = dot_add(p[u], gv, r[u]);
      }
      group_sums(p, min(U, per - i0), lanes);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (i0 + u < per && live[u] && c == 0) {
          dscores[(int64_t)e[u] * H + h] = a[u] * (p[u] - gdo[0]);
        }
      }
    }
    base += 32;
    if (base >= end) break;
    n = min(32, end - base);
    my_edge = lane < n ? __ldg(order + base + lane) : 0;
  }
}

unsigned warp_blocks(int64_t n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// How a launch lays a kernel out, for gf gathered floats a lane and H heads
// of hcols column vectors of vec floats. subwarp: the backward's sub-warp
// route. vecs: column vectors a lane of the row (forward) or of each head
// (the backward's warp route; 1 on the sub-warp route). heads: the heads
// whose alphas a forward lane holds at once, the heads of a backward slab,
// or H on the sub-warp route. slabs: blocks along y. rows: U, the rows in
// flight a warp or sub-warp. lanes: a head's lanes on the sub-warp route,
// else 32.
struct Plan {
  int subwarp, vecs, heads, slabs, rows, lanes;
};

// The forward: as many column vectors a lane as the row needs (1, 2, 4 or
// 8), at most kMaxVecsPerLane, a wider row taking more slabs; the alphas
// of 2 heads a lane where H <= 2, else of kMaxHeads.
Plan forward_plan(int gf, int H, int hcols, int vec) {
  const int cols = H * hcols;
  const int nv = host_min(pow2_at_least((cols + 31) / 32), kMaxVecsPerLane);
  return {0, nv, H <= 2 ? 2 : kMaxHeads, (cols + 32 * nv - 1) / (32 * nv),
          rows_in_flight(gf, nv * vec), 32};
}

// The backward's sub-warp route with `lanes` lanes a head: a sub-warp of
// W = H * lanes lanes an edge, U edges in flight a sub-warp (the budget's
// rows, at most the edges a sub-warp takes of a batch, each a power of
// two).
Plan subwarp_plan(int gf, int H, int lanes, int vec) {
  const int subwarps = 32 / (H * lanes);
  return {1, 1, H, 1,
          host_min(pow2_at_least(rows_in_flight(gf, vec)),
                   pow2_at_least((32 + subwarps - 1) / subwarps)),
          lanes};
}

// The backward's warp route: NVH column vectors a lane of each head (1, 2,
// 4 or 8, at most kMaxVecsPerLane); HS heads a slab, H where H <= 2, else
// as many as kMaxVecsPerLane / NVH allows (at most kMaxHeads).
Plan warp_plan(int gf, int H, int hcols, int vec) {
  const int nvh = host_min(pow2_at_least((hcols + 31) / 32), kMaxVecsPerLane);
  const int wide = host_min(kMaxVecsPerLane / nvh, kMaxHeads);
  const int hs = H <= 2 && wide >= 2 ? H : wide;
  return {0, nvh, hs, (H + hs - 1) / hs, rows_in_flight(gf, nvh * hs * vec),
          32};
}

// Heads of at most kSmallHeadVecs column vectors take the sub-warp route,
// each its vectors' count of lanes rounded up to a power of two, where H
// such heads fit a warp.
Plan backward_plan(int gf, int H, int hcols, int vec) {
  const int lanes = pow2_at_least(hcols);
  return hcols <= kSmallHeadVecs && H * lanes <= 32
             ? subwarp_plan(gf, H, lanes, vec)
             : warp_plan(gf, H, hcols, vec);
}

struct FwdArgs {
  const void* h_proj;
  const void* scores;
  const void* edge_src;
  const void* order;
  const void* offsets;
  const void* m;
  const void* z;
  void* out;
  int64_t num_dst;
  int H;
  int hcols;
  cudaStream_t stream;
};

template <int GF, int VEC, int NV, int HC>
int launch_forward_nv(const FwdArgs& a, const Plan& p) {
  fused_edge_softmax_aggregate_kernel<VEC, NV, HC,
                                      rows_in_flight(GF, NV * VEC)>
      <<<dim3(warp_blocks(a.num_dst), (unsigned)p.slabs),
         32 * kWarpsPerBlock, 0, a.stream>>>(
          (const float*)a.h_proj, (const float*)a.scores,
          (const int32_t*)a.edge_src, (const int32_t*)a.order,
          (const int32_t*)a.offsets, (const float*)a.m, (const float*)a.z,
          (float*)a.out, a.num_dst, a.H, a.hcols);
  return (int)cudaGetLastError();
}

template <int GF, int VEC, int NV>
int launch_forward_heads(const FwdArgs& a, const Plan& p) {
  return p.heads == 2 ? launch_forward_nv<GF, VEC, NV, 2>(a, p)
                      : launch_forward_nv<GF, VEC, NV, kMaxHeads>(a, p);
}

template <int GF, int VEC>
int launch_forward(const FwdArgs& a, const Plan& p) {
  switch (p.vecs) {
    case 1: return launch_forward_heads<GF, VEC, 1>(a, p);
    case 2: return launch_forward_heads<GF, VEC, 2>(a, p);
    case 4: return launch_forward_heads<GF, VEC, 4>(a, p);
    default: return launch_forward_heads<GF, VEC, kMaxVecsPerLane>(a, p);
  }
}

// The forward as the C entry point takes it, for one budget of gathered
// floats a lane.
template <int GF>
int forward(const void* h_proj, const void* scores, const void* edge_src,
            const void* order, const void* offsets, const void* m,
            const void* z, void* out, long long num_dst, int H, long long Dh,
            int vec4, void* stream) {
  if (num_dst <= 0 || H <= 0 || Dh <= 0) return (int)cudaGetLastError();
  const FwdArgs a{h_proj, scores, edge_src, order, offsets, m, z, out,
                  num_dst, H, (int)(vec4 ? Dh / 4 : Dh),
                  (cudaStream_t)stream};
  const Plan p = forward_plan(GF, H, a.hcols, vec4 ? 4 : 1);
  return vec4 ? launch_forward<GF, 4>(a, p) : launch_forward<GF, 1>(a, p);
}

struct BwdArgs {
  const void* grad;
  const void* h_proj;
  const void* out;
  const void* alpha;
  const void* edge_src;
  const void* order;
  const void* offsets;
  void* dscores;
  int64_t num_dst;
  int H;
  int hcols;
  int vec;
  cudaStream_t stream;
};

BwdArgs bwd_args(const void* grad, const void* h_proj, const void* out,
                 const void* alpha, const void* edge_src, const void* order,
                 const void* offsets, void* dscores, long long num_dst,
                 int H, long long Dh, int vec4, void* stream) {
  return {grad,     h_proj, out,     alpha, edge_src,
          order,    offsets, dscores, num_dst, H,
          (int)(vec4 ? Dh / 4 : Dh), vec4 ? 4 : 1, (cudaStream_t)stream};
}

template <int GF, int MIN_BLOCKS, int VEC, int NVH, int HS>
int launch_backward_warp(const BwdArgs& a, const Plan& p) {
  fused_edge_softmax_aggregate_bwd_kernel<
      VEC, NVH, HS, rows_in_flight(GF, NVH * HS * VEC), MIN_BLOCKS>
      <<<dim3(warp_blocks(a.num_dst), (unsigned)p.slabs),
         32 * kWarpsPerBlock, 0, a.stream>>>(
          (const float*)a.grad, (const float*)a.h_proj, (const float*)a.out,
          (const float*)a.alpha, (const int32_t*)a.edge_src,
          (const int32_t*)a.order, (const int32_t*)a.offsets,
          (float*)a.dscores, a.num_dst, a.H, a.hcols);
  return (int)cudaGetLastError();
}

// HS = p.heads: 1 or 2 where H <= 2, else kMaxVecsPerLane / NVH (at most
// kMaxHeads).
template <int GF, int MIN_BLOCKS, int VEC, int NVH>
int launch_backward_heads(const BwdArgs& a, const Plan& p) {
  constexpr int kWide = kMaxVecsPerLane / NVH < kMaxHeads
                            ? kMaxVecsPerLane / NVH
                            : kMaxHeads;
  if constexpr (kWide >= 2) {
    if (p.heads == 1) {
      return launch_backward_warp<GF, MIN_BLOCKS, VEC, NVH, 1>(a, p);
    }
    if (p.heads == 2) {
      return launch_backward_warp<GF, MIN_BLOCKS, VEC, NVH, 2>(a, p);
    }
  }
  return launch_backward_warp<GF, MIN_BLOCKS, VEC, NVH, kWide>(a, p);
}

// The sub-warp route with U = p.rows edges in flight a sub-warp (a power
// of two, at most the budget's rows rounded up).
template <int GF, int VEC, int U>
int launch_backward_small(const BwdArgs& a, const Plan& p) {
  if constexpr (U < pow2_at_least(rows_in_flight(GF, VEC))) {
    if (p.rows > U) return launch_backward_small<GF, VEC, 2 * U>(a, p);
  }
  fused_edge_softmax_aggregate_bwd_small_kernel<VEC, U>
      <<<warp_blocks(a.num_dst), 32 * kWarpsPerBlock, 0, a.stream>>>(
          (const float*)a.grad, (const float*)a.h_proj, (const float*)a.out,
          (const float*)a.alpha, (const int32_t*)a.edge_src,
          (const int32_t*)a.order, (const int32_t*)a.offsets,
          (float*)a.dscores, a.num_dst, a.H, a.hcols, p.lanes);
  return (int)cudaGetLastError();
}

template <int GF, int MIN_BLOCKS, int VEC>
int launch_backward(const BwdArgs& a, const Plan& p) {
  if (p.subwarp) return launch_backward_small<GF, VEC, 1>(a, p);
  switch (p.vecs) {
    case 1: return launch_backward_heads<GF, MIN_BLOCKS, VEC, 1>(a, p);
    case 2: return launch_backward_heads<GF, MIN_BLOCKS, VEC, 2>(a, p);
    case 4: return launch_backward_heads<GF, MIN_BLOCKS, VEC, 4>(a, p);
    default:
      return launch_backward_heads<GF, MIN_BLOCKS, VEC, kMaxVecsPerLane>(a,
                                                                         p);
  }
}

// The backward on plan p, for one budget of gathered floats a lane (the
// one p was made for) and one register cap of the warp kernel.
template <int GF, int MIN_BLOCKS>
int backward(const BwdArgs& a, const Plan& p) {
  return a.vec == 4 ? launch_backward<GF, MIN_BLOCKS, 4>(a, p)
                    : launch_backward<GF, MIN_BLOCKS, 1>(a, p);
}

}  // namespace

// The design constants, by which the wrappers check that kernel.py mirrors
// this library: 0 kGatherFloats, 1 kMaxVecsPerLane, 2 kMaxHeads, 3
// kSmallHeadVecs, 4 kBwdMinBlocks; -1 for any other index.
extern "C" int fused_edge_softmax_aggregate_design(int i) {
  const int c[] = {kGatherFloats, kMaxVecsPerLane, kMaxHeads, kSmallHeadVecs,
                   kBwdMinBlocks};
  return i >= 0 && i < 5 ? c[i] : -1;
}

// The Plan that the forward (backward == 0) or the backward launches for H
// heads of Dh floats on float4 (vec4 != 0) or scalar columns, into
// plan[0..5] in Plan's order. Returns 0, or cudaErrorInvalidValue for a
// shape the entry point refuses or launches nothing for.
extern "C" int fused_edge_softmax_aggregate_plan(int backward, int H,
                                                 long long Dh, int vec4,
                                                 int* plan) {
  if (H <= 0 || Dh <= 0 || (backward && H > kMaxHeads)) {
    return (int)cudaErrorInvalidValue;
  }
  const int vec = vec4 ? 4 : 1;
  const int hcols = (int)(Dh / vec);
  const Plan p = backward ? backward_plan(kGatherFloats, H, hcols, vec)
                          : forward_plan(kGatherFloats, H, hcols, vec);
  const int f[] = {p.subwarp, p.vecs, p.heads, p.slabs, p.rows, p.lanes};
  for (int i = 0; i < 6; ++i) plan[i] = f[i];
  return 0;
}

// m and z are K4's statistics for the same groups. vec4 != 0 takes float4
// columns: the caller checks Dh % 4 == 0 and 16-byte alignment of h_proj
// and out.
extern "C" int fused_edge_softmax_aggregate_f32(
    const void* h_proj, const void* scores, const void* edge_src,
    const void* order, const void* offsets, const void* m, const void* z,
    void* out, long long num_dst, int H, long long Dh, int vec4,
    void* stream) {
  return forward<kGatherFloats>(h_proj, scores, edge_src, order, offsets, m,
                               z, out, num_dst, H, Dh, vec4, stream);
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
  if (num_dst <= 0 || H <= 0 || Dh <= 0) return (int)cudaGetLastError();
  const BwdArgs a = bwd_args(grad, h_proj, out, alpha, edge_src, order,
                             offsets, dscores, num_dst, H, Dh, vec4, stream);
  return backward<kGatherFloats, kBwdMinBlocks>(
      a, backward_plan(kGatherFloats, H, a.hcols, a.vec));
}
