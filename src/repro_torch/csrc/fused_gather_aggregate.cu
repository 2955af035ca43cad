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
// Exactness: every destination is summed from 0 in fp32, one edge at a time
// in its stable order, each add rounded (__fadd_rn): the reference's
// sequential scatter, so the output is bitwise that of
// fused_gather_aggregate_ref under deterministic algorithms. No float
// atomics and no reassociation, which the byte-identical micro-batched
// serving contract needs (a request co-batched gives the bytes it gives
// alone).
//
// What sets the pace is the chain of dependent memory round trips, not the
// bytes: a walk in which each add waits for its own gathered row costs a
// destination of 15 edges 15 serial L2/HBM round trips. The adds stay in
// order; the loads leave the chain:
//
// * One warp per destination, its lanes across the row: each lane holds
//   NV column vectors (float4 where F % 4 == 0 and the rows are 16-byte
//   aligned, which holds for F = 100 and F = 256; scalar columns otherwise)
//   for up to 32 * kMaxVecsPerLane vectors, so the edges are walked once
//   with the whole row (a wider row takes more warps, one slab each).
// * A batch of 32 edges loads its `order` entries and then their
//   `edge_src` once, one edge a lane (two round trips a batch).
// * The warp then gathers U rows into registers, their source indices
//   broadcast with __shfl_sync, before it adds the first of them in edge
//   order: U = the launch's gathered floats / floats a lane holds of a
//   row, at most 32, a compile-time constant unrolled so that the loads
//   issue back to back. A destination of up to 15 edges costs four or
//   five round trips: offsets, order, edge_src, one or two rounds of rows.
// * The rows in flight cost registers, and registers cost resident warps:
//   more rows help a launch of few destinations, more warps help one of
//   many, where the chain of round trips runs in many waves (the paper
//   batch's 66,000 layer-0 destinations hold 0.8 live edges each). So the
//   launch's size picks the budget: up to kFewDst destinations (the tick's
//   layers 1 and 2) kGatherFloatsFew floats a lane (U = 16 rows at
//   F = 256), up to kManyDst (the tick's layer 0, 4,224) kGatherFloatsMid
//   (U = 8 at F = 100), beyond kGatherFloatsMany (U = 4). Every destination
//   is summed in the same order whichever is taken. (src_scatter, with 32
//   edges' columns in flight, reaches 223-224 registers and loses
//   occupancy for it.) Packing several destinations into a warp, to walk
//   the paper batch in one wave, was measured slower than a warp each.
//   The constants were
//   chosen on the card with `python -m repro_torch.kernels.segment_sum.sweep`
//   (PERF.md, section 6); the wrapper checks them against kernel.py's
//   through fused_gather_aggregate_design.
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
#include "vec.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::kWarpsPerBlock;
using repro_torch::Vec;

// floats of gathered rows a lane holds before the adds, by the launch's
// size: kGatherFloatsFew up to kFewDst destinations, kGatherFloatsMid up
// to kManyDst, kGatherFloatsMany beyond; and column vectors a lane holds
// at most
constexpr int kGatherFloatsFew = 128;
constexpr int kGatherFloatsMid = 32;
constexpr int kGatherFloatsMany = 16;
constexpr int kFewDst = 1024;
constexpr int kManyDst = 8192;
constexpr int kMaxVecsPerLane = 8;

__device__ __forceinline__ void add_rn(float& a, float b) {
  a = __fadd_rn(a, b);
}
__device__ __forceinline__ void add_rn(float4& a, float4 b) {
  add_rn(a.x, b.x);
  add_rn(a.y, b.y);
  add_rn(a.z, b.z);
  add_rn(a.w, b.w);
}

// Rows gathered before the adds for NV column vectors of VEC floats a lane.
template <int GF, int VEC, int NV>
constexpr int rows_in_flight() {
  return GF / (NV * VEC) < 1    ? 1
         : GF / (NV * VEC) > 32 ? 32
                                : GF / (NV * VEC);
}

// Warp `blockIdx.x * kWarpsPerBlock + warp` sums destination d over slab
// blockIdx.y of the row, NV column vectors a lane.
template <int VEC, int NV, int U>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    fused_gather_aggregate_kernel(const float* __restrict__ h_src,
                                  const int32_t* __restrict__ edge_src,
                                  const int32_t* __restrict__ order,
                                  const int32_t* __restrict__ offsets,
                                  float* __restrict__ out, int64_t num_dst,
                                  int cols) {
  using V = typename Vec<VEC>::type;
  // d is the same for all 32 lanes, so a warp leaves (or stays) as a whole
  // and every __shfl_sync below has its full mask.
  const int64_t d = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= num_dst) return;
  const int32_t beg = __ldg(offsets + d);
  const int32_t end = __ldg(offsets + d + 1);
  int col[NV];
  bool on[NV];
  V acc[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    col[j] = ((int)blockIdx.y * NV + j) * 32 + lane;
    on[j] = col[j] < cols;
    acc[j] = Vec<VEC>::zero();
  }
  const V* rows = reinterpret_cast<const V*>(h_src);
  for (int32_t base = beg; base < end; base += 32) {
    const int n = min(32, end - base);
    const int32_t mine =
        lane < n ? __ldg(edge_src + __ldg(order + base + lane)) : 0;
    for (int k0 = 0; k0 < n; k0 += U) {
      V g[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int32_t s = __shfl_sync(kFullMask, mine, min(k0 + u, n - 1));
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          g[u][j] = k0 + u < n && on[j]
                        ? __ldg(rows + (int64_t)s * cols + col[j])
                        : Vec<VEC>::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u < n) {
#pragma unroll
          for (int j = 0; j < NV; ++j) add_rn(acc[j], g[u][j]);
        }
      }
    }
  }
  V* dst_row = reinterpret_cast<V*>(out) + d * cols;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (on[j]) dst_row[col[j]] = acc[j];
  }
}

template <int GF, int VEC, int NV>
int launch_nv(const void* h_src, const void* edge_src, const void* order,
              const void* offsets, void* out, int64_t num_dst, int cols,
              cudaStream_t stream) {
  const int64_t blocks = (num_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t slabs = (cols + 32 * NV - 1) / (32 * NV);
  fused_gather_aggregate_kernel<VEC, NV, rows_in_flight<GF, VEC, NV>()>
      <<<dim3((unsigned)blocks, (unsigned)slabs), 32 * kWarpsPerBlock, 0,
         stream>>>((const float*)h_src, (const int32_t*)edge_src,
                   (const int32_t*)order, (const int32_t*)offsets,
                   (float*)out, num_dst, cols);
  return (int)cudaGetLastError();
}

// Column vectors a lane: as many as the row needs (1, 2, 4 or 8), at most
// MAX_NV; a wider row takes more slabs.
template <int GF, int MAX_NV, int VEC>
int launch(const void* h_src, const void* edge_src, const void* order,
           const void* offsets, void* out, int64_t num_dst, int cols,
           cudaStream_t s) {
  const int need = (cols + 31) / 32;
  if (MAX_NV <= 1 || need <= 1) {
    return launch_nv<GF, VEC, 1>(h_src, edge_src, order, offsets, out,
                                 num_dst, cols, s);
  }
  if (MAX_NV <= 2 || need <= 2) {
    return launch_nv<GF, VEC, 2>(h_src, edge_src, order, offsets, out,
                                 num_dst, cols, s);
  }
  if (MAX_NV <= 4 || need <= 4) {
    return launch_nv<GF, VEC, 4>(h_src, edge_src, order, offsets, out,
                                 num_dst, cols, s);
  }
  return launch_nv<GF, VEC, 8>(h_src, edge_src, order, offsets, out, num_dst,
                               cols, s);
}

// The call as the C entry point takes it, for one choice of the design
// constants (gathered floats a lane, column vectors a lane at most).
template <int GF, int MAX_NV>
int fused_gather_aggregate(const void* h_src, const void* edge_src,
                           const void* order, const void* offsets, void* out,
                           long long num_dst, long long F, int vec4,
                           void* stream) {
  if (num_dst <= 0 || F <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    return launch<GF, MAX_NV, 4>(h_src, edge_src, order, offsets, out,
                                 num_dst, (int)(F / 4), s);
  }
  return launch<GF, MAX_NV, 1>(h_src, edge_src, order, offsets, out, num_dst,
                               (int)F, s);
}

// The launch's register budget from its size: more rows in flight for few
// destinations, more resident warps for many. No bit of the result depends
// on the choice.
int fused_gather_aggregate_sized(const void* h_src, const void* edge_src,
                                 const void* order, const void* offsets,
                                 void* out, long long num_dst, long long F,
                                 int vec4, void* stream) {
  if (num_dst > kManyDst) {
    return fused_gather_aggregate<kGatherFloatsMany, kMaxVecsPerLane>(
        h_src, edge_src, order, offsets, out, num_dst, F, vec4, stream);
  }
  if (num_dst > kFewDst) {
    return fused_gather_aggregate<kGatherFloatsMid, kMaxVecsPerLane>(
        h_src, edge_src, order, offsets, out, num_dst, F, vec4, stream);
  }
  return fused_gather_aggregate<kGatherFloatsFew, kMaxVecsPerLane>(
      h_src, edge_src, order, offsets, out, num_dst, F, vec4, stream);
}

}  // namespace

// The design constants, by which the wrapper checks that kernel.py mirrors
// this library: 0 kGatherFloatsFew, 1 kGatherFloatsMid, 2 kGatherFloatsMany,
// 3 kFewDst, 4 kManyDst, 5 kMaxVecsPerLane; -1 for any other index.
extern "C" int fused_gather_aggregate_design(int i) {
  const int c[] = {kGatherFloatsFew, kGatherFloatsMid, kGatherFloatsMany,
                   kFewDst,          kManyDst,         kMaxVecsPerLane};
  return i >= 0 && i < 6 ? c[i] : -1;
}

// vec4 != 0 takes the float4 columns; the caller checks F % 4 == 0 and the
// 16-byte alignment of h_src and out.
extern "C" int fused_gather_aggregate_f32(const void* h_src,
                                          const void* edge_src,
                                          const void* order,
                                          const void* offsets, void* out,
                                          long long num_dst, long long F,
                                          int vec4, void* stream) {
  return fused_gather_aggregate_sized(
      h_src, edge_src, order, offsets, out, num_dst, F, vec4, stream);
}
