// K2: masked segment-sum, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `segment_sum_pallas` in
// src/repro/kernels/segment_sum/kernel.py (body `_kernel`), which turned the
// scatter into a one-hot MXU matmul because the TPU has no fast scatter.
// Hopper needs no matmul for a reduction keyed by destination, so this kernel
// is a plain gather-reduce over a key-grouped edge order:
//
//   out[d, f] = sum_{i in [offsets[d], offsets[d+1])} msg[order[i], f]
//
// `order` is a STABLE sort of the edges by key (dst if the mask is set, else
// num_dst) and `offsets` the CSR offsets of the live keys; the caller builds
// both once per block on the card (torch.sort(stable=True) and
// torch.searchsorted, repro_torch/kernels/dst_groups.py) and shares them
// with K1. Inside backward passes the groups are keyed by source row instead
// (the GAT logits' gradients), where a group can hold hundreds of edges.
// Padded edges sort past offsets[num_dst] and are never read.
//
// Exactness: every group is summed from 0 in fp32, one edge at a time in its
// stable order, each add rounded (__fadd_rn) -- the plain version's
// sequential scatter, so the output is bitwise that of segment_sum_ref under
// deterministic algorithms, and two launches give the same bytes. No float
// atomics and no reassociation: a tree or chunked sum of nearly cancelling
// unit-scale terms strays past the 1e-5 the port holds kernels to (PERF.md,
// section 6). bf16 input is accumulated in fp32 and rounded to bf16 once, on
// the store.
//
// What sets the pace is the chain of dependent memory round trips, not the
// adds: where each add waits for its own edge's order entry and then its
// message value, a group of n edges costs 2n round trips. So the loads
// come off the chain and only the adds stay on it. The
// schedule is keyed on F alone (schedule() in
// repro_torch/kernels/segment_sum/kernel.py mirrors the switch):
//
// * F <= kSmallFMax (the F = 1 of `_degrees`, the F = 2 of GAT's logit
//   gradients): lanes across edges. A group belongs to a sub-warp of
//   kSubWarp lanes (the tick's groups hold at most 15 edges, so several
//   share a warp). In a batch each lane loads kEdgeLoads edges' order
//   entries and then their message values, so kSubWarp * kEdgeLoads edges
//   are in flight; the order entries of the next batch are loaded beside
//   this batch's values, so a long group (308 edges keyed by source at the
//   GAT step) costs one round trip a batch. Then every lane adds the
//   batch's values in order, taking each from its lane with __shfl_sync.
// * Wider F: lanes across features, one warp a group, each lane holding up
//   to kMaxVecsPerLane column vectors (4 values where F % 4 == 0 and the
//   rows are aligned, else 1) so that the group's edges are walked once. A
//   warp loads 32 order entries at once, then gathers U rows into
//   registers before it adds the first of them in order (U = kGatherFloats
//   / floats a lane holds of a row, at most 32, unrolled so that the loads
//   issue back to back).
//
// The constants were chosen on the card with
// `python -m repro_torch.kernels.segment_sum.sweep` (PERF.md, section 6);
// the wrapper checks them against kernel.py's through segment_sum_design.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The least traffic the function
// needs is the mask of every slot (E bytes), the destination index and
// message row of every live edge (E_live * (4 + F * itemsize)) and the
// output (num_dst * F * itemsize). The arithmetic is one add per live edge
// and feature, so the bytes bound it at every width this repo uses. As
// `_degrees` on layer 0 of the paper's batch (E = 990,000 slots, 54,221
// live, 66,000 destinations, F = 1) that is 1.7 MB, 0.50 us; chip_smoke.py
// computes it from each run's data and times the kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
// F at most this takes lanes across edges, wider F lanes across features
constexpr int kSmallFMax = 8;
// lanes-across-edges: lanes a group, and edges each lane loads a batch
constexpr int kSubWarp = 8;
constexpr int kEdgeLoads = 4;
// lanes-across-features: floats of gathered rows a lane holds before the
// adds, and column vectors a lane holds at most (a wider row takes more
// warps, one slab of 32 * kMaxVecsPerLane vectors each)
constexpr int kGatherFloats = 64;
constexpr int kMaxVecsPerLane = 8;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 4;

// VEC consecutive values of a row, loaded as one access where VEC = 4
// (16 bytes of fp32, 8 of bf16) and widened to fp32.
template <typename T, int VEC>
struct Cols;

template <>
struct Cols<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    p[0] = v[0];
  }
};
template <>
struct Cols<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Cols<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    p[0] = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct Cols<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 x;
    x.x = *reinterpret_cast<const unsigned*>(&a);
    x.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = x;
  }
};

template <typename T>
__device__ __forceinline__ float load_one(const T* p) {
  float v;
  Cols<T, 1>::load(p, &v);
  return v;
}

// Lanes across edges: sub-warp `lane / W` of each warp sums group
// `global thread / W`. Batch b of a group covers its positions
// [beg + b*W*R, beg + (b+1)*W*R); lane s of the sub-warp loads positions
// beg + b*W*R + r*W + s for r < R, and the adds run r-major, s-minor: the
// group's stable order. All lanes run the warp's largest batch count, so
// every __shfl_sync has its full mask; a lane adds nothing past its group.
template <typename T, int F, int W, int R>
__global__ void __launch_bounds__(kThreads)
    segment_sum_edges(const T* __restrict__ msg,
                      const int32_t* __restrict__ order,
                      const int32_t* __restrict__ offsets,
                      T* __restrict__ out, int64_t num_groups) {
  static_assert(32 % W == 0 && W * R <= 64, "sub-warps tile a warp");
  constexpr int B = W * R;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int s = threadIdx.x % W;
  const int64_t g = t / W;
  int32_t beg = 0, end = 0;
  if (g < num_groups) {
    beg = __ldg(offsets + g);
    end = __ldg(offsets + g + 1);
  }
  const int batches = __reduce_max_sync(kFullMask, (end - beg + B - 1) / B);
  float acc[F];
#pragma unroll
  for (int j = 0; j < F; ++j) acc[j] = 0.0f;
  // this batch's edges (-1 past the group), loaded one batch ahead
  int32_t e[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t p = beg + r * W + s;
    e[r] = p < end ? __ldg(order + p) : -1;
  }
  for (int b = 0; b < batches; ++b) {
    const int32_t base = beg + b * B;
    float v[R][F];
    int32_t next[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int j = 0; j < F; ++j) {
        v[r][j] = e[r] >= 0 ? load_one(msg + (int64_t)e[r] * F + j) : 0.0f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t p = base + B + r * W + s;
      next[r] = p < end ? __ldg(order + p) : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const bool live = base + r * W + k < end;
#pragma unroll
        for (int j = 0; j < F; ++j) {
          const float x = __shfl_sync(kFullMask, v[r][j], k, W);
          if (live) acc[j] = __fadd_rn(acc[j], x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) e[r] = next[r];
  }
  if (g < num_groups) {
#pragma unroll
    for (int j = 0; j < F; ++j) {
      if (j % W == s) Cols<T, 1>::store(out + g * F + j, &acc[j]);
    }
  }
}

// Lanes across features: warp `blockIdx.x * kWarpsPerBlock + warp` sums
// group g over slab blockIdx.y of its row, NV column vectors of VEC values
// a lane. The warp loads 32 order entries at once, then gathers U rows of
// them before it adds the first, and adds in order.
template <typename T, int VEC, int NV, int U>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    segment_sum_rows(const T* __restrict__ msg,
                     const int32_t* __restrict__ order,
                     const int32_t* __restrict__ offsets,
                     T* __restrict__ out, int64_t num_groups, int cols) {
  // g is the same for all 32 lanes, so a warp leaves (or stays) as a whole
  // and every __shfl_sync below has its full mask
  const int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= num_groups) return;
  const int32_t beg = __ldg(offsets + g);
  const int32_t end = __ldg(offsets + g + 1);
  const int64_t F = (int64_t)cols * VEC;
  int col[NV];
  bool on[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    col[j] = ((int)blockIdx.y * NV + j) * 32 + lane;
    on[j] = col[j] < cols;
  }
  float acc[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[j][c] = 0.0f;
  }
  for (int32_t base = beg; base < end; base += 32) {
    const int n = min(32, end - base);
    const int32_t mine = lane < n ? __ldg(order + base + lane) : 0;
    for (int k0 = 0; k0 < n; k0 += U) {
      float x[U][NV][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int32_t e = __shfl_sync(kFullMask, mine, min(k0 + u, n - 1));
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (k0 + u < n && on[j]) {
            Cols<T, VEC>::load(msg + e * F + (int64_t)col[j] * VEC, x[u][j]);
          } else {
#pragma unroll
            for (int c = 0; c < VEC; ++c) x[u][j][c] = 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u < n) {
#pragma unroll
          for (int j = 0; j < NV; ++j) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              acc[j][c] = __fadd_rn(acc[j][c], x[u][j][c]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (on[j]) {
      Cols<T, VEC>::store(out + g * F + (int64_t)col[j] * VEC, acc[j]);
    }
  }
}

// Gathered rows in flight for NV column vectors of VEC values a lane.
template <int GF, int VEC, int NV>
constexpr int rows_in_flight() {
  return GF / (NV * VEC) < 1    ? 1
         : GF / (NV * VEC) > 32 ? 32
                                : GF / (NV * VEC);
}

template <typename T, int W, int R, int F>
int launch_edges(const T* msg, const int32_t* order, const int32_t* offsets,
                 T* out, int64_t num_groups, cudaStream_t stream) {
  const int64_t blocks = (num_groups * W + kThreads - 1) / kThreads;
  segment_sum_edges<T, F, W, R><<<(unsigned)blocks, kThreads, 0, stream>>>(
      msg, order, offsets, out, num_groups);
  return (int)cudaGetLastError();
}

template <typename T, int GF, int MAX_NV, int VEC, int NV>
int launch_rows_nv(const T* msg, const int32_t* order, const int32_t* offsets,
                   T* out, int64_t num_groups, int cols,
                   cudaStream_t stream) {
  const int64_t blocks = (num_groups + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int64_t slabs = (cols + 32 * NV - 1) / (32 * NV);
  segment_sum_rows<T, VEC, NV, rows_in_flight<GF, VEC, NV>()>
      <<<dim3((unsigned)blocks, (unsigned)slabs), 32 * kWarpsPerBlock, 0,
         stream>>>(msg, order, offsets, out, num_groups, cols);
  return (int)cudaGetLastError();
}

// Column vectors a lane: as many as the row needs (1, 2, 4 or 8), at most
// MAX_NV; a wider row takes more slabs.
template <typename T, int GF, int MAX_NV, int VEC>
int launch_rows(const T* msg, const int32_t* order, const int32_t* offsets,
                T* out, int64_t num_groups, int cols, cudaStream_t stream) {
  const int need = (cols + 31) / 32;
  if (MAX_NV <= 1 || need <= 1) {
    return launch_rows_nv<T, GF, MAX_NV, VEC, 1>(msg, order, offsets, out,
                                                 num_groups, cols, stream);
  }
  if (MAX_NV <= 2 || need <= 2) {
    return launch_rows_nv<T, GF, MAX_NV, VEC, 2>(msg, order, offsets, out,
                                                 num_groups, cols, stream);
  }
  if (MAX_NV <= 4 || need <= 4) {
    return launch_rows_nv<T, GF, MAX_NV, VEC, 4>(msg, order, offsets, out,
                                                 num_groups, cols, stream);
  }
  return launch_rows_nv<T, GF, MAX_NV, VEC, 8>(msg, order, offsets, out,
                                               num_groups, cols, stream);
}

// The call as the C entry points take it, for one choice of the design
// constants (sub-warp width, edges a lane loads a batch, gathered floats a
// lane, column vectors a lane at most). The switch between the schedules is
// F <= kSmallFMax; 4-value columns where F % 4 == 0 and msg and out start
// on a 4-value boundary (16 bytes of fp32, 8 of bf16).
template <typename T, int W, int R, int GF, int MAX_NV>
int segment_sum(const void* msg_, const void* order_, const void* offsets_,
                void* out_, long long num_groups, long long F, void* stream_) {
  if (num_groups <= 0 || F <= 0) return (int)cudaGetLastError();
  const T* msg = (const T*)msg_;
  const int32_t* order = (const int32_t*)order_;
  const int32_t* offsets = (const int32_t*)offsets_;
  T* out = (T*)out_;
  const cudaStream_t s = (cudaStream_t)stream_;
  switch (F <= kSmallFMax ? F : 0) {
#define K2_EDGES(n) \
  case n:           \
    return launch_edges<T, W, R, n>(msg, order, offsets, out, num_groups, s);
    K2_EDGES(1) K2_EDGES(2) K2_EDGES(3) K2_EDGES(4)
    K2_EDGES(5) K2_EDGES(6) K2_EDGES(7) K2_EDGES(8)
#undef K2_EDGES
    default:
      break;
  }
  constexpr uintptr_t vec_bytes = 4 * sizeof(T);
  const bool vec4 = F % 4 == 0 && (uintptr_t)msg % vec_bytes == 0 &&
                    (uintptr_t)out % vec_bytes == 0;
  if (vec4) {
    return launch_rows<T, GF, MAX_NV, 4>(msg, order, offsets, out, num_groups,
                                         (int)(F / 4), s);
  }
  return launch_rows<T, GF, MAX_NV, 1>(msg, order, offsets, out, num_groups,
                                       (int)F, s);
}

}  // namespace

// The design constants, by which the wrapper checks that kernel.py mirrors
// this library: 0 kSmallFMax, 1 kSubWarp, 2 kEdgeLoads, 3 kGatherFloats,
// 4 kMaxVecsPerLane; -1 for any other index.
extern "C" int segment_sum_design(int i) {
  const int c[] = {kSmallFMax, kSubWarp, kEdgeLoads, kGatherFloats,
                   kMaxVecsPerLane};
  return i >= 0 && i < 5 ? c[i] : -1;
}

extern "C" int segment_sum_f32(const void* msg, const void* order,
                               const void* offsets, void* out,
                               long long num_dst, long long F, void* stream) {
  return segment_sum<float, kSubWarp, kEdgeLoads, kGatherFloats,
                     kMaxVecsPerLane>(msg, order, offsets, out, num_dst, F,
                                      stream);
}

extern "C" int segment_sum_bf16(const void* msg, const void* order,
                                const void* offsets, void* out,
                                long long num_dst, long long F,
                                void* stream) {
  return segment_sum<__nv_bfloat16, kSubWarp, kEdgeLoads, kGatherFloats,
                     kMaxVecsPerLane>(msg, order, offsets, out, num_dst, F,
                                      stream);
}
