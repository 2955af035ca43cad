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
// Exactness. The statistics are FlashAttention's one-pass online max and
// denominator, walked in each group's stable order:
//   if (s > m) { z = z * exp(m - s) + 1; m = s; } else z += exp(s - m);
// with `z * exp(m - s) + 1` one fused multiply-add (as nvcc contracts it),
// spelled with rounding intrinsics so that no instantiation fuses it
// otherwise. No float atomics: two runs give the same bytes. Only the
// loads may move; every step keeps its arithmetic and its order.
//
// Bound on an H100 SXM (3.35 TB/s): memory, and at this repo's sizes the
// latency of a launch and of its chain of dependent loads. Statistics read
// offsets, the order entry and H scores of every live edge, and write
// 2 * num_dst * H floats; normalize reads every slot's mask, the
// destination, H scores and the statistics of every live slot, and writes
// E * H floats. A few hundred kilobytes to a few megabytes at the paper's
// batch, a microsecond or two of bandwidth. Design:
//
// * Statistics, short route: one thread a destination and HT heads (all of
//   them where H = 2; a row of H = 2 scores is one float2 where aligned).
//   The thread loads offsets[d] and offsets[d + 1] together, then up to U
//   (kStatsEdges) order entries at once, then their U x HT scores, and only
//   then runs the chain over the registers: three round trips for a group
//   of up to U edges, where the one-edge-a-round-trip walk took one or two
//   an edge. An empty destination costs its offsets and its store. The
//   kernel is held to 64 registers; U = 8 fits without spilling (U = 16
//   spilled and was slower on every main-path layer, though groups of 9-15
//   edges then take two batches).
// * Statistics, warp route: a group of more than kWarpFrom edges is left by
//   its thread to the whole warp, after the short groups. 32 lanes load 32
//   edges' order entries and scores at once, kRing batches' loads in
//   flight behind this batch's arithmetic. The running max before each
//   edge is a prefix scan of the lanes' scores under "leftmost maximum"
//   (a later score replaces an earlier only when strictly greater: the
//   chain's own rule, associative, so the scan gives the chain's m bit for
//   bit), taken only in a batch where some score exceeds the running max
//   (in any other the running max is every edge's; in a long group in no
//   particular order new maxima are rare), each lane then computes its
//   edge's exponential, and the
//   denominator's chain of fused multiply-adds and adds runs over the
//   shuffled exponentials in the stable order. The chain is then adds, not
//   exponentials and loads.
// * Normalize: one thread a run of kNormSlots consecutive slots and HT
//   heads: the run's mask as one 4-byte load, its destinations as one int4
//   and the scores and the stores as float4 where the pointers allow,
//   scalar accesses otherwise and for the tail. The statistics are
//   gathered only for live slots (a padded slot's destination is never an
//   index: the op does not promise it is in range), and the scores are
//   loaded with them, only for runs holding a live slot (loading them with
//   the mask read every padded slot's scores and was slower where most
//   slots are padded). Two round trips for a live slot, one for a padded
//   run.
// The constants were chosen on the card with
// `python -m repro_torch.kernels.edge_softmax.sweep` (PERF.md, section 6);
// the wrappers check them against kernel.py's through edge_softmax_design.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// threads a block, and the statistics' register cap (64 a thread: enough
// resident blocks for 1,024 threads an SM)
constexpr int kThreads = 256;
constexpr int kStatsMinBlocks = 65536 / (64 * kThreads);
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// statistics: live edges a thread loads before its chain (U), and the
// group length above which the group takes the warp route
constexpr int kStatsEdges = 8;
constexpr int kWarpFrom = 64;
// the warp route's batches in flight (its ring)
constexpr int kRing = 4;
// normalize: consecutive slots a thread takes
constexpr int kNormSlots = 4;
static_assert(kNormSlots == 4, "a run's mask is one 4-byte load");

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fffffff);
}

// One step of the online max and denominator, in the parent's arithmetic.
__device__ __forceinline__ void online_step(float s, float& m, float& z) {
  const bool up = s > m;
  const float e = expf(up ? m - s : s - m);
  z = up ? __fmaf_rn(z, e, 1.0f) : __fadd_rn(z, e);
  m = up ? s : m;
}

// The chain's max rule as an associative operator on (earlier a, later b):
// b replaces a when strictly greater, or when a is a NaN, which stands for
// "no edge" (lanes past a group's end) and which the chain never takes.
__device__ __forceinline__ float first_max(float a, float b) {
  return (b > a || a != a) ? b : a;
}

// HT heads h0.. of edge e's scores; one float2 where VEC (HT == 2).
template <int HT, bool VEC>
__device__ __forceinline__ void load_heads(const float* __restrict__ scores,
                                           int32_t e, int H, int h0,
                                           float (&s)[HT]) {
  const float* p = scores + (int64_t)e * H + h0;
  if constexpr (VEC) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    s[0] = v.x;
    s[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < HT; ++j) s[j] = __ldg(p + j);
  }
}

// Short route: the group [beg, end) in batches of U edges, each batch's
// order entries, then scores, loaded before its chain.
template <int HT, bool VEC, int U>
__device__ __forceinline__ void stats_thread(const float* __restrict__ scores,
                                             const int32_t* __restrict__ order,
                                             int32_t beg, int32_t end, int H,
                                             int h0, float (&m)[HT],
                                             float (&z)[HT]) {
  for (int32_t base = beg; base < end; base += U) {
    const int cnt = end - base < U ? end - base : U;
    int32_t idx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) idx[u] = u < cnt ? __ldg(order + base + u) : 0;
    float s[U][HT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < cnt) load_heads<HT, VEC>(scores, idx[u], H, h0, s[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < cnt) {
#pragma unroll
        for (int j = 0; j < HT; ++j) online_step(s[u][j], m[j], z[j]);
      }
    }
  }
}

template <int HT, bool VEC>
__device__ __forceinline__ void load_or_nan(const float* __restrict__ scores,
                                            int32_t e, int H, int h0,
                                            float (&s)[HT]) {
  if (e >= 0) {
    load_heads<HT, VEC>(scores, e, H, h0, s);
  } else {
#pragma unroll
    for (int j = 0; j < HT; ++j) s[j] = quiet_nan();
  }
}

// One batch of the warp route: 32 edges' scores of one head each lane
// (NaN past the group's end), folded into the group's m and z in order. A
// batch wholly past the end leaves m and z as they are.
template <int HT>
__device__ __forceinline__ void warp_batch(const float (&s)[HT], int cnt,
                                           int lane, float (&m)[HT],
                                           float (&z)[HT]) {
  float v[HT];
#pragma unroll
  for (int j = 0; j < HT; ++j) {
    float before = m[j];  // the max before this lane's edge
    if (__any_sync(kFull, s[j] > m[j])) {
      float x = s[j];  // inclusive scan: the max up to this lane's edge
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x = first_max(y, x);
      }
      const float prev = __shfl_up_sync(kFull, x, 1);
      if (lane > 0) before = first_max(m[j], prev);
      m[j] = first_max(m[j], __shfl_sync(kFull, x, 31));
    }
    const bool up = s[j] > before;
    const float e = expf(up ? before - s[j] : s[j] - before);
    // exp's result is >= 0 (or a NaN, for which either update gives the
    // same NaN), so its sign bit can carry `up`; a lane past the end adds
    // +0, which leaves z's bits as they are
    v[j] = lane >= cnt ? 0.0f : up ? -e : e;
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      const float w = __shfl_sync(kFull, v[j], k);
      const float e = fabsf(w);
      z[j] = __float_as_int(w) < 0 ? __fmaf_rn(z[j], e, 1.0f)
                                   : __fadd_rn(z[j], e);
    }
  }
}

// Warp route: the group [beg, end) (warp-uniform) by the whole warp, 32
// edges a batch, every lane ending with the group's m and z. A ring of
// RING batches hides the memory's latency behind the arithmetic: a batch's
// scores are loaded RING batches before its turn, its order entries RING
// batches before that.
template <int HT, bool VEC, int RING>
__device__ __forceinline__ void stats_warp(const float* __restrict__ scores,
                                           const int32_t* __restrict__ order,
                                           int32_t beg, int32_t end, int H,
                                           int h0, int lane, float (&m)[HT],
                                           float (&z)[HT]) {
  int32_t idx[RING];
  float s[RING][HT];
#pragma unroll
  for (int r = 0; r < RING; ++r) {
    const int32_t i = beg + 32 * r + lane;
    idx[r] = i < end ? __ldg(order + i) : -1;
  }
#pragma unroll
  for (int r = 0; r < RING; ++r) {
    load_or_nan<HT, VEC>(scores, idx[r], H, h0, s[r]);
    const int32_t i = beg + 32 * (RING + r) + lane;
    idx[r] = i < end ? __ldg(order + i) : -1;
  }
  for (int32_t base = beg; base < end; base += 32 * RING) {
#pragma unroll
    for (int r = 0; r < RING; ++r) {
      const int32_t b = base + 32 * r;
      float cur[HT];
#pragma unroll
      for (int j = 0; j < HT; ++j) cur[j] = s[r][j];
      load_or_nan<HT, VEC>(scores, idx[r], H, h0, s[r]);
      const int32_t i = b + 64 * RING + lane;
      idx[r] = i < end ? __ldg(order + i) : -1;
      warp_batch<HT>(cur, end - b < 32 ? end - b : 32, lane, m, z);
    }
  }
}

// One thread a (destination, HT heads); blocks of kThreads (whole warps:
// the warp route needs every lane, so no thread returns before it).
template <int HT, bool VEC, int U, int WARP_FROM, int RING>
__global__ void __launch_bounds__(kThreads, kStatsMinBlocks)
edge_softmax_stats_kernel(const float* __restrict__ scores,
                          const int32_t* __restrict__ order,
                          const int32_t* __restrict__ offsets,
                          float* __restrict__ m_out, float* __restrict__ z_out,
                          int64_t num_dst, int H) {
  const int chunks = H / HT;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool active = t < num_dst * chunks;
  int64_t d = 0;
  int h0 = 0;
  int32_t beg = 0, end = 0;
  if (active) {
    d = t / chunks;
    h0 = (int)(t - d * chunks) * HT;
    beg = __ldg(offsets + d);
    end = __ldg(offsets + d + 1);
  }
  float m[HT], z[HT];
#pragma unroll
  for (int j = 0; j < HT; ++j) {
    m[j] = kNeg;
    z[j] = 0.0f;
  }
  const bool along = end - beg > WARP_FROM;
  if (!along) stats_thread<HT, VEC, U>(scores, order, beg, end, H, h0, m, z);
  for (unsigned pending = __ballot_sync(kFull, along); pending;
       pending &= pending - 1) {
    const int owner = __ffs(pending) - 1;
    float wm[HT], wz[HT];
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      wm[j] = kNeg;
      wz[j] = 0.0f;
    }
    stats_warp<HT, VEC, RING>(scores, order, __shfl_sync(kFull, beg, owner),
                              __shfl_sync(kFull, end, owner), H,
                              __shfl_sync(kFull, h0, owner), lane, wm, wz);
    if (lane == owner) {
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        m[j] = wm[j];
        z[j] = wz[j];
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < HT; ++j) {
    if (m[j] <= kNeg / 2) {  // no live edge (the reference's empty-dst rule)
      m[j] = 0.0f;
      z[j] = 0.0f;
    }
  }
  const int64_t k = d * H + h0;
  if constexpr (VEC) {
    *reinterpret_cast<float2*>(m_out + k) = make_float2(m[0], m[1]);
    *reinterpret_cast<float2*>(z_out + k) = make_float2(z[0], z[1]);
  } else {
#pragma unroll
    for (int j = 0; j < HT; ++j) {
      m_out[k + j] = m[j];
      z_out[k + j] = z[j];
    }
  }
}

// The kNormSlots x HT values of a run, flat (slot r, head j) at r * HT + j:
// float4 q holds flat values 4q..4q+3. With every head in the run
// (HT == H) the run's values are contiguous; with HT == 4 < H each slot's
// slice is one float4.
template <int HT>
__device__ __forceinline__ int64_t vec_offset(int64_t e0, int H, int h0,
                                              int q) {
  return HT == H ? e0 * H + 4 * q : (e0 + q) * H + h0;
}

// whether float4 q of a run holds a live slot's values
template <int HT>
__device__ __forceinline__ bool vec_live(const bool (&live)[kNormSlots],
                                         int q) {
  bool any = false;
#pragma unroll
  for (int r = 0; r < kNormSlots; ++r) {
    any |= live[r] && r * HT < 4 * q + 4 && r * HT + HT > 4 * q;
  }
  return any;
}

// the run's scores, for its live slots (a float4 holding one)
template <int HT, bool VEC>
__device__ __forceinline__ void load_run_scores(
    const float* __restrict__ scores, int64_t e0, int n, int H, int h0,
    bool vec, const bool (&live)[kNormSlots], float (&s)[kNormSlots * HT]) {
  if (VEC && vec) {
#pragma unroll
    for (int q = 0; q < HT; ++q) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (vec_live<HT>(live, q)) {
        v = __ldg(reinterpret_cast<const float4*>(
            scores + vec_offset<HT>(e0, H, h0, q)));
      }
      s[4 * q] = v.x;
      s[4 * q + 1] = v.y;
      s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kNormSlots; ++r) {
#pragma unroll
      for (int j = 0; j < HT; ++j) {
        s[r * HT + j] = r < n && live[r]
                            ? __ldg(scores + (e0 + r) * H + h0 + j)
                            : 0.0f;
      }
    }
  }
}

// m or z of HT heads h0.. of destination dst (one float2 / float4 where VEC)
template <int HT, bool VEC>
__device__ __forceinline__ void load_stats(const float* __restrict__ p,
                                           int32_t dst, int H, int h0,
                                           float* out) {
  const float* q = p + (int64_t)dst * H + h0;
  if constexpr (VEC && HT == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(q));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (VEC && HT == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(q));
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int j = 0; j < HT; ++j) out[j] = __ldg(q + j);
  }
}

// One thread a run of kNormSlots consecutive slots and HT heads.
template <int HT, bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_softmax_norm_kernel(const float* __restrict__ scores,
                         const int32_t* __restrict__ edge_dst,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ m,
                         const float* __restrict__ z,
                         float* __restrict__ alpha, int64_t E, int H) {
  const int chunks = H / HT;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t runs = (E + kNormSlots - 1) / kNormSlots;
  if (t >= runs * chunks) return;
  const int64_t run = t / chunks;
  const int h0 = (int)(t - run * chunks) * HT;
  const int64_t e0 = run * kNormSlots;
  const int n = E - e0 < kNormSlots ? (int)(E - e0) : kNormSlots;
  const bool vec = VEC && n == kNormSlots;  // the tail is scalar
  bool live[kNormSlots];
  int32_t dst[kNormSlots];
  if (vec) {
    const unsigned bits = __ldg(reinterpret_cast<const unsigned*>(mask + e0));
    const int4 dd = __ldg(reinterpret_cast<const int4*>(edge_dst + e0));
    dst[0] = dd.x;
    dst[1] = dd.y;
    dst[2] = dd.z;
    dst[3] = dd.w;
#pragma unroll
    for (int r = 0; r < kNormSlots; ++r) live[r] = (bits >> (8 * r)) & 0xffu;
  } else {
#pragma unroll
    for (int r = 0; r < kNormSlots; ++r) {
      live[r] = r < n && __ldg(mask + e0 + r);
      dst[r] = r < n ? __ldg(edge_dst + e0 + r) : 0;
    }
  }
  float a[kNormSlots * HT];
#pragma unroll
  for (int f = 0; f < kNormSlots * HT; ++f) a[f] = 0.0f;
  bool any = false;
#pragma unroll
  for (int r = 0; r < kNormSlots; ++r) any |= live[r];
  if (any) {
    float s[kNormSlots * HT], ms[kNormSlots * HT], zs[kNormSlots * HT];
#pragma unroll
    for (int r = 0; r < kNormSlots; ++r) {
      if (live[r]) {
        load_stats<HT, VEC>(m, dst[r], H, h0, ms + r * HT);
        load_stats<HT, VEC>(z, dst[r], H, h0, zs + r * HT);
      }
    }
    load_run_scores<HT, VEC>(scores, e0, n, H, h0, vec, live, s);
#pragma unroll
    for (int r = 0; r < kNormSlots; ++r) {
      if (live[r]) {
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          const int f = r * HT + j;
          a[f] = expf(s[f] - ms[f]) / fmaxf(zs[f], 1e-30f);
        }
      }
    }
  }
  if (vec) {
#pragma unroll
    for (int q = 0; q < HT; ++q) {
      *reinterpret_cast<float4*>(alpha + vec_offset<HT>(e0, H, h0, q)) =
          make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kNormSlots; ++r) {
      if (r < n) {
#pragma unroll
        for (int j = 0; j < HT; ++j) {
          alpha[(e0 + r) * H + h0 + j] = a[r * HT + j];
        }
      }
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (uintptr_t)p % bytes == 0;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// The statistics' launch for one choice of the design constants: HT = 2
// heads a thread where H is even (one float2 a row where the scores, m and
// z are 8-byte aligned), else 1.
template <int U, int WARP_FROM, int RING>
int stats(const void* scores, const void* order, const void* offsets,
          void* m, void* z, long long num_dst, int H, void* stream) {
  if (num_dst > 0 && H > 0) {
    const int ht = H % 2 == 0 ? 2 : 1;
    const int64_t threads = (int64_t)num_dst * (H / ht);
    const bool vec = ht == 2 && aligned(scores, 8) && aligned(m, 8) &&
                     aligned(z, 8);
    const auto* s = (const float*)scores;
    const auto* o = (const int32_t*)order;
    const auto* off = (const int32_t*)offsets;
    auto* mo = (float*)m;
    auto* zo = (float*)z;
    cudaStream_t st = (cudaStream_t)stream;
    if (ht == 1) {
      edge_softmax_stats_kernel<1, false, U, WARP_FROM, RING>
          <<<blocks_for(threads), kThreads, 0, st>>>(s, o, off, mo, zo,
                                                     num_dst, H);
    } else if (vec) {
      edge_softmax_stats_kernel<2, true, U, WARP_FROM, RING>
          <<<blocks_for(threads), kThreads, 0, st>>>(s, o, off, mo, zo,
                                                     num_dst, H);
    } else {
      edge_softmax_stats_kernel<2, false, U, WARP_FROM, RING>
          <<<blocks_for(threads), kThreads, 0, st>>>(s, o, off, mo, zo,
                                                     num_dst, H);
    }
  }
  return (int)cudaGetLastError();
}

template <int HT>
void launch_norm(bool vec, int64_t threads, const float* s, const int32_t* d,
                 const uint8_t* mk, const float* m, const float* z, float* a,
                 int64_t E, int H, cudaStream_t st) {
  if (vec) {
    edge_softmax_norm_kernel<HT, true>
        <<<blocks_for(threads), kThreads, 0, st>>>(s, d, mk, m, z, a, E, H);
  } else {
    edge_softmax_norm_kernel<HT, false>
        <<<blocks_for(threads), kThreads, 0, st>>>(s, d, mk, m, z, a, E, H);
  }
}

// The normalize's launch: HT = 4 heads a thread where H % 4 == 0, 2 where
// H is even, else 1; vector accesses where the run's values are float4s
// (HT == H or HT == 4) and the pointers are aligned (the mask to 4 bytes,
// the rest to 16).
int norm(const void* scores, const void* edge_dst, const void* mask,
         const void* m, const void* z, void* alpha, long long E, int H,
         void* stream) {
  if (E > 0 && H > 0) {
    const int ht = H % 4 == 0 ? 4 : H % 2 == 0 ? 2 : 1;
    const int64_t runs = ((int64_t)E + kNormSlots - 1) / kNormSlots;
    const int64_t threads = runs * (H / ht);
    const bool vec = (ht == H || ht == 4) && aligned(mask, 4) &&
                     aligned(edge_dst, 16) && aligned(scores, 16) &&
                     aligned(m, 16) && aligned(z, 16) && aligned(alpha, 16);
    const auto* s = (const float*)scores;
    const auto* d = (const int32_t*)edge_dst;
    const auto* mk = (const uint8_t*)mask;
    const auto* mm = (const float*)m;
    const auto* zz = (const float*)z;
    auto* a = (float*)alpha;
    cudaStream_t st = (cudaStream_t)stream;
    if (ht == 4) {
      launch_norm<4>(vec, threads, s, d, mk, mm, zz, a, E, H, st);
    } else if (ht == 2) {
      launch_norm<2>(vec, threads, s, d, mk, mm, zz, a, E, H, st);
    } else {
      launch_norm<1>(vec, threads, s, d, mk, mm, zz, a, E, H, st);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The design constants, by which the wrappers check that kernel.py mirrors
// this library: 0 kStatsEdges, 1 kWarpFrom, 2 kRing, 3 kNormSlots; -1 for
// any other index.
extern "C" int edge_softmax_design(int i) {
  const int c[] = {kStatsEdges, kWarpFrom, kRing, kNormSlots};
  return i >= 0 && i < 4 ? c[i] : -1;
}

extern "C" int edge_softmax_stats_f32(const void* scores, const void* order,
                                      const void* offsets, void* m, void* z,
                                      long long num_dst, int H,
                                      void* stream) {
  return stats<kStatsEdges, kWarpFrom, kRing>(scores, order, offsets, m, z,
                                              num_dst, H, stream);
}

extern "C" int edge_softmax_norm_f32(const void* scores, const void* edge_dst,
                                     const void* mask, const void* m,
                                     const void* z, void* alpha, long long E,
                                     int H, void* stream) {
  return norm(scores, edge_dst, mask, m, z, alpha, E, H, stream);
}
