// Source-keyed weighted gather-sum, hand-written for Hopper (sm_90a): the
// backward kernel of K1 and of K3's projected-feature input.
//
// The TPU kernels it differentiates, `fused_gather_aggregate_pallas`
// (src/repro/kernels/fused_gather_aggregate/kernel.py:58) and
// `fused_edge_softmax_aggregate_pallas`
// (src/repro/kernels/fused_edge_softmax_aggregate/kernel.py:63), had no
// backward of their own: the reference differentiates their plain versions
// with jax.value_and_grad, whose scatter-adds into source rows a GPU would
// run with float atomics. Here:
//
//   out[v, c] = sum_{i in [offsets[v], offsets[v+1])}
//                   w(e_i, c) * G[row_idx[e_i], c],      e_i = order[i]
//
// with `order` / `offsets` / `keys` the source-grouped edge order (a stable
// sort of the masked `edge_src` keys, repro_torch/kernels/dst_groups.py;
// keys[i] is the source row of position i), row_idx = edge_dst, and w = 1
// (K1's backward) or w(e, c) = alpha[e, c / Dh] (K3's backward into
// h_proj). Rows no live edge reads get zeros.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The least traffic is the mask
// of every slot, both indices of every live edge (8 bytes), the weights of
// live edges (E_live * H * 4), each gradient row a live edge reads once and
// the whole output (V * F * 4, zeros included). At K3's layer 0 of the
// paper's GAT batch the output alone is 1,056,000 x 256 x 4 bytes (0.32 ms).
//
// What set the pace was skew, not bytes. Live edges per source row in the
// paper batch (product-sim scale 14, batch 1000, fanouts 15/10/5, seed 0):
//
//   layer  rows (padded)  rows with an edge  live edges  largest degree
//   0      1,056,000      6,927              54,221      805
//   1      66,000         4,272              15,970      227
//   2      6,000          1,345              2,507       59
//
// A destination has at most 15 edges; a source row as many as the
// power-law graph gives it. One warp a source row, walking the row's edges
// one gather after another, lets the hottest row set the pace (2 x 805
// dependent gathers at layer 0) and spends a warp on every empty row.
//
// Design: the nnz-split of Merrill and Garland's merge-based CSR SpMV
// (SC'16), with every sum kept in the plain version's order.
//
// 1. Split over edges, not rows. The live positions order[0:offsets[V]]
//    are cut into chunks of C = kChunk <= 32 consecutive positions, one
//    warp a chunk (and a warp a slab of 32 * NV column vectors where a row
//    is wider than that). A chunk spans any number of rows; no warp
//    gathers more than C edges, whatever a row's degree. A warp takes its
//    chunk from a ticket counter, so it only ever waits on chunks whose
//    warps have started: no order of block dispatch can deadlock.
// 2. Carries chained in chunk order. A row inside one chunk is summed from
//    0 and stored. A row that crosses chunk boundaries is summed in the
//    chunk holding its first position, then chunk by chunk onward from the
//    running sum the previous chunk left in its carry row. The carry rows
//    hold an unset mark (the NaN 0xffffffff, which no float addition
//    returns: NaN sums are the canonical 0x7fffffff) until a chunk stores
//    its running sum; the next chunk's lanes poll their own columns past
//    the L1 until none is unset, take them and set them back to unset. So
//    one store and one poll make a hop, with no fence and no flag, and the
//    scratch is clean again after every launch (the last ticket resets the
//    counter). A warp sums and stores the segments after its first before
//    it waits for its own carry-in, so a chain of waits only ever follows
//    one row.
//    Every row's terms are added one at a time in position order, each
//    product rounded before it is added (__fmul_rn, __fadd_rn): the plain
//    version's order and rounding, so the result is bitwise that of
//    src_scatter_ref under deterministic algorithms, and two launches give
//    the same bytes. The other choice, chunk partial sums added up in a
//    second pass, reassociates: on rows of hundreds of unit-scale terms
//    another order strays from the plain version by more than the 1e-5
//    the port holds every kernel to where a column's sum nearly cancels
//    (5.3e-5 at K1's backward, paper layer 0; PERF.md, section 6).
// 3. All of a row's columns in one pass: each lane keeps NV column vectors
//    (float4 where F, Dh and the alignment allow, else float) in
//    registers, so an edge's index and weight are read once.
// 4. Gathers in flight: a warp loads U = kBatch edges' rows (and weights)
//    into registers before it adds any of them, and issues the first batch
//    of a carried row before it waits for the carry. With U = C all of a
//    chunk's gathers are in flight before the wait, so a hop costs two L2
//    round trips (about 2 us on an H100), not the 4-8 us of gathering
//    after the carry arrives. The constants were chosen on the card with
//    sweep.py (PERF.md, section 6).
// 5. Rows with no live edge get their zeros from the same launch: two
//    blocks an SM, first in the grid, read the offsets of 32 rows at once,
//    coalesced, and store the zero vectors of the empty ones (16 bytes a
//    lane where float4 columns are taken), while the chunks run.
//
// Nothing is added atomically but the integer ticket. The grid is sized
// from the E slots and from V; offsets[V] is read on the device, so the
// wrapper launches on the current stream without a host sync. A carry wait
// that never ends (a broken invariant) traps after seconds instead of
// hanging the card.
#include <algorithm>

#include "vec.cuh"

namespace {

using repro_torch::kFullMask;
using repro_torch::Vec;

// live positions per chunk (at most 32: one position a lane), edges
// gathered before they are added, and column vectors a lane holds at most
// (a wider row takes more warps): chosen with sweep.py (PERF.md, section 6).
// With kBatch = kChunk a chunk's gathers are all in flight before it waits
// for its carry.
constexpr int kChunk = 32;
constexpr int kBatch = 32;
constexpr int kMaxVecsPerLane = 1;
constexpr int kWarps = 4;
// blocks that write the zeros of empty rows, for each SM
constexpr int kZeroBlocksPerSm = 2;
constexpr long long kMaxSpins = 1LL << 24;
// the mark of a carry column not stored yet
constexpr unsigned kUnset = 0xffffffffu;

// One call's tensors and sizes. cols = F / VEC column vectors a row. The
// scratch is clean before and after a launch: carry (num_chunks x F
// floats) all unset, tickets (one counter a column slab) all 0.
struct Args {
  const float* grad;
  const int32_t* row_idx;
  const float* weights;
  const int32_t* order;
  const int32_t* keys;
  const int32_t* offsets;
  float* out;
  float* carry;
  int32_t* tickets;
  int64_t num_rows, num_chunks, cols;
  int H;
  int64_t Dh;
};

__device__ __forceinline__ bool unset(float x) {
  return __float_as_uint(x) == kUnset;
}
__device__ __forceinline__ bool unset(float4 x) {
  return unset(x.x) || unset(x.y) || unset(x.z) || unset(x.w);
}
template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::type unset_vec() {
  const float u = __uint_as_float(kUnset);
  if constexpr (VEC == 4) {
    return make_float4(u, u, u, u);
  } else {
    return u;
  }
}

// acc + w * g with the product rounded first, as the plain version rounds
// it (no fused multiply-add)
__device__ __forceinline__ void add_term(float& acc, float w, float g) {
  acc = __fadd_rn(acc, __fmul_rn(w, g));
}
__device__ __forceinline__ void add_term(float4& acc, float w, float4 g) {
  add_term(acc.x, w, g.x);
  add_term(acc.y, w, g.y);
  add_term(acc.z, w, g.z);
  add_term(acc.w, w, g.w);
}

// The zeros of rows with no live edge: a warp reads the offsets of 32 rows
// at once and stores the empty rows' vectors, row by row.
template <int VEC>
__device__ void zero_empty_rows(const Args& a, int64_t warp, int64_t warps) {
  using V = typename Vec<VEC>::type;
  const int lane = threadIdx.x & 31;
  V* out_v = reinterpret_cast<V*>(a.out);
  for (int64_t r0 = warp * 32; r0 < a.num_rows; r0 += warps * 32) {
    const int64_t r = r0 + lane;
    const bool empty =
        r < a.num_rows && __ldg(a.offsets + r) == __ldg(a.offsets + r + 1);
    for (unsigned m = __ballot_sync(kFullMask, empty); m; m &= m - 1) {
      V* row = out_v + (r0 + __ffs(m) - 1) * a.cols;
      for (int64_t c = lane; c < a.cols; c += 32) row[c] = Vec<VEC>::zero();
    }
  }
}

// Blocks [0, zero_blocks), at blockIdx.y == 0, write the zeros of empty
// rows; they come first, so that chunks waiting for their carries never
// hold the SMs they need. The blocks after them hold one warp a chunk of C
// live positions (blockIdx.y picks the warp's slab of 32 * NV column
// vectors).
template <int C, int U, int VEC, int NV, bool WEIGHTED>
__global__ void __launch_bounds__(32 * kWarps)
    src_scatter_kernel(const Args a, int64_t zero_blocks) {
  static_assert(C <= 32, "one position a lane");
  using V = typename Vec<VEC>::type;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (blockIdx.x < zero_blocks) {
    if (blockIdx.y == 0) {
      zero_empty_rows<VEC>(a, blockIdx.x * kWarps + warp,
                           zero_blocks * kWarps);
    }
    return;
  }
  const int64_t slot = (blockIdx.x - zero_blocks) * kWarps + warp;
  const int32_t n_live = __ldg(a.offsets + a.num_rows);
  // the condition is the same for all 32 lanes, so a warp leaves (or
  // stays) as a whole and every __shfl_sync below has its full mask
  if (slot * C >= n_live) return;
  int ticket = 0;
  if (lane == 0) {
    int32_t* counter = a.tickets + blockIdx.y;
    ticket = atomicAdd(counter, 1);
    if (ticket == (n_live + C - 1) / C - 1) atomicExch(counter, 0);
  }
  const int64_t chunk = __shfl_sync(kFullMask, ticket, 0);
  const int64_t p0 = chunk * C;
  const int n = n_live - p0 < C ? (int)(n_live - p0) : C;

  // position p0 + lane: its edge, the gradient row it reads, its row key
  int32_t my_e = 0, my_r = 0, my_k = -1;
  if (lane < n) {
    my_e = __ldg(a.order + p0 + lane);
    my_k = __ldg(a.keys + p0 + lane);
    my_r = __ldg(a.row_idx + my_e);
  }
  const int32_t first_key = __shfl_sync(kFullMask, my_k, 0);
  const int32_t last_key = __shfl_sync(kFullMask, my_k, n - 1);
  const bool cont_before = p0 > 0 && __ldg(a.keys + p0 - 1) == first_key;
  const bool cont_after =
      p0 + n < n_live && __ldg(a.keys + p0 + n) == last_key;
  // b1: where the chunk's second row segment starts (n if it has none)
  const int32_t prev_k = __shfl_up_sync(kFullMask, my_k, 1);
  const unsigned starts =
      __ballot_sync(kFullMask, lane > 0 && lane < n && my_k != prev_k);
  const int b1 = starts ? __ffs(starts) - 1 : n;

  int64_t col[NV];
  bool on[NV];
  int head[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    col[j] = ((int64_t)blockIdx.y * NV + j) * 32 + lane;
    on[j] = col[j] < a.cols;
    head[j] = WEIGHTED && on[j] ? (int)(col[j] * VEC / a.Dh) : 0;
  }
  const V* rows = reinterpret_cast<const V*>(a.grad);
  V* out_v = reinterpret_cast<V*>(a.out);
  V* carry_v = reinterpret_cast<V*>(a.carry);

  // Sum positions [beg, end) in order, storing each row as it ends. The
  // first row starts from the previous chunk's carry when `carried`; the
  // last goes to this chunk's carry when it goes on past the chunk.
  auto sum_range = [&](int beg, int end, bool carried) {
    V acc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[j] = Vec<VEC>::zero();
    int32_t cur = __shfl_sync(kFullMask, my_k, beg);
    for (int k0 = beg; k0 < end; k0 += U) {
      V g[U][NV];
      float w[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = k0 + u;
        const int src = min(k, end - 1);
        const int32_t r = __shfl_sync(kFullMask, my_r, src);
        const int32_t e = __shfl_sync(kFullMask, my_e, src);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          g[u][j] = Vec<VEC>::zero();
          w[u][j] = 1.0f;
          if (k < end && on[j]) {
            g[u][j] = __ldg(rows + (int64_t)r * a.cols + col[j]);
            if (WEIGHTED) {
              w[u][j] = __ldg(a.weights + (int64_t)e * a.H + head[j]);
            }
          }
        }
      }
      if (carried) {
        // the first batch's gathers are in flight; now the carry-in
        carried = false;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (!on[j]) continue;
          V* src = carry_v + (chunk - 1) * a.cols + col[j];
          long long spins = 0;
          while (unset(acc[j] = __ldcg(src))) {
            __nanosleep(32);
            if (++spins > kMaxSpins) __trap();
          }
          __stcg(src, unset_vec<VEC>());
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int32_t key =
            __shfl_sync(kFullMask, my_k, min(k0 + u, end - 1));
        if (k0 + u < end) {
          if (key != cur) {
#pragma unroll
            for (int j = 0; j < NV; ++j) {
              if (on[j]) out_v[(int64_t)cur * a.cols + col[j]] = acc[j];
              acc[j] = Vec<VEC>::zero();
            }
            cur = key;
          }
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            if (WEIGHTED) {
              add_term(acc[j], w[u][j], g[u][j]);
            } else {
              Vec<VEC>::add(acc[j], g[u][j]);
            }
          }
        }
      }
    }
    V* dst = end == n && cont_after ? carry_v + chunk * a.cols
                                    : out_v + (int64_t)cur * a.cols;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (on[j]) __stcg(dst + col[j], acc[j]);
    }
  };

  // the segments after the first need no carry: store before waiting
  if (b1 < n) sum_range(b1, n, false);
  sum_range(0, b1, cont_before);
}

template <int C, int U, int Z, int VEC, int NV, bool WEIGHTED>
int launch(const Args& a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return (int)err;
  const int64_t chunk_blocks = (a.num_chunks + kWarps - 1) / kWarps;
  const int64_t slabs = (a.cols + 32 * NV - 1) / (32 * NV);
  const int64_t zero_blocks =
      std::min<int64_t>((a.num_rows + 32 * kWarps - 1) / (32 * kWarps),
                        (int64_t)Z * sms);
  src_scatter_kernel<C, U, VEC, NV, WEIGHTED>
      <<<dim3((unsigned)(zero_blocks + chunk_blocks), (unsigned)slabs),
         32 * kWarps, 0, stream>>>(a, zero_blocks);
  return (int)cudaGetLastError();
}

// Column vectors per lane: as many as a row needs, up to MAX_NV.
template <int C, int U, int MAX_NV, int Z, int VEC, bool WEIGHTED>
int launch_nv(const Args& a, cudaStream_t stream) {
  const int64_t need = (a.cols + 31) / 32;
  if (MAX_NV == 1 || need <= 1) {
    return launch<C, U, Z, VEC, 1, WEIGHTED>(a, stream);
  }
  if (MAX_NV == 2 || need <= 2) {
    return launch<C, U, Z, VEC, (MAX_NV >= 2 ? 2 : 1), WEIGHTED>(a, stream);
  }
  return launch<C, U, Z, VEC, (MAX_NV >= 4 ? 4 : 1), WEIGHTED>(a, stream);
}

// The call as the C entry points take it, for one choice of the design
// constants (C, U, column vectors a lane at most, zero-writing blocks an
// SM): float4 or float columns, weighted or not.
template <int C, int U, int MAX_NV, int Z>
int src_scatter(const void* grad, const void* row_idx, const void* weights,
                const void* order, const void* keys, const void* offsets,
                void* out, void* carry, void* tickets, long long num_rows,
                long long num_slots, long long F, int H, long long Dh,
                int vec4, void* stream) {
  if (num_rows <= 0 || F <= 0) return (int)cudaGetLastError();
  const Args a{(const float*)grad,     (const int32_t*)row_idx,
               (const float*)weights,  (const int32_t*)order,
               (const int32_t*)keys,   (const int32_t*)offsets,
               (float*)out,            (float*)carry,
               (int32_t*)tickets,      num_rows,
               (num_slots + C - 1) / C, vec4 ? F / 4 : F,
               H,                      Dh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (weights == nullptr) {
    return vec4 ? launch_nv<C, U, MAX_NV, Z, 4, false>(a, s)
                : launch_nv<C, U, MAX_NV, Z, 1, false>(a, s);
  }
  return vec4 ? launch_nv<C, U, MAX_NV, Z, 4, true>(a, s)
              : launch_nv<C, U, MAX_NV, Z, 1, true>(a, s);
}

}  // namespace

// The chunk size C, by which the wrapper sizes the carry rows.
extern "C" int src_scatter_chunk() { return kChunk; }

// weights == nullptr sums unweighted (H and Dh unused); otherwise weights
// is (E, H) and column c takes head c / Dh. keys are the sorted row keys of
// the grouped order. Scratch, clean before the launch and left clean: carry
// at least ceil(num_slots / C) x F floats, every one the NaN 0xffffffff;
// tickets at least ceil(F / (32 * VEC)) int32 zeros. One stream at a time
// may use a scratch. vec4 != 0 takes float4 columns (VEC = 4): the caller
// checks F % 4 == 0, Dh % 4 == 0 and 16-byte alignment of grad, out and
// carry.
extern "C" int src_scatter_f32(const void* grad, const void* row_idx,
                               const void* weights, const void* order,
                               const void* keys, const void* offsets,
                               void* out, void* carry, void* tickets,
                               long long num_rows, long long num_slots,
                               long long F, int H, long long Dh, int vec4,
                               void* stream) {
  return src_scatter<kChunk, kBatch, kMaxVecsPerLane, kZeroBlocksPerSm>(
      grad, row_idx, weights, order, keys, offsets, out, carry, tickets,
      num_rows, num_slots, F, H, Dh, vec4, stream);
}
