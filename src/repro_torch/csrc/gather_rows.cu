// K6: row gather, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `gather_rows_pallas` in
// src/repro/kernels/gather/kernel.py (body `_kernel`), which prefetched the
// indices to SMEM and let a BlockSpec index map DMA one (1, 512) row block
// per grid step:
//
//   out[i, :] = table[idx[i], :]
//
// The copy moves bytes and computes nothing, so the kernel is written over
// bytes and serves every dtype: a row of `row_bytes` is copied in units of
// VEC bytes (16, 8, 4 or 2; the wrapper picks the widest that divides the
// row and the alignment of both bases). F = 100 float32 rows (400 bytes)
// move as 25 float4 per row; F = 100 bfloat16 rows (200 bytes) as 25
// 8-byte words. Indices are int32 or int64 and must be in range: the
// kernel does not check them.
//
// Design: one warp per output row, grid-stride over rows; its lanes read
// neighbouring 16-byte words of the source row (one coalesced request per
// row) and write the output row the same way. No shared memory: nothing
// is reused.
//
// Bound on an H100 SXM (3.35 TB/s): memory. The least traffic is each
// index read once, each gathered row read once and each output row written
// once: N * (index bytes + 2 * row_bytes). At N = 1,056,000 float32 rows of
// 100 (the padded layer-0 input rows of one batch of 1000) that is 849 MB,
// 0.25 ms; chip_smoke.py times the kernel against it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kThreads = 32 * kWarps;

template <typename W, typename I>
__global__ void gather_rows_kernel(const W* __restrict__ table,
                                   const I* __restrict__ idx,
                                   W* __restrict__ out, int64_t n,
                                   int64_t words) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t i = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); i < n;
       i += warps) {
    const W* src = table + (int64_t)__ldg(idx + i) * words;
    W* dst = out + i * words;
    for (int64_t c = lane; c < words; c += 32) dst[c] = __ldg(src + c);
  }
}

template <typename I>
int launch(const void* table, const void* idx, void* out, long long n,
           long long row_bytes, int vec, void* stream) {
  if (n > 0 && row_bytes > 0) {
    const int64_t want = (n + kWarps - 1) / kWarps;
    const unsigned blocks = (unsigned)(want < 65535 * 16 ? want : 65535 * 16);
    cudaStream_t s = (cudaStream_t)stream;
    const I* ix = (const I*)idx;
    switch (vec) {
      case 16:
        gather_rows_kernel<uint4, I><<<blocks, kThreads, 0, s>>>(
            (const uint4*)table, ix, (uint4*)out, n, row_bytes / 16);
        break;
      case 8:
        gather_rows_kernel<uint2, I><<<blocks, kThreads, 0, s>>>(
            (const uint2*)table, ix, (uint2*)out, n, row_bytes / 8);
        break;
      case 4:
        gather_rows_kernel<uint32_t, I><<<blocks, kThreads, 0, s>>>(
            (const uint32_t*)table, ix, (uint32_t*)out, n, row_bytes / 4);
        break;
      case 2:
        gather_rows_kernel<uint16_t, I><<<blocks, kThreads, 0, s>>>(
            (const uint16_t*)table, ix, (uint16_t*)out, n, row_bytes / 2);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gather_rows_i32(const void* table, const void* idx, void* out,
                               long long n, long long row_bytes, int vec,
                               void* stream) {
  return launch<int32_t>(table, idx, out, n, row_bytes, vec, stream);
}

extern "C" int gather_rows_i64(const void* table, const void* idx, void* out,
                               long long n, long long row_bytes, int vec,
                               void* stream) {
  return launch<int64_t>(table, idx, out, n, row_bytes, vec, stream);
}
