// K1: row gather, out[i, :] = feat[ids[i], :], a zero row where ids[i] is
// EMPTY (int32 max), negative, or otherwise outside [0, num_rows).
//
// Replaces: xgnn_tpu/ops/pallas_gather.py, gather_rows_pallas (the Pallas
// kernel _gather_kernel).  On the port's main path it serves the
// direct-extract layer's dst rows (models/gnn.py _take_dst), the label
// gather and HBMFeatureSource.extract.
//
// What bounds it on an H100: bytes.  It moves B*F*4 bytes out, at most as
// many in, and B*4 bytes of ids; it does no arithmetic.  At the main path's
// shape (1,007,360 rows of 128 float32) the floor is about 0.3 ms at
// 3.35 TB/s.
//
// Design: one warp per output row.  The row is copied in 16-byte words
// (uint4) when F % 4 == 0 and both tables are 16-byte aligned, else in
// 4-byte words, so consecutive lanes touch consecutive addresses and every
// transaction is full.  The kernel copies 4-byte words and never looks at
// them, so float32 feature rows and the int32 label column share it.  Row
// offsets are computed in 64 bits (2.45M rows x 128 words passes 2^31).
// An invalid id writes zeros and never reads the table, so an EMPTY id can
// never turn into an out-of-range address.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

template <bool kVec>
__global__ void gather_rows_kernel(const uint32_t* __restrict__ feat,
                                   const int32_t* __restrict__ ids,
                                   uint32_t* __restrict__ out,
                                   int64_t num_rows, int64_t num_ids,
                                   int64_t width) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_ids) return;
  const int32_t id = ids[row];
  const bool valid = id >= 0 && (int64_t)id < num_rows;
  if (kVec) {
    const int64_t w4 = width >> 2;
    uint4* dst = reinterpret_cast<uint4*>(out + row * width);
    if (valid) {
      const uint4* src = reinterpret_cast<const uint4*>(feat + (int64_t)id * width);
      for (int64_t c = lane; c < w4; c += 32) dst[c] = __ldg(src + c);
    } else {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int64_t c = lane; c < w4; c += 32) dst[c] = zero;
    }
  } else {
    uint32_t* dst = out + row * width;
    if (valid) {
      const uint32_t* src = feat + (int64_t)id * width;
      for (int64_t c = lane; c < width; c += 32) dst[c] = __ldg(src + c);
    } else {
      for (int64_t c = lane; c < width; c += 32) dst[c] = 0u;
    }
  }
}

}  // namespace

// feat: (num_rows, width) 4-byte words; ids: (num_ids,) int32;
// out: (num_ids, width).  Returns cudaGetLastError() after the launch.
extern "C" int xg_gather_rows(const void* feat, const void* ids, void* out,
                              long long num_rows, long long num_ids,
                              long long width, void* stream) {
  if (num_ids <= 0 || width <= 0) return (int)cudaGetLastError();
  const long long blocks = (num_ids + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = (width % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(feat) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const uint32_t* f = static_cast<const uint32_t*>(feat);
  const int32_t* i = static_cast<const int32_t*>(ids);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (vec) {
    gather_rows_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        f, i, o, num_rows, num_ids, width);
  } else {
    gather_rows_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        f, i, o, num_rows, num_ids, width);
  }
  return (int)cudaGetLastError();
}
