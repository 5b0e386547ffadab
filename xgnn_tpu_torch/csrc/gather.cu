// K1: row gather, out[i, :] = feat[ids[i], :], a zero row where ids[i] is
// EMPTY (int32 max), negative, or otherwise outside [0, num_rows).
//
// Replaces: xgnn_tpu/ops/pallas_gather.py, gather_rows_pallas (the Pallas
// kernel _gather_kernel).  On the port's main path it serves the
// direct-extract layer's dst rows (models/gnn.py _take_dst), the label
// gather and HBMFeatureSource.extract; under feat_dtype="bfloat16" the same
// rows of the bfloat16 table, and from an F16 feature file those of its
// float16 table.
//
// What bounds it on an H100: bytes.  It moves B*F*s bytes out (s the
// element's 4 or 2 bytes), at most as many in, and B*4 bytes of ids; it
// does no arithmetic.  At the main path's shape (1,007,360 rows of 128
// float32) the floor is about 0.3 ms at 3.35 TB/s, and about 0.15 ms for
// the same rows in bfloat16.
//
// Design: a group of kLanes lanes per output row, kLanes the power of two
// that covers the row's words, at most a warp: a 512-byte float32 row of
// 128 takes a warp of 16-byte words, a 256-byte bfloat16 row of 128 half a
// warp, so a warp copies two such rows at once and no lane idles.  The
// kernel copies a row's bytes and never looks at them, so float32,
// bfloat16 and float16 feature rows and the int32 label column share it.  The row is
// copied in 16-byte words (uint4) when its bytes are a multiple of 16 and
// both tables are 16-byte aligned, else in 4-byte words when they are a
// multiple of 4 (every float32 or int32 row, a 2-byte row of even
// width), else in 2-byte words (a 2-byte row of odd width, whose rows
// start 2-byte aligned), so consecutive lanes touch consecutive addresses.
// Row offsets are computed in 64 bits (2.45M rows x 128 words passes
// 2^31).  An invalid id writes zeros and never reads the table, so an
// EMPTY id can never turn into an out-of-range address.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Word>
__device__ __forceinline__ Word zero_word() {
  return Word(0);
}
template <>
__device__ __forceinline__ uint4 zero_word<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}

// width: the row's length in Words; kLanes lanes copy one row
template <typename Word, int kLanes>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const Word* __restrict__ feat,
                   const int32_t* __restrict__ ids, Word* __restrict__ out,
                   int64_t num_rows, int64_t num_ids, int64_t width) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t row = t / kLanes;
  const int lane = (int)(t % kLanes);
  if (row >= num_ids) return;
  const int32_t id = ids[row];
  const bool valid = id >= 0 && (int64_t)id < num_rows;
  Word* dst = out + row * width;
  if (valid) {
    const Word* src = feat + (int64_t)id * width;
    // not unrolled: the unrolled copy took 40 registers (6 blocks an SM,
    // and 9-10% more time at 128 float32) for a loop that runs once a
    // lane at the main path's widths; this one takes 18 (8 blocks)
#pragma unroll 1
    for (int64_t c = lane; c < width; c += kLanes) dst[c] = __ldg(src + c);
  } else {
    const Word zero = zero_word<Word>();
    for (int64_t c = lane; c < width; c += kLanes) dst[c] = zero;
  }
}

template <typename Word, int kLanes>
void launch_lanes(const void* feat, const void* ids, void* out,
                  long long num_rows, long long num_ids, long long width,
                  cudaStream_t s) {
  const long long per_block = kThreads / kLanes;
  const long long blocks = (num_ids + per_block - 1) / per_block;
  gather_rows_kernel<Word, kLanes><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const Word*>(feat), static_cast<const int32_t*>(ids),
      static_cast<Word*>(out), num_rows, num_ids, width);
}

// the narrowest group of lanes that covers a row of `width` words
template <typename Word>
void launch(const void* feat, const void* ids, void* out, long long num_rows,
            long long num_ids, long long width, cudaStream_t s) {
  if (width <= 1)
    launch_lanes<Word, 1>(feat, ids, out, num_rows, num_ids, width, s);
  else if (width <= 2)
    launch_lanes<Word, 2>(feat, ids, out, num_rows, num_ids, width, s);
  else if (width <= 4)
    launch_lanes<Word, 4>(feat, ids, out, num_rows, num_ids, width, s);
  else if (width <= 8)
    launch_lanes<Word, 8>(feat, ids, out, num_rows, num_ids, width, s);
  else if (width <= 16)
    launch_lanes<Word, 16>(feat, ids, out, num_rows, num_ids, width, s);
  else
    launch_lanes<Word, 32>(feat, ids, out, num_rows, num_ids, width, s);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// feat: (num_rows, width) elements of elem_bytes (4: float32 or int32, 2:
// bfloat16 or float16); ids: (num_ids,) int32; out: (num_ids, width) of feat's type.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue,
// launching nothing, for another element size).
extern "C" int xg_gather_rows(const void* feat, const void* ids, void* out,
                              long long num_rows, long long num_ids,
                              long long width, int elem_bytes, void* stream) {
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  if (num_ids <= 0 || width <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long row_bytes = width * elem_bytes;
  if (row_bytes % 16 == 0 && aligned(feat, 16) && aligned(out, 16))
    launch<uint4>(feat, ids, out, num_rows, num_ids, row_bytes / 16, s);
  else if (row_bytes % 4 == 0 && aligned(feat, 4) && aligned(out, 4))
    launch<uint32_t>(feat, ids, out, num_rows, num_ids, row_bytes / 4, s);
  else
    launch<uint16_t>(feat, ids, out, num_rows, num_ids, row_bytes / 2, s);
  return (int)cudaGetLastError();
}
