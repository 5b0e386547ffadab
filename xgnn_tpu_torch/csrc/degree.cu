// K7: pick multiplicity, the block-local degree of GCN's symmetric norm.
//
//   counts[p] = #{q : ids[q] == ids[p]} over the valid picks of the whole
//               flattened block, 0 where ids[p] is not valid,
// where a pick is valid when it lies in [0, num_rows): EMPTY (int32 max)
// does not.  Exact int32.
//
// Replaces: xgnn_tpu/ops/degree.py, pick_multiplicity (two lax.sort passes
// and forward fills, shaped for the TPU, where a scatter ran at a quarter
// of a sort's rate).  On the TPU it was XLA ops, not a Pallas kernel.
//
// What bounds it on an H100: bytes.  The function reads every id once and
// writes every count once (the main path's layer 0: 5.04M picks, about 40
// MB, 0.012 ms at 3.35 TB/s).  One integer add per pick is nothing to the
// card's arithmetic.
//
// Design: a memset of a num_rows-word histogram, then two grid-stride
// launches on the caller's stream.  hist: every valid pick adds 1 to its
// bin with an integer atomic; the bins of a block's picks (at most the
// 2.45M-row feature table, 9.8 MB) stay in the 50 MB L2, so the atomics
// resolve there.  gather: every pick reads its bin back.  Each thread takes
// four consecutive ids with one 16-byte load where the ids are aligned.
// The cost above the bound is the histogram: its memset (4 * num_rows
// bytes) and the ids read a second time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool valid(int32_t id, int32_t num_rows) {
  return id >= 0 && id < num_rows;
}

__global__ void hist_kernel(const int32_t* __restrict__ ids, int64_t n,
                            int32_t num_rows, int32_t* __restrict__ hist) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = n >> 2;
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += stride) {
    const int4 v = __ldg(ids4 + q);
    if (valid(v.x, num_rows)) atomicAdd(hist + v.x, 1);
    if (valid(v.y, num_rows)) atomicAdd(hist + v.y, 1);
    if (valid(v.z, num_rows)) atomicAdd(hist + v.z, 1);
    if (valid(v.w, num_rows)) atomicAdd(hist + v.w, 1);
  }
  // the ragged tail, by the first threads
  const int64_t p = (n4 << 2) + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) {
    const int32_t id = __ldg(ids + p);
    if (valid(id, num_rows)) atomicAdd(hist + id, 1);
  }
}

__device__ __forceinline__ int32_t bin(const int32_t* hist, int32_t id,
                                       int32_t num_rows) {
  return valid(id, num_rows) ? __ldcg(hist + id) : 0;
}

__global__ void gather_kernel(const int32_t* __restrict__ ids, int64_t n,
                              int32_t num_rows,
                              const int32_t* __restrict__ hist,
                              int32_t* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = n >> 2;
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  int4* out4 = reinterpret_cast<int4*>(counts);
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += stride) {
    const int4 v = __ldg(ids4 + q);
    out4[q] = make_int4(bin(hist, v.x, num_rows), bin(hist, v.y, num_rows),
                        bin(hist, v.z, num_rows), bin(hist, v.w, num_rows));
  }
  const int64_t p = (n4 << 2) + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) counts[p] = bin(hist, __ldg(ids + p), num_rows);
}

__global__ void hist_kernel_scalar(const int32_t* __restrict__ ids, int64_t n,
                                   int32_t num_rows,
                                   int32_t* __restrict__ hist) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride) {
    const int32_t id = __ldg(ids + p);
    if (valid(id, num_rows)) atomicAdd(hist + id, 1);
  }
}

__global__ void gather_kernel_scalar(const int32_t* __restrict__ ids,
                                     int64_t n, int32_t num_rows,
                                     const int32_t* __restrict__ hist,
                                     int32_t* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += stride)
    counts[p] = bin(hist, __ldg(ids + p), num_rows);
}

unsigned grid_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // enough blocks to fill the card
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// ids: (n,) int32; counts: (n,) int32; hist: scratch of at least
// max(num_rows, 1) int32 words.  Returns cudaGetLastError() after the last
// launch (cudaErrorInvalidValue, launching nothing, for sizes past int32).
extern "C" int xg_pick_multiplicity(const void* ids, void* counts, void* hist,
                                    long long n, long long num_rows,
                                    void* stream) {
  if (n < 0 || n >= INT32_MAX || num_rows < 0 || num_rows >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* id = static_cast<const int32_t*>(ids);
  int32_t* h = static_cast<int32_t*>(hist);
  int32_t* c = static_cast<int32_t*>(counts);
  const int32_t rows = (int32_t)num_rows;
  if (rows > 0) cudaMemsetAsync(h, 0, (size_t)rows * sizeof(int32_t), s);
  const bool vec = reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0;
  if (vec) {
    // the tail (n % 4 < kThreads ids) is taken by block 0's first threads
    const unsigned g = grid_for((n + 3) / 4);
    hist_kernel<<<g, kThreads, 0, s>>>(id, n, rows, h);
    gather_kernel<<<g, kThreads, 0, s>>>(id, n, rows, h, c);
  } else {
    const unsigned g = grid_for(n);
    hist_kernel_scalar<<<g, kThreads, 0, s>>>(id, n, rows, h);
    gather_kernel_scalar<<<g, kThreads, 0, s>>>(id, n, rows, h, c);
  }
  return (int)cudaGetLastError();
}
