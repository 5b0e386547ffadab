// K7: pick multiplicity, the block-local degree of GCN's symmetric norm.
//
//   counts[p] = #{q : ids[q] == ids[p]} over the valid picks of the whole
//               flattened block, 0 where ids[p] is not valid,
// where a pick is valid when it lies in [0, num_rows): EMPTY (int32 max)
// does not.  Exact int32.  Also GCN's per-pick weight
//   weights[p] = rsqrt(max((float)counts[p], 1))
// with the rsqrtf that torch.rsqrt runs on the card (bit-equal to it).
//
// Replaces: xgnn_tpu/ops/degree.py, pick_multiplicity (two lax.sort passes
// and forward fills, shaped for the TPU, where a scatter ran at a quarter
// of a sort's rate).  On the TPU it was XLA ops, not a Pallas kernel.
//
// What bounds it on an H100: bytes, and two L2 round trips a valid pick.
// The function reads every id once and writes every count (and weight)
// once: at the main path's layer 0, 5.04M picks, about 60 MB, 0.018 ms at
// 3.35 TB/s.  A histogram over [0, num_rows) needs one integer atomic a
// valid pick and one read of its bin after the last atomic; the bins (at
// most the 2.45M-row feature table, 9.8 MB) stay in the 50 MB L2, so each
// of those is an L2 access at a random address.  Measured on an H100 80GB
// HBM3 (tools/time_degree.py): the atomics resolve at about 83G a second
// and the bins' reads at about 112G, so layer 0's 4.79M valid picks cost
// about 0.1 ms however the ids are read; at layers 1 and 2 (1.23M and
// 0.12M picks) the launches do.
//
// Design: three launches on the caller's stream:
//   zero: a memset of the bins (it took less time at the main path's
//         three layers than a 0 stored by a kernel to each pick's bin);
//   count: an integer atomicAdd a valid pick into its bin, resolved in L2;
//   gather: each pick reads its bin back (an L2 read, bypassing L1), and
//         writes its count and GCN's weight, which saves the three
//         elementwise launches that computed it from the counts (0.043,
//         0.013 and 0.008 ms at the three layers).
// Each thread takes four consecutive ids with one 16-byte load where the
// ids and outputs are aligned.  One launch with grid barriers between the
// phases was tried: a cooperative launch held the host until the card had
// drained (the host never got ahead of it), which the pipelined step
// cannot take, and a barrier of its own over a plain launch could wait on
// blocks that another stream's kernels keep off the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool valid(int32_t id, int32_t num_rows) {
  return id >= 0 && id < num_rows;
}

__device__ __forceinline__ int32_t bin(const int32_t* hist, int32_t id,
                                       int32_t num_rows) {
  return valid(id, num_rows) ? __ldcg(hist + id) : 0;
}

__device__ __forceinline__ float weight(int32_t c) {
  return rsqrtf(fmaxf((float)c, 1.0f));
}

struct Args {
  const int32_t* ids;
  int64_t n;
  int32_t num_rows;
  int32_t* hist;
  int32_t* counts;
  float* weights;
};

// One phase over the picks, grid-stride; kVec: four ids a thread.  Phase
// 0 counts, 1 gathers.
template <bool kVec>
__device__ __forceinline__ void phase(const Args& a, int which) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t items = kVec ? a.n >> 2 : a.n;
  for (int64_t q = tid; q < items; q += stride) {
    int32_t v[4];
    int m = 1;
    if (kVec) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(a.ids) + q);
      v[0] = x.x;
      v[1] = x.y;
      v[2] = x.z;
      v[3] = x.w;
      m = 4;
    } else {
      v[0] = __ldg(a.ids + q);
    }
    if (which == 0) {
      for (int k = 0; k < m; ++k)
        if (valid(v[k], a.num_rows)) {
          atomicAdd(a.hist + v[k], 1);
        }
    } else if (kVec) {
      const int4 c = make_int4(bin(a.hist, v[0], a.num_rows),
                               bin(a.hist, v[1], a.num_rows),
                               bin(a.hist, v[2], a.num_rows),
                               bin(a.hist, v[3], a.num_rows));
      reinterpret_cast<int4*>(a.counts)[q] = c;
      reinterpret_cast<float4*>(a.weights)[q] = make_float4(
          weight(c.x), weight(c.y), weight(c.z), weight(c.w));
    } else {
      const int32_t c = bin(a.hist, v[0], a.num_rows);
      a.counts[q] = c;
      a.weights[q] = weight(c);
    }
  }
  // the ragged tail (n % 4 ids) of the vector form, by the first threads
  if (kVec && tid < (a.n & 3)) {
    const int64_t p = (a.n & ~int64_t(3)) + tid;
    const int32_t id = __ldg(a.ids + p);
    if (which == 0) {
      if (valid(id, a.num_rows)) atomicAdd(a.hist + id, 1);
    } else {
      const int32_t c = bin(a.hist, id, a.num_rows);
      a.counts[p] = c;
      a.weights[p] = weight(c);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
multiplicity_kernel(Args a, int which) {
  phase<kVec>(a, which);
}

unsigned grid_for(long long items) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;  // enough blocks to fill the card
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// ids: (n,) int32; counts: (n,) int32; weights: (n,) float32;
// hist: scratch of at least max(num_rows, 1) int32 words.  Returns
// cudaGetLastError() after the last launch (cudaErrorInvalidValue,
// launching nothing, for sizes past int32).
extern "C" int xg_pick_multiplicity(const void* ids, void* counts,
                                    void* weights, void* hist, long long n,
                                    long long num_rows, void* stream) {
  if (n < 0 || n >= INT32_MAX || num_rows < 0 || num_rows >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Args a{static_cast<const int32_t*>(ids), n, (int32_t)num_rows,
         static_cast<int32_t*>(hist), static_cast<int32_t*>(counts),
         static_cast<float*>(weights)};
  cudaMemsetAsync(hist, 0, (size_t)(num_rows > 0 ? num_rows : 1) * 4, s);
  const bool vec = reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(counts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(weights) % 16 == 0;
  const unsigned grid = grid_for(vec ? (n + 3) / 4 : n);
  for (int w = 0; w < 2; ++w) {
    if (vec)
      multiplicity_kernel<true><<<grid, kThreads, 0, s>>>(a, w);
    else
      multiplicity_kernel<false><<<grid, kThreads, 0, s>>>(a, w);
  }
  return (int)cudaGetLastError();
}
