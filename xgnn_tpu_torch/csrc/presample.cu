// K12 and K12b: the presample counts of the cache rankings.
//
// K12, accumulate_freq: freq[ids[i]] += 1 for every i < num_input whose id
// lies in [0, num_node) (EMPTY and other ids are dropped).  Exact int32.
//
// Replaces: xgnn_tpu/store/presample.py, _accumulate (a jitted
// scatter-add over a batch's input nodes; XLA ops on the TPU, not a Pallas
// kernel).  It counts presample_ranking's batches and the dynamic cache's
// steps.
//
// What bounds K12 on an H100: bytes.  It reads each id once and reads and
// writes one freq word per valid id (the main path's last frontier, about
// 2M valid ids of 2,449,152: about 26 MB, under 0.01 ms at 3.35 TB/s).
// Design: a thread per id, grid-stride, an integer atomicAdd per valid id.
// A batch's input nodes are distinct (the last layer's dedup), so the
// atomics never contend; integer adds are exact in any order.
//
// K12b, closure_expand: one batch of static_exact_ranking.  The seeds'
// mask, then num_layer times every CSR neighbour of a marked row marked
// (from the mask of the layer before: a row marked in this layer does not
// expand until the next), then counts[v] += mask[v] for every node.
//
// Replaces: xgnn_tpu/store/presample.py, expand inside static_exact_ranking
// (an edge-parallel bitmask closure: a gather of the mask along each edge's
// source row and a scatter-max into the destinations; XLA ops).
//
// What bounds K12b: bytes.  Per layer it reads the mask (num_node bytes),
// an indptr pair and the indices of every marked row, and stores a byte a
// neighbour; then it reads the mask and reads and writes counts once.  At
// products scale a batch of 8,000 seeds marks most of the graph by its
// third layer, so the indices (496 MB) dominate.
// Design: the mask is double-buffered (the next layer's buffer starts as a
// copy of the current one), so that a layer reads only the layer before.
// A warp takes 32 consecutive rows: each lane reads one row's mask byte
// and its indptr pair, a ballot names the marked rows, and the warp
// streams each marked row's indices with its 32 lanes, storing 1 into the
// next mask.  The stores are idempotent, so their races are harmless, and
// an unmarked row costs one byte of a coalesced read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

int grid_cap(int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms * (2048 / kThreads);
}

unsigned grid_for(long long items, int device) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = grid_cap(device);
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

__global__ void accumulate_kernel(int32_t* __restrict__ freq, int64_t num_node,
                                  const int32_t* __restrict__ ids, int64_t n,
                                  const int32_t* __restrict__ num_input) {
  const int64_t live = min(n, (int64_t)max(*num_input, 0));
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < live;
       i += stride) {
    const int32_t id = __ldg(ids + i);
    if (id >= 0 && (int64_t)id < num_node) atomicAdd(freq + id, 1);
  }
}

__global__ void seed_kernel(uint8_t* __restrict__ mask, int64_t num_node,
                            const int32_t* __restrict__ seeds, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int32_t id = __ldg(seeds + i);
    if (id >= 0 && (int64_t)id < num_node) mask[id] = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
expand_kernel(const int32_t* __restrict__ indptr,
              const int32_t* __restrict__ indices, int64_t num_node,
              const uint8_t* __restrict__ cur, uint8_t* __restrict__ next) {
  const int lane = threadIdx.x & 31;
  const int64_t groups = (num_node + 31) / 32;
  const int64_t num_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t g = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       g < groups; g += num_warps) {
    const int64_t row = g * 32 + lane;
    bool marked = false;
    int32_t lo = 0, hi = 0;
    if (row < num_node && __ldg(cur + row)) {
      lo = __ldg(indptr + row);
      hi = __ldg(indptr + row + 1);
      marked = hi > lo;
    }
    unsigned todo = __ballot_sync(kFull, marked);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const int32_t b = __shfl_sync(kFull, lo, src);
      const int32_t e = __shfl_sync(kFull, hi, src);
      for (int32_t k = b + lane; k < e; k += 32) {
        const int32_t v = __ldg(indices + k);
        if (v >= 0 && (int64_t)v < num_node) next[v] = 1;
      }
    }
  }
}

__global__ void add_kernel(int32_t* __restrict__ counts,
                           const uint8_t* __restrict__ mask,
                           int64_t num_node) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = num_node >> 2;
  const uchar4* m4 = reinterpret_cast<const uchar4*>(mask);
  int4* c4 = reinterpret_cast<int4*>(counts);
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += stride) {
    const uchar4 m = __ldg(m4 + q);
    int4 c = c4[q];
    c.x += m.x;
    c.y += m.y;
    c.z += m.z;
    c.w += m.w;
    c4[q] = c;
  }
  const int64_t p = (n4 << 2) + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < num_node) counts[p] += mask[p];
}

}  // namespace

// freq: (num_node,) int32, added to in place; ids: (n,) int32; num_input:
// a device int32 scalar.  Returns cudaGetLastError() after the launch.
extern "C" int xg_accumulate_freq(void* freq, long long num_node,
                                  const void* ids, long long n,
                                  const void* num_input, int device,
                                  void* stream) {
  if (n < 0 || num_node < 0 || num_node > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  accumulate_kernel<<<grid_for(n, device), kThreads, 0, s>>>(
      static_cast<int32_t*>(freq), num_node, static_cast<const int32_t*>(ids),
      n, static_cast<const int32_t*>(num_input));
  return (int)cudaGetLastError();
}

// indptr: (num_node + 1,) int32; indices: (num_edge,) int32; seeds: (n,)
// int32 (ids outside [0, num_node) ignored); mask_a, mask_b: scratch of
// num_node bytes each; counts: (num_node,) int32, 16-byte aligned, added to
// in place.  Returns cudaGetLastError() after the last launch.
extern "C" int xg_closure_expand(const void* indptr, const void* indices,
                                 long long num_node, const void* seeds,
                                 long long n, int num_layer, void* mask_a,
                                 void* mask_b, void* counts, int device,
                                 void* stream) {
  if (n < 0 || num_node < 0 || num_node > INT32_MAX || num_layer < 0 ||
      reinterpret_cast<uintptr_t>(counts) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(mask_a) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(mask_b) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (num_node == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  uint8_t* cur = static_cast<uint8_t*>(mask_a);
  uint8_t* nxt = static_cast<uint8_t*>(mask_b);
  cudaMemsetAsync(cur, 0, (size_t)num_node, s);
  if (n > 0)
    seed_kernel<<<grid_for(n, device), kThreads, 0, s>>>(
        cur, num_node, static_cast<const int32_t*>(seeds), n);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const long long groups = (num_node + 31) / 32;
  for (int l = 0; l < num_layer; ++l) {
    cudaMemcpyAsync(nxt, cur, (size_t)num_node, cudaMemcpyDeviceToDevice, s);
    expand_kernel<<<grid_for(groups * 32, device), kThreads, 0, s>>>(
        ip, ix, num_node, cur, nxt);
    uint8_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  add_kernel<<<grid_for((num_node + 3) / 4, device), kThreads, 0, s>>>(
      static_cast<int32_t*>(counts), cur, num_node);
  return (int)cudaGetLastError();
}
