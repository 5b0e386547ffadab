// K11: tiered extract, the hot rows from the cache in device memory and the
// cold rows from the host table, read in place over PCIe.
//
//   for i < num_input, id = ids[i] in [0, num_node):
//     s = posmap[id];  out[i] = s != EMPTY ? cache[s] : host[id]
//   every other row of out (EMPTY or out-of-range ids, i >= num_input) is 0;
//   counts[0] = the hits, counts[1] = the misses (exact int32).
// With no posmap (the all-miss form) every valid id is read from the host
// table: the cache's own rows are built that way.
//
// Replaces: xgnn_tpu/store/feature_store.py, _split_kernel (the posmap
// lookup, the hit/miss split and the compaction of the miss positions and
// ids), the host gather of the miss rows, their host-to-device copy and
// _combine_kernel (their scatter into place), driven by
// TieredFeatureSource.extract.  On the TPU they were XLA ops and a host
// gather, not a Pallas kernel: a TPU cannot read host memory, so its store
// moves the miss ids to the host and the rows back.  An H100 reads pinned,
// mapped host memory from a kernel, as the reference system's zero-copy
// GPUExtractMissData does, so the miss rows are read where they are: no
// compaction, no bucket, no step that waits on the host.
//
// What bounds it on an H100: bytes, over two links.  The miss rows cross
// PCIe (Gen5 x16: 63.0 GB/s a direction after its line code, the rate of
// chip_smoke.py's bound, which measures the card's pinned host-to-device
// copy rate beside it); the hit rows, the ids, the posmap words and the
// output move in HBM at 3.35 TB/s.  At the main path's shape (2,449,152
// ids, about 2M valid, 20% of the rows cached) the PCIe side, about 1.6M
// rows of 512 bytes, is the bound.  On
// an NVIDIA H100 80GB HBM3 at 700 W, loads from SMs read mapped host
// memory at about 28 GB/s at best (every row in order), where the copy
// engine's pinned copy_ moves 47-50 GB/s (tools/time_tiered.py); K11 on
// the batch as drawn reads 23-28 GB/s, and neither more rows in flight,
// other load flavours, fewer blocks nor sorted ids moved it by more than
// the spread.
//
// Design: a warp takes 32 consecutive ids.  Each lane looks up one id and
// its posmap word; two ballots count the chunk's hits and misses (kept in a
// register, summed per block in shared memory, one atomicAdd per block per
// count at the end).  Each lane forms its row's source address (a cache
// row, a host row or none), and the warp copies the 32 rows kUnroll at a
// time, shuffling the addresses, with every lane's loads of those kUnroll
// rows issued before its stores: at width 128 a lane holds kUnroll 16-byte
// words, so a resident warp keeps 4 KB of reads in flight, megabytes over
// the card, far past what PCIe latency needs.  The source is uniform
// across the warp for each row, so the tiers never diverge.  The grid is
// persistent and small: a block of 8 warps on a quarter of the
// multiprocessors (33 on an H100).  PCIe, not the SMs, sets K11's rate (33
// blocks read as fast as the 396 that fit at once), and K11 runs on the
// producer's stream beside the training step, which takes the SMs it
// leaves: with every SM held, graphsage_cached's epoch took 1.27-1.45 s,
// with a quarter 1.09-1.19 s (tools/time_tiered.py, NVIDIA H100 80GB
// HBM3, 700 W).  It copies 16-byte words when the width is a multiple of
// 4 and every table is 16-byte aligned, 4-byte words otherwise.
//
// Beside it: xg_host_map pins a host table and maps it into the device's
// address space (cudaHostRegister with cudaHostRegisterMapped, then
// cudaHostGetDevicePointer); xg_host_unmap releases it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // the rows a warp copies at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = INT32_MAX;

template <typename Word>
__device__ __forceinline__ Word zero_word();
template <>
__device__ __forceinline__ uint4 zero_word<uint4>() {
  return make_uint4(0u, 0u, 0u, 0u);
}
template <>
__device__ __forceinline__ uint32_t zero_word<uint32_t>() {
  return 0u;
}

// Word is uint4 (width in 16-byte words) or uint32_t (width in 4-byte words)
template <typename Word>
__global__ void __launch_bounds__(kThreads)
tiered_extract_kernel(const int32_t* __restrict__ ids, int64_t n,
                      const int32_t* __restrict__ num_input,
                      const int32_t* __restrict__ posmap, int64_t num_node,
                      const Word* cache, const Word* host, int64_t width,
                      Word* __restrict__ out, int32_t* __restrict__ counts) {
  __shared__ int block_hits, block_misses;
  if (threadIdx.x == 0) block_hits = block_misses = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t live = min(n, (int64_t)max(*num_input, 0));
  const int64_t chunks = (n + 31) / 32;
  const int64_t num_warps = (int64_t)gridDim.x * kWarps;
  int hits = 0, misses = 0;
  for (int64_t c = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       c < chunks; c += num_warps) {
    const int64_t base = c * 32;
    const int64_t i = base + lane;
    const Word* src = nullptr;
    bool hit = false, miss = false;
    if (i < live) {
      const int32_t id = __ldg(ids + i);
      if (id >= 0 && (int64_t)id < num_node) {
        const int32_t slot = posmap ? __ldg(posmap + id) : kEmpty;
        hit = slot != kEmpty;
        miss = !hit;
        src = hit ? cache + (int64_t)slot * width : host + (int64_t)id * width;
      }
    }
    hits += __popc(__ballot_sync(kFull, hit));
    misses += __popc(__ballot_sync(kFull, miss));
    const int rows = (int)min((int64_t)32, n - base);
    const unsigned long long mine = reinterpret_cast<unsigned long long>(src);
    for (int r0 = 0; r0 < rows; r0 += kUnroll) {
      const Word* s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        s[u] = reinterpret_cast<const Word*>(
            __shfl_sync(kFull, mine, (r0 + u) & 31));
      for (int64_t col = lane; col < width; col += 32) {
        Word v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          v[u] = s[u] != nullptr ? s[u][col] : zero_word<Word>();
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (r0 + u < rows) out[(base + r0 + u) * width + col] = v[u];
      }
    }
  }
  if (lane == 0) {
    atomicAdd(&block_hits, hits);
    atomicAdd(&block_misses, misses);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counts, block_hits);
    atomicAdd(counts + 1, block_misses);
  }
}

// a persistent grid, all resident at once, of at most a quarter of the
// multiprocessors' count of blocks
template <typename Kernel>
unsigned grid_for(Kernel kernel, long long n, int device) {
  int sms = 132, per_sm = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long chunks = (n + 31) / 32;
  const long long want = (chunks + kWarps - 1) / kWarps;
  long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long limit = sms / 4 > 0 ? sms / 4 : 1;
  if (cap > limit) cap = limit;
  return (unsigned)(want < cap ? want : cap);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Pin `bytes` of host memory at `host` and map it for `device`; the device
// address goes to *dev_ptr (dev_ptr: the address of a void*).  Returns the
// first CUDA error (nothing stays registered after a failure).
extern "C" int xg_host_map(void* host, long long bytes, int device,
                           void* dev_ptr) {
  if (bytes <= 0 || dev_ptr == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostRegister(host, (size_t)bytes, cudaHostRegisterMapped);
  if (e != cudaSuccess) return (int)e;
  e = cudaHostGetDevicePointer(static_cast<void**>(dev_ptr), host, 0);
  if (e != cudaSuccess) {
    cudaHostUnregister(host);
    return (int)e;
  }
  return 0;
}

extern "C" int xg_host_unmap(void* host, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaHostUnregister(host);
}

// ids: (n,) int32; num_input: a device int32 scalar; posmap: (num_node,)
// int32 cache slots, EMPTY where not cached, or null (all miss); cache:
// (num_cache, width) 4-byte words in device memory (unused when posmap is
// null); host: the device address of the mapped (num_node, width) host
// table; out: (n, width); counts: 2 int32 (hits, misses), zeroed here.
// Returns cudaGetLastError() after the launch.
extern "C" int xg_tiered_extract(const void* ids, long long n,
                                 const void* num_input, const void* posmap,
                                 long long num_node, const void* cache,
                                 const void* host, long long width, void* out,
                                 void* counts, int device, void* stream) {
  if (n < 0 || width <= 0 || num_node < 0 || num_node > INT32_MAX ||
      host == nullptr || counts == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaMemsetAsync(counts, 0, 2 * sizeof(int32_t), s);
  if (n == 0) return (int)cudaGetLastError();
  const int32_t* id = static_cast<const int32_t*>(ids);
  const int32_t* num = static_cast<const int32_t*>(num_input);
  const int32_t* pm = static_cast<const int32_t*>(posmap);
  int32_t* cnt = static_cast<int32_t*>(counts);
  const bool vec = width % 4 == 0 && aligned16(host) && aligned16(out) &&
                   (posmap == nullptr || aligned16(cache));
  if (vec) {
    const unsigned grid = grid_for(tiered_extract_kernel<uint4>, n, device);
    tiered_extract_kernel<uint4><<<grid, kThreads, 0, s>>>(
        id, n, num, pm, num_node, static_cast<const uint4*>(cache),
        static_cast<const uint4*>(host), width / 4, static_cast<uint4*>(out),
        cnt);
  } else {
    const unsigned grid = grid_for(tiered_extract_kernel<uint32_t>, n, device);
    tiered_extract_kernel<uint32_t><<<grid, kThreads, 0, s>>>(
        id, n, num, pm, num_node, static_cast<const uint32_t*>(cache),
        static_cast<const uint32_t*>(host), width,
        static_cast<uint32_t*>(out), cnt);
  }
  return (int)cudaGetLastError();
}
