// K13-plan: the owner exchange's plan.  Requests, grouped by owner into a
// (P, seg_cap) send buffer in request order.
//
// For request i with id = ids[i] (int32, EMPTY = int32 max marks padding;
// an id at or past hot_limit, a cold row of a tiered topology, counts as
// EMPTY: it is served on the requesting rank, never sent):
//     owner[i] = id mod P (floored) for a valid id, P for EMPTY
//     rank[i]  = the number of earlier valid requests with the same owner
//                (0 for EMPTY)
//     send[owner, rank] = id where rank < seg_cap; EMPTY in every other slot
//     pick[i]  = owner * seg_cap + rank where valid and rank < seg_cap,
//                else EMPTY
//     overflow = 1 if a valid request has rank >= seg_cap, else 0
// pick addresses request i's slot in the send buffer and, after the
// collective, its answer in the response buffer: both exchanges (the ids
// out, the rows or picks back) read it.
//
// Replaces: xgnn_tpu/parallel/exchange.py, plan_exchange (lines 49-84) and
// the pick of partitioned_gather_indirect (lines 139-147) and of
// sample_layer_partitioned (xgnn_tpu/parallel/dist_topology.py:304-314),
// with that function's hot mask (:285-291, a separate select before the
// plan there, folded into the plan's first read of each id here):
// XLA ops shaped for the TPU (P unrolled prefix sums over the whole request
// vector, then a linearised scatter with mode="drop").
//
// What bounds it on an H100: bytes.  It reads the ids (twice: once to
// count, once to place) and writes send and pick; at the main path's layer 2 (1,007,360 ids at P = 1) about 12 MB,
// under 0.004 ms at 3.35 TB/s.  The arithmetic is a few integer operations
// an id.
//
// Design: three launches, no sort and no memset.
//   1. count: a block takes a tile of kTile ids and counts them by owner
//      in shared memory (__match_any_sync gives a warp's lanes of one
//      owner; its first lane adds their number), then writes its P counts
//      owner-major.
//   2. scan: one block, a warp an owner: an exclusive scan of the owner's
//      counts over the tiles gives each tile's first rank; the owner's
//      total past seg_cap raises the overflow flag.
//   3. place: each block walks its tile again in request order, kThreads
//      ids a round; a lane's rank in its tile is the tile's count of the
//      owner before the round, plus the same owner's lanes in earlier warps
//      of the round, plus its earlier lanes in its warp
//      (__match_any_sync and a lane mask), so the scatter is stable.  The
//      same launch fills the send slots past each owner's total with EMPTY
//      (those nobody writes), so send needs no memset.
// P is at most 32 (kMaxParts): an owner is a lane of the scan's warps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;  // ids a block
constexpr int kMaxParts = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t owner_of(int32_t id, int parts,
                                            int64_t hot_limit) {
  if (id == kEmpty || (int64_t)id >= hot_limit) return parts;
  const int32_t r = id % parts;
  return r < 0 ? r + parts : r;
}

__global__ void __launch_bounds__(kThreads)
plan_count_kernel(const int32_t* __restrict__ ids, int64_t n, int parts,
                  int64_t hot_limit, int32_t* __restrict__ counts,
                  int64_t tiles) {
  __shared__ int32_t cnt[kMaxParts];
  if (threadIdx.x < kMaxParts) cnt[threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)blockIdx.x * kTile;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = base + (int64_t)r * kThreads + threadIdx.x;
    const int32_t o =
        i < n ? owner_of(__ldg(ids + i), parts, hot_limit) : parts;
    const unsigned peers = __match_any_sync(kFull, o);
    if (o < parts && lane == __ffs(peers) - 1)
      atomicAdd(&cnt[o], __popc(peers));
  }
  __syncthreads();
  if (threadIdx.x < parts)
    counts[(int64_t)threadIdx.x * tiles + blockIdx.x] = cnt[threadIdx.x];
}

// one block of parts warps: warp k turns owner k's tile counts into first
// ranks, in place, and writes the owner's total
__global__ void plan_scan_kernel(int32_t* __restrict__ counts,
                                 int64_t tiles, int32_t* __restrict__ totals,
                                 int64_t seg_cap,
                                 int32_t* __restrict__ overflow) {
  __shared__ int32_t over[kMaxParts];
  const int k = threadIdx.x / 32, lane = threadIdx.x & 31;
  int32_t* row = counts + (int64_t)k * tiles;
  int64_t carry = 0;
  for (int64_t c = 0; c < tiles; c += 32) {
    const int64_t t = c + lane;
    const int32_t v = t < tiles ? row[t] : 0;
    int32_t incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (t < tiles) row[t] = (int32_t)(carry + incl - v);
    carry += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) {
    totals[k] = (int32_t)carry;
    over[k] = carry > seg_cap;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t any = 0;
    for (int j = 0; j < (int)(blockDim.x / 32); ++j) any |= over[j];
    *overflow = any;
  }
}

__global__ void __launch_bounds__(kThreads)
plan_place_kernel(const int32_t* __restrict__ ids, int64_t n, int parts,
                  int64_t hot_limit, int64_t seg_cap,
                  const int32_t* __restrict__ first,
                  int64_t tiles, const int32_t* __restrict__ totals,
                  int32_t* __restrict__ send, int32_t* __restrict__ pick) {
  __shared__ int32_t run[kMaxParts];           // the tile's ranks so far
  __shared__ int32_t warp_cnt[kWarps][kMaxParts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  if (threadIdx.x < kMaxParts)
    run[threadIdx.x] = threadIdx.x < parts
                           ? first[(int64_t)threadIdx.x * tiles + blockIdx.x]
                           : 0;
  const unsigned below = (1u << lane) - 1u;
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int r = 0; r < kRounds; ++r) {
    for (int j = threadIdx.x; j < kWarps * kMaxParts; j += kThreads)
      (&warp_cnt[0][0])[j] = 0;
    __syncthreads();
    const int64_t i = base + (int64_t)r * kThreads + threadIdx.x;
    const int32_t id = i < n ? __ldg(ids + i) : kEmpty;
    const int32_t o = owner_of(id, parts, hot_limit);
    const unsigned peers = __match_any_sync(kFull, o);
    if (o < parts && lane == __ffs(peers) - 1)
      warp_cnt[warp][o] = __popc(peers);
    __syncthreads();
    if (i < n) {
      int32_t rank = 0;
      if (o < parts) {
        rank = run[o] + __popc(peers & below);
        for (int w = 0; w < warp; ++w) rank += warp_cnt[w][o];
      }
      const bool ok = o < parts && rank < seg_cap;
      const int64_t slot = (int64_t)o * seg_cap + rank;
      if (ok) send[slot] = id;
      pick[i] = ok ? (int32_t)slot : kEmpty;
    }
    __syncthreads();
    if (threadIdx.x < parts) {
      int32_t add = 0;
      for (int w = 0; w < kWarps; ++w) add += warp_cnt[w][threadIdx.x];
      run[threadIdx.x] += add;
    }
    __syncthreads();  // before the next round clears warp_cnt
  }
  // the send slots past each owner's total, which no request fills
  const int64_t slots = (int64_t)parts * seg_cap;
  for (int64_t s = (int64_t)blockIdx.x * kThreads + threadIdx.x; s < slots;
       s += (int64_t)gridDim.x * kThreads) {
    const int64_t k = s / seg_cap;
    if (s - k * seg_cap >= totals[k]) send[s] = kEmpty;
  }
}

}  // namespace

// ids: (n,) int32; hot_limit: ids at or past it are not sent (EMPTY in
// pick; 2^31 - 1 sends every valid id); send: (parts * seg_cap,) int32;
// pick: (n,) int32; overflow: one int32;
// scratch: (parts * ceil(n / 2048) + parts,) int32.  1 <= parts <= 32 and
// seg_cap >= 1.  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue, launching nothing, for sizes it does not take).
extern "C" int xg_plan_exchange(const void* ids, long long n, int parts,
                                long long hot_limit, long long seg_cap,
                                void* send, void* pick,
                                void* overflow,
                                void* scratch, void* stream) {
  if (parts < 1 || parts > kMaxParts || seg_cap < 1 || n < 0 ||
      seg_cap > (long long)0x7fffffff / parts)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int64_t tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  int32_t* counts = static_cast<int32_t*>(scratch);
  int32_t* totals = counts + (int64_t)parts * tiles;
  const int32_t* in = static_cast<const int32_t*>(ids);
  if (n > 0) {
    plan_count_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
        in, n, parts, hot_limit, counts, tiles);
  } else {
    cudaMemsetAsync(counts, 0, (size_t)parts * sizeof(int32_t), s);
  }
  plan_scan_kernel<<<1, parts * 32, 0, s>>>(
      counts, tiles, totals, seg_cap, static_cast<int32_t*>(overflow));
  plan_place_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      in, n, parts, hot_limit, seg_cap, counts, tiles, totals,
      static_cast<int32_t*>(send), static_cast<int32_t*>(pick));
  return (int)cudaGetLastError();
}
