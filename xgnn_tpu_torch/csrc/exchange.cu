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
// What bounds it on an H100: bytes, and at the main path's sizes the
// launches.  It reads the ids once and writes send and pick once: at the
// main path's layer 2 (1,007,360 ids at P = 1) about 12 MB, under 0.004 ms
// at 3.35 TB/s; at layers 0 and 1 (8,000 and 133,376 ids) under 0.001 ms,
// far below a launch's few microseconds.  The arithmetic is a few integer
// operations an id.  So a call is one launch (and one memset node).
//
// Design (a): a single pass with decoupled look-back (CUB's DeviceScan
// pattern), one block a tile of kTile ids.
//   A block takes the next tile from an atomic ticket, so tiles start in
//   order and a look-back only ever waits on a tile whose block is already
//   running (more tiles than the card holds blocks cannot deadlock).  It
//   reads its ids once, into registers, and ranks each within the tile by
//   owner: __match_any_sync gives a warp's lanes of one owner in a round,
//   and a warp-scan an owner over the tile's (round, warp) counts in shared
//   memory gives each group's first in-tile rank.  The tile publishes its
//   P owner counts (flag AGG) in a 64-bit status word each (flag and value
//   in one store), then warp 0 looks back, a lane an (owner, earlier
//   tile): 32 / P' earlier tiles a step (P' the least power of two >= P),
//   it adds each owner's published values back to its nearest inclusive
//   prefix (flag INC), and publishes its own inclusive prefix.  (Eight
//   reads a lane in flight, 256 / P' tiles a step, timed slower at P = 1
//   and level at P = 8: the look-back is not what bounds the call.)  The tile
//   then places its ids, stable in request order.
//   send's unused slots: only the last tile knows the totals, so each tile
//   writes EMPTY where it can prove no request lands: owner o's slots from
//   incl_t[o] + (ids after tile t) up to excl_t[o] + (ids from tile t on),
//   or up to seg_cap for tile 0.  Over the tiles those ranges cover exactly
//   [min(total_o, seg_cap), seg_cap), with no overlap, so every slot of send
//   is written once and send needs no fill of its own.  The last tile
//   writes the overflow byte from the totals.
//   The ticket and the status words are the call's scratch, zeroed by one
//   memset: nothing lives across calls, so a CUDA graph replays the call
//   as it ran, and two streams never share it.
// Design (b), compiled with -DXG_PLAN_CLUSTER for the timing tool only
// (tools/time_exchange.py): one cluster of kClusterBlocks blocks on
// distributed shared memory: count, cluster.sync(), each block's first
// ranks from the others' counts, place, fill.  No memset and no look-back,
// but kClusterBlocks SMs stream the whole call.  Timed in turns on an
// NVIDIA H100 80GB HBM3 at 700 W (device ms, the memset included, at the
// main path's three layers at P = 1): (a) 0.0076 / 0.0084 / 0.0137, (b)
// 0.0072 / 0.0223 / 0.1215.  (b) is level at layer 0 only, so (a) ships,
// alone: a second path for 8,000 ids would save under 0.001 ms.  Tiles of
// 4,096 or 1,024 ids were level or slower at the three layers.
// P is at most 32 (kMaxParts): an owner is a lane of the look-back warp.

#include <cuda_runtime.h>
#include <stdint.h>
#ifdef XG_PLAN_CLUSTER
#include <cooperative_groups.h>
#endif

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int kTile = kThreads * kRounds;  // ids a block
constexpr int kSlots = kRounds * kWarps;   // (round, warp) counts an owner
constexpr int kMaxParts = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAgg = 1ull << 32;  // a tile's own counts
constexpr unsigned long long kInc = 2ull << 32;  // its inclusive prefix
static_assert(kSlots % 32 == 0, "a lane scans kSlots / 32 counts");

__device__ __forceinline__ int32_t owner_of(int32_t id, int parts,
                                            int64_t hot_limit) {
  if (id == kEmpty || (int64_t)id >= hot_limit) return parts;
  const int32_t r = id % parts;
  return r < 0 ? r + parts : r;
}

__global__ void __launch_bounds__(kThreads)
plan_exchange_kernel(const int32_t* __restrict__ ids, int64_t n, int parts,
                     int64_t hot_limit, int64_t seg_cap, int64_t tiles,
                     int32_t* __restrict__ send, int32_t* __restrict__ pick,
                     uint8_t* __restrict__ overflow,
                     unsigned long long* status, unsigned* ticket) {
  // cnt[o][s]: owner o's in-tile first rank of (round, warp) slot s after
  // the scan; cnt[o][kSlots] the tile's count of o
  __shared__ int32_t cnt[kMaxParts][kSlots + 1];
  __shared__ int32_t first[kMaxParts];  // the tile's first rank an owner
  __shared__ unsigned s_tile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  for (int j = threadIdx.x; j < kMaxParts * (kSlots + 1); j += kThreads)
    (&cnt[0][0])[j] = 0;
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t start = t * kTile;
  const unsigned lower = (1u << lane) - 1u;
  int32_t id[kRounds], own[kRounds], below[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + (int64_t)r * kThreads + threadIdx.x;
    id[r] = i < n ? __ldg(ids + i) : kEmpty;
    own[r] = owner_of(id[r], parts, hot_limit);
    const unsigned peers = __match_any_sync(kFull, own[r]);
    below[r] = __popc(peers & lower);
    if (own[r] < parts && below[r] == 0)
      cnt[own[r]][r * kWarps + warp] = __popc(peers);
  }
  __syncthreads();
  // each owner's slots in request order, exclusive-scanned by one warp
  for (int o = warp; o < parts; o += kWarps) {
    constexpr int kPer = kSlots / 32;
    int32_t c[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      c[k] = cnt[o][lane * kPer + k];
      sum += c[k];
    }
    int32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    int32_t run = incl - sum;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      cnt[o][lane * kPer + k] = run;
      run += c[k];
    }
    if (lane == 31) cnt[o][kSlots] = incl;
  }
  __syncthreads();
  if (warp == 0) {
    // the look-back: a lane an (owner, earlier tile), width tiles a step
    int p2 = 1;
    while (p2 < parts) p2 <<= 1;
    const int width = 32 / p2;
    const int o = lane & (p2 - 1), k = lane / p2;
    const bool own = o < parts;
    const int32_t mine = own ? cnt[o][kSlots] : 0;
    volatile unsigned long long* at = status + t * parts + o;
    if (own && k == 0) *at = (t == 0 ? kInc : kAgg) | (unsigned)mine;
    int32_t before = 0;
    if (t > 0) {
      unsigned lanes_of_o = 0;
      for (int q = 0; q < width; ++q) lanes_of_o |= 1u << (q * p2 + o);
      bool done = !own;
      for (int64_t j0 = t - 1;; j0 -= width) {
        const int64_t j = j0 - k;
        const bool live = !done && j >= 0;
        unsigned long long s = 0;
        if (live) {
          const volatile unsigned long long* p = status + j * parts + o;
          do {
            s = *p;
          } while ((s >> 32) == 0);
        }
        // the nearest inclusive prefix of this owner in the window ends
        // the sum there
        const unsigned inc =
            __ballot_sync(kFull, live && (s & ~0xffffffffull) == kInc) &
            lanes_of_o;
        const int stop = inc ? (__ffs(inc) - 1) / p2 : width;
        uint32_t v = live && k <= stop ? (uint32_t)s : 0u;
        for (int d = width / 2; d >= 1; d >>= 1)
          v += __shfl_down_sync(kFull, v, d * p2);
        before += (int32_t)v;  // kept by the window's first lane
        done = done || inc != 0;
        if (__all_sync(kFull, done)) break;
      }
    }
    if (own && k == 0) {
      if (t > 0) *at = kInc | (unsigned)(before + mine);
      first[o] = before;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int64_t i = start + (int64_t)r * kThreads + threadIdx.x;
    if (i < n) {
      const int o = own[r];
      bool ok = false;
      int64_t slot = 0;
      if (o < parts) {
        const int64_t rank =
            (int64_t)first[o] + cnt[o][r * kWarps + warp] + below[r];
        ok = rank < seg_cap;
        slot = (int64_t)o * seg_cap + rank;
      }
      if (ok) send[slot] = id[r];
      pick[i] = ok ? (int32_t)slot : kEmpty;
    }
  }
  // EMPTY in the slots that no request of this tile or a later one takes,
  // below those that an earlier tile proved empty
  const int64_t end = min(start + kTile, n);
  for (int o = 0; o < parts; ++o) {
    const int64_t excl = first[o], incl = excl + cnt[o][kSlots];
    const int64_t lo = min(incl + (n - end), seg_cap);
    const int64_t hi = t == 0 ? seg_cap : min(excl + (n - start), seg_cap);
    int32_t* row = send + (int64_t)o * seg_cap;
    for (int64_t k = lo + threadIdx.x; k < hi; k += kThreads) row[k] = kEmpty;
  }
  if (t == tiles - 1 && threadIdx.x == 0) {
    bool any = false;
    for (int o = 0; o < parts; ++o)
      any |= (int64_t)first[o] + cnt[o][kSlots] > seg_cap;
    *overflow = any;
  }
}

#ifdef XG_PLAN_CLUSTER
namespace cg = cooperative_groups;
constexpr int kClusterBlocks = 16;
constexpr int kCThreads = 1024;
constexpr int kCWarps = kCThreads / 32;

__global__ void __launch_bounds__(kCThreads)
plan_exchange_cluster_kernel(const int32_t* __restrict__ ids, int64_t n,
                             int parts, int64_t hot_limit, int64_t seg_cap,
                             int32_t* __restrict__ send,
                             int32_t* __restrict__ pick,
                             uint8_t* __restrict__ overflow) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int32_t blk[kMaxParts];    // this block's count an owner
  __shared__ int32_t run[kMaxParts];    // its ranks so far an owner
  __shared__ int32_t total[kMaxParts];
  __shared__ int32_t wcnt[kCWarps][kMaxParts];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = cluster.block_rank(), nb = cluster.num_blocks();
  const int64_t chunk =
      ((n + nb - 1) / nb + kCThreads - 1) / kCThreads * kCThreads;
  const int64_t lo = min((int64_t)b * chunk, n), hi = min(lo + chunk, n);
  if (threadIdx.x < kMaxParts) blk[threadIdx.x] = 0;
  __syncthreads();
  for (int64_t base = lo; base < hi; base += kCThreads) {
    const int64_t i = base + threadIdx.x;
    const int32_t o =
        i < hi ? owner_of(__ldg(ids + i), parts, hot_limit) : parts;
    const unsigned peers = __match_any_sync(kFull, o);
    if (o < parts && lane == __ffs(peers) - 1)
      atomicAdd(&blk[o], __popc(peers));
  }
  cluster.sync();
  if (threadIdx.x < parts) {
    int32_t before = 0, tot = 0;
    for (unsigned k = 0; k < nb; ++k) {
      const int32_t c = cluster.map_shared_rank(blk, k)[threadIdx.x];
      before += k < b ? c : 0;
      tot += c;
    }
    run[threadIdx.x] = before;
    total[threadIdx.x] = tot;
  }
  cluster.sync();  // no block leaves while another reads its counts
  const unsigned lower = (1u << lane) - 1u;
  for (int64_t base = lo; base < hi; base += kCThreads) {
    (&wcnt[0][0])[threadIdx.x] = 0;
    __syncthreads();
    const int64_t i = base + threadIdx.x;
    const int32_t id = i < hi ? __ldg(ids + i) : kEmpty;
    const int32_t o = i < hi ? owner_of(id, parts, hot_limit) : parts;
    const unsigned peers = __match_any_sync(kFull, o);
    if (o < parts && (peers & lower) == 0) wcnt[warp][o] = __popc(peers);
    __syncthreads();
    if (i < hi) {
      bool ok = false;
      int64_t slot = 0;
      if (o < parts) {
        int64_t rank = run[o] + __popc(peers & lower);
        for (int w = 0; w < warp; ++w) rank += wcnt[w][o];
        ok = rank < seg_cap;
        slot = (int64_t)o * seg_cap + rank;
      }
      if (ok) send[slot] = id;
      pick[i] = ok ? (int32_t)slot : kEmpty;
    }
    __syncthreads();
    if (threadIdx.x < parts) {
      int32_t add = 0;
      for (int w = 0; w < kCWarps; ++w) add += wcnt[w][threadIdx.x];
      run[threadIdx.x] += add;
    }
    __syncthreads();  // before the next round clears wcnt
  }
  const int64_t step = (int64_t)nb * kCThreads;
  for (int o = 0; o < parts; ++o) {
    int32_t* row = send + (int64_t)o * seg_cap;
    for (int64_t k = min((int64_t)total[o], seg_cap) + b * kCThreads +
                     threadIdx.x;
         k < seg_cap; k += step)
      row[k] = kEmpty;
  }
  if (b == 0 && threadIdx.x == 0) {
    bool any = false;
    for (int o = 0; o < parts; ++o) any |= total[o] > seg_cap;
    *overflow = any;
  }
}
#endif

}  // namespace

// The int32 words of xg_plan_exchange's buffer for n ids over parts owners
// and seg_cap slots an owner: send, pick (each padded to 16 bytes), the
// overflow byte's 16 bytes, then the scratch (the ticket, and a 64-bit
// status word a tile and owner).
struct PlanLayout {
  int64_t pick, flag, scratch, scratch_bytes, words;
};

PlanLayout plan_layout(int64_t n, int parts, int64_t seg_cap) {
  PlanLayout c;
  const int64_t tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  c.pick = ((int64_t)parts * seg_cap + 3) / 4 * 4;
  c.flag = c.pick + (n + 3) / 4 * 4;
  c.scratch = c.flag + 4;
  c.scratch_bytes = 8 + tiles * parts * 8;
  c.words = c.scratch + c.scratch_bytes / 4;
  return c;
}

extern "C" long long xg_plan_buffer_words(long long n, int parts,
                                          long long seg_cap) {
  return plan_layout(n, parts, seg_cap).words;
}

// ids: (n,) int32; hot_limit: ids at or past it are not sent (EMPTY in
// pick; 2^31 - 1 sends every valid id); buf: xg_plan_buffer_words(n,
// parts, seg_cap) int32 words, 16-byte aligned: send ((parts, seg_cap)
// int32), pick ((n,) int32) and the overflow byte (a bool) written, the
// scratch zeroed here.  1 <= parts <= 32 and seg_cap >= 1.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, launching
// nothing, for sizes it does not take).
extern "C" int xg_plan_exchange(const void* ids, long long n, int parts,
                                long long hot_limit, long long seg_cap,
                                void* buf, void* stream) {
  if (parts < 1 || parts > kMaxParts || seg_cap < 1 || n < 0 ||
      n >= (1LL << 31) || seg_cap > (long long)0x7fffffff / parts ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const PlanLayout c = plan_layout(n, parts, seg_cap);
  const int32_t* in = static_cast<const int32_t*>(ids);
  int32_t* sd = static_cast<int32_t*>(buf);
  int32_t* pk = sd + c.pick;
  uint8_t* of = reinterpret_cast<uint8_t*>(sd + c.flag);
#ifdef XG_PLAN_CLUSTER
  cudaFuncSetAttribute(plan_exchange_cluster_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks);
  cfg.blockDim = dim3(kCThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterBlocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, plan_exchange_cluster_kernel, in, (int64_t)n,
                     parts, (int64_t)hot_limit, (int64_t)seg_cap, sd, pk,
                     of);
#else
  const int64_t tiles = n > 0 ? (n + kTile - 1) / kTile : 1;
  uint8_t* scratch = reinterpret_cast<uint8_t*>(sd + c.scratch);
  cudaMemsetAsync(scratch, 0, (size_t)c.scratch_bytes, s);
  plan_exchange_kernel<<<(unsigned)tiles, kThreads, 0, s>>>(
      in, n, parts, hot_limit, seg_cap, tiles, sd, pk, of,
      reinterpret_cast<unsigned long long*>(scratch + 8),
      reinterpret_cast<unsigned*>(scratch));
#endif
  return (int)cudaGetLastError();
}
