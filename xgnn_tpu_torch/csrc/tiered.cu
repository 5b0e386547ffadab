// K11: tiered extract, the hot rows from the cache in device memory and the
// cold rows read by the SMs in place from the pinned, mapped host table.
//
//   for i < num_input, id = ids[i] in [0, num_node):
//     s = posmap[id];  out[i] = s != EMPTY ? cache[s] : host[id]
//   every other row of out (EMPTY or out-of-range ids, i >= num_input) is 0;
//   counts[0] = the hits, counts[1] = the misses (exact int32).
// With no posmap (the all-miss form) every valid id is a miss: the cache's
// own rows are built that way.  The host table is the dataset's float32 or
// float16 (an F16 feature file); the cache and out are of the host's type,
// or bfloat16 under feat_dtype="bfloat16": then a miss row is rounded to
// bfloat16 (to nearest, ties to even, as JAX's astype and PyTorch's .to
// round; a float16 widened exactly first) as the SMs write it, and its
// bytes over PCIe stay the host's, as in JAX's store.
//
// Replaces: xgnn_tpu/store/feature_store.py, _split_kernel (the posmap
// lookup, the hit/miss split and the stable compaction of the miss
// positions and ids, compact_mask_positions of xgnn_tpu/ops/unique.py:27),
// the host gather of the miss rows (cpp/hostgather.cpp), their
// host-to-device copy and _combine_kernel (their scatter into place),
// driven by TieredFeatureSource.extract.  On the TPU they were XLA ops and a
// host gather, not a Pallas kernel: a TPU cannot read host memory, so its
// store moves the miss ids to the host and the rows back.  An H100 reads
// pinned, mapped host memory from a kernel, as the reference system's
// zero-copy GPUExtractMissData does, so the miss rows are read where they
// are and nothing waits on the host.  Two steps, both on the caller's
// stream:
//
//   1. split (xg_tiered_split; three launches: count, scan, write).  A
//      block takes a tile of kTile ids.  count: each warp looks up 32 ids a
//      step and counts hits and misses by ballots; a block sum gives the
//      tile's misses, and two atomics a block the exact counts.  scan: one
//      block scans the tiles' miss counts into offsets.  write: each tile
//      looks its ids up again, ranks its misses in position order (a ballot
//      a warp, the warps' counts in shared memory), writes miss_pos and
//      miss_ids from its offset on, and copies the hit rows from the cache
//      (kUnroll rows a warp at a time, every load before any store) and
//      zero rows for invalid and dead slots.  A miss row of out is left for
//      step 2.
//      The position form (xg_tiered_split_positions) writes each slot's
//      cache position (posmap[id] on a hit, EMPTY elsewhere) where the row
//      form copies rows, and writes no rows.  It replaces the posmap lookup
//      and the miss compaction of cache_split
//      (xgnn_tpu/parallel/ggms.py:134-203), whose hits the owner exchange
//      then serves over cache positions.  It is one memset and one pass
//      (split_positions_kernel: a ticket, a decoupled look-back over the
//      tiles' miss counts, each posmap word read once), where the row form
//      keeps its three launches.
//   2. direct (xg_tiered_direct): out[miss_pos[j]] = host[miss_ids[j]] for
//      j < counts[1], the count read on the device: a warp reads kUnroll
//      rows at once from the mapped table over PCIe, on a persistent grid
//      of a quarter of the multiprocessors.  PCIe, not the SMs, sets its
//      rate, and the training step that runs beside it on the other stream
//      keeps the SMs it leaves.
//
// What bounds it on an H100: bytes, over two links.  The miss rows cross
// PCIe (Gen5 x16: 63.0 GB/s a direction after its line code); the hit rows,
// the ids, the posmap words and the output move in HBM at 3.35 TB/s.  At
// the main path's shape (2,449,152 ids, about 2.1M valid, 20% of the rows
// cached) the PCIe side, about 1.65M rows of 512 bytes, is the bound.  The
// SMs' loads of mapped memory read it at 24-28 GB/s, where the copy
// engine's pinned copy_ moves about 48 GB/s; but a copy needs the rows
// gathered on the host first, and the card's 8-core hosts gather them more
// slowly than the SMs read them, with the cores the training loop needs
// (tools/time_tiered.py, NVIDIA H100 80GB HBM3, 700 W).  Neither more rows
// in flight, other load flavours, fewer blocks nor sorted ids moved the
// SMs' rate by more than the spread.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileIters = 8;
constexpr int kTile = kThreads * kTileIters;  // ids a block of the split
constexpr int kScanThreads = 1024;
constexpr int kUnroll = 8;  // the rows a warp copies at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kEmpty = INT32_MAX;
constexpr int kZero = 0, kHit = 1, kMiss = 2;

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
template <>
__device__ __forceinline__ uint16_t zero_word<uint16_t>() {
  return 0u;
}

// A host-table slice In as out's slice Out: the same words, or float32
// rounded to bfloat16 (to nearest, ties to even)
template <typename In, typename Out>
struct Narrow {
  static __device__ __forceinline__ Out run(In v) { return v; }
};
template <>
struct Narrow<float4, uint2> {
  static __device__ __forceinline__ uint2 run(float4 v) {
    const __nv_bfloat162 a = __float22bfloat162_rn(make_float2(v.x, v.y));
    const __nv_bfloat162 b = __float22bfloat162_rn(make_float2(v.z, v.w));
    return make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                      *reinterpret_cast<const uint32_t*>(&b));
  }
};
template <>
struct Narrow<float, uint16_t> {
  static __device__ __forceinline__ uint16_t run(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// 4 and 1 float16 of a host row, read as such (a copy moves raw words)
struct Half4 {
  uint2 bits;
};
struct Half1 {
  uint16_t bits;
};

__device__ __forceinline__ float f16_bits(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)(b & 0xffffu)));
}

// float16 widened exactly, then rounded to bfloat16 as float32 rounds
template <>
struct Narrow<Half4, uint2> {
  static __device__ __forceinline__ uint2 run(Half4 h) {
    return Narrow<float4, uint2>::run(
        make_float4(f16_bits(h.bits.x), f16_bits(h.bits.x >> 16),
                    f16_bits(h.bits.y), f16_bits(h.bits.y >> 16)));
  }
};
template <>
struct Narrow<Half1, uint16_t> {
  static __device__ __forceinline__ uint16_t run(Half1 h) {
    return Narrow<float, uint16_t>::run(f16_bits(h.bits));
  }
};

__device__ __forceinline__ int64_t live_count(const int32_t* num_input,
                                              int64_t n) {
  return min(n, (int64_t)max(*num_input, 0));
}

// kZero (dead slot, EMPTY or out-of-range id), kHit or kMiss
__device__ __forceinline__ int classify(const int32_t* __restrict__ ids,
                                        int64_t i, int64_t live,
                                        const int32_t* __restrict__ posmap,
                                        int64_t num_node, int32_t& id,
                                        int32_t& slot) {
  id = kEmpty;
  slot = kEmpty;
  if (i >= live) return kZero;
  id = __ldg(ids + i);
  if (id < 0 || (int64_t)id >= num_node) return kZero;
  if (posmap == nullptr) return kMiss;
  slot = __ldg(posmap + id);
  return slot != kEmpty ? kHit : kMiss;
}

__global__ void __launch_bounds__(kThreads)
split_count_kernel(const int32_t* __restrict__ ids, int64_t n,
                   const int32_t* __restrict__ num_input,
                   const int32_t* __restrict__ posmap, int64_t num_node,
                   int32_t* __restrict__ tiles, int32_t* __restrict__ counts) {
  __shared__ int s_hit[kWarps], s_miss[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t live = live_count(num_input, n);
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int hits = 0, misses = 0;
  for (int it = 0; it < kTileIters; ++it) {
    int32_t id, slot;
    const int k = classify(ids, base + it * kThreads + threadIdx.x, live,
                           posmap, num_node, id, slot);
    hits += __popc(__ballot_sync(kFull, k == kHit));
    misses += __popc(__ballot_sync(kFull, k == kMiss));
  }
  if (lane == 0) {
    s_hit[warp] = hits;
    s_miss[warp] = misses;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int h = 0, m = 0;
    for (int w = 0; w < kWarps; ++w) {
      h += s_hit[w];
      m += s_miss[w];
    }
    tiles[blockIdx.x] = m;
    if (h) atomicAdd(counts, h);
    if (m) atomicAdd(counts + 1, m);
  }
}

// tiles[t] = the misses of the tiles before t (one block, in place)
__global__ void __launch_bounds__(kScanThreads)
split_scan_kernel(int32_t* __restrict__ tiles, int64_t num_tiles) {
  __shared__ int s_warp[kScanThreads / 32];
  __shared__ int s_carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < num_tiles; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int v = i < num_tiles ? tiles[i] : 0;
    int x = v;  // inclusive scan within the warp
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = s_warp[lane];
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      s_warp[lane] = w;
    }
    __syncthreads();
    if (i < num_tiles)
      tiles[i] = s_carry + (warp > 0 ? s_warp[warp - 1] : 0) + x - v;
    __syncthreads();
    if (threadIdx.x == 0) s_carry += s_warp[kScanThreads / 32 - 1];
    __syncthreads();
  }
}

// The warp's 32 rows from row0 on: row r is written where bit r of `write`
// is set, from the address lane r holds in `src` (a zero row for null)
template <typename Word>
__device__ __forceinline__ void copy_rows(const Word* src, unsigned write,
                                          int64_t row0, int64_t width,
                                          Word* __restrict__ out, int lane) {
  const unsigned long long mine = reinterpret_cast<unsigned long long>(src);
  for (int r0 = 0; r0 < 32; r0 += kUnroll) {
    const unsigned group = (write >> r0) & ((1u << kUnroll) - 1u);
    if (group == 0) continue;  // the same for the whole warp
    const Word* s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      s[u] = reinterpret_cast<const Word*>(__shfl_sync(kFull, mine, r0 + u));
    for (int64_t col = lane; col < width; col += 32) {
      Word v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = s[u] != nullptr ? s[u][col] : zero_word<Word>();
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if ((group >> u) & 1u) out[(row0 + r0 + u) * width + col] = v[u];
    }
  }
}

// Word is uint4, uint32_t or uint16_t, width the row's length in Words.
template <typename Word>
__global__ void __launch_bounds__(kThreads)
split_write_kernel(const int32_t* __restrict__ ids, int64_t n,
                   const int32_t* __restrict__ num_input,
                   const int32_t* __restrict__ posmap, int64_t num_node,
                   const Word* __restrict__ cache, int64_t width,
                   Word* __restrict__ out, const int32_t* __restrict__ tiles,
                   int32_t* __restrict__ miss_pos,
                   int32_t* __restrict__ miss_ids) {
  __shared__ int s_miss[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t live = live_count(num_input, n);
  const int64_t base = (int64_t)blockIdx.x * kTile;
  int running = tiles[blockIdx.x];
  for (int it = 0; it < kTileIters; ++it) {
    const int64_t row0 = base + it * kThreads + warp * 32;
    const int64_t i = row0 + lane;
    int32_t id, slot;
    const int k = classify(ids, i, live, posmap, num_node, id, slot);
    const unsigned miss = __ballot_sync(kFull, k == kMiss);
    const unsigned write = __ballot_sync(kFull, k != kMiss && i < n);
    if (lane == 0) s_miss[warp] = __popc(miss);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_miss[w];
      before += w < warp ? c : 0;
      total += c;
    }
    if (k == kMiss) {
      const int r = running + before + __popc(miss & ((1u << lane) - 1u));
      miss_pos[r] = (int32_t)i;
      miss_ids[r] = id;
    }
    running += total;
    copy_rows<Word>(k == kHit ? cache + (int64_t)slot * width : nullptr,
                    write, row0, width, out, lane);
    __syncthreads();  // s_miss is rewritten next step
  }
}

// The position form in one pass (decoupled look-back, as K13-plan's in
// csrc/exchange.cu).  A block takes the next tile of kPosTile ids from an
// atomic ticket, so a look-back only waits on a tile whose block already
// runs.  Each thread loads its kPosIters ids, then their posmap words (each
// read once; every load in flight before the first ballot), writes pos,
// and counts each (iteration, warp)'s hits and misses by ballots into
// shared memory, packed hits << 16 | misses (a tile's counts fit 16
// bits).  Warp 0 scans the counts, publishes the tile's (hits, misses) in
// a 64-bit status word (flag AGG, then INC with its inclusive prefix: hits
// << 31 | misses, flag in the top two bits, the sums never carry) and
// looks back a lane an earlier tile, 32 tiles a step, to the nearest INC.
// The tile then writes its misses' positions and ids from the misses
// before it on, in position order; the last tile writes counts from its
// inclusive prefix.  The status words and the ticket are zeroed by the
// call's one memset.  XG_POS_ITERS (a variant for xgnn_tpu_torch/tools/
// time_tiered.py) sets the ids a thread.  On graphsage_cached's batch
// (2,449,152 ids, 2,120,830 valid; time_tiered.py --positions, NVIDIA H100
// 80GB HBM3, 700.00 W, in turns): 0.0276 device ms, a memset of 1.1 us and
// a kernel of 23.0 us, against the three launches' 0.0341 (count 10.8,
// scan 2.5, write 15.5 us); tiles of 4,096 and 8,192 ids 0.0284 and 0.0283;
// on its first 8,000 ids 0.0093 against 0.0193.  The bound (the ids and
// pos once, a posmap word a valid id, the miss lists) is 0.0123.
#ifndef XG_POS_ITERS
#define XG_POS_ITERS 8
#endif
constexpr int kPosIters = XG_POS_ITERS;
constexpr int kPosTile = kThreads * kPosIters;  // ids a tile
constexpr int kPosSlots = kPosIters * kWarps;  // (iteration, warp) counts
constexpr int kPosPerLane = kPosSlots / 32;    // the scan's counts a lane
constexpr unsigned long long kPosAgg = 1ull << 62;
constexpr unsigned long long kPosInc = 2ull << 62;
constexpr unsigned long long kPosFlags = 3ull << 62;
constexpr unsigned long long kPosMisses = (1ull << 31) - 1ull;
static_assert(kPosSlots % 32 == 0 && kPosTile < 65536,
              "warp 0 scans the counts; a tile's counts fit 16 bits");

__global__ void __launch_bounds__(kThreads)
split_positions_kernel(const int32_t* __restrict__ ids, int64_t n,
                       const int32_t* __restrict__ num_input,
                       const int32_t* __restrict__ posmap, int64_t num_node,
                       int32_t* __restrict__ pos, int32_t* __restrict__ counts,
                       int32_t* __restrict__ miss_pos,
                       int32_t* __restrict__ miss_ids, int64_t tiles,
                       unsigned long long* status, unsigned* ticket) {
  __shared__ int32_t cnt[kPosSlots];
  __shared__ unsigned s_tile;
  __shared__ long long s_before;  // the misses of the earlier tiles
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1u);
  __syncthreads();
  const int64_t t = s_tile;
  const int64_t live = live_count(num_input, n);
  const int64_t base = t * kPosTile;
  int32_t id[kPosIters], slot[kPosIters];
  bool ok[kPosIters];  // a live slot's valid id: looked up
#pragma unroll
  for (int it = 0; it < kPosIters; ++it) {
    const int64_t i = base + it * kThreads + threadIdx.x;
    id[it] = i < live ? __ldg(ids + i) : kEmpty;
  }
#pragma unroll
  for (int it = 0; it < kPosIters; ++it) {
    ok[it] = id[it] >= 0 && (int64_t)id[it] < num_node;
    slot[it] = ok[it] ? __ldg(posmap + id[it]) : kEmpty;
  }
  unsigned miss[kPosIters];
#pragma unroll
  for (int it = 0; it < kPosIters; ++it) {
    const int64_t i = base + it * kThreads + threadIdx.x;
    const bool hit = ok[it] && slot[it] != kEmpty;
    if (i < n) pos[i] = hit ? slot[it] : kEmpty;
    miss[it] = __ballot_sync(kFull, ok[it] && slot[it] == kEmpty);
    const unsigned hits = __ballot_sync(kFull, hit);
    if (lane == 0)
      cnt[it * kWarps + warp] = (__popc(hits) << 16) | __popc(miss[it]);
  }
  __syncthreads();
  if (warp == 0) {
    int32_t c[kPosPerLane], sum = 0;
#pragma unroll
    for (int k = 0; k < kPosPerLane; ++k) {
      c[k] = cnt[lane * kPosPerLane + k];
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
    for (int k = 0; k < kPosPerLane; ++k) {
      cnt[lane * kPosPerLane + k] = run;
      run += c[k];
    }
    const int32_t tot = __shfl_sync(kFull, incl, 31);
    const unsigned long long mine =
        ((unsigned long long)(tot >> 16) << 31) | (unsigned)(tot & 0xffff);
    volatile unsigned long long* st = status;
    if (lane == 0) st[t] = (t == 0 ? kPosInc : kPosAgg) | mine;
    unsigned long long before = 0;
    for (int64_t j0 = t - 1; j0 >= 0; j0 -= 32) {
      const int64_t j = j0 - lane;
      unsigned long long w = 0;
      if (j >= 0) {
        do {
          w = st[j];
        } while ((w & kPosFlags) == 0);
      }
      // the nearest inclusive prefix in the window ends the sum there
      const unsigned inc = __ballot_sync(kFull, (w & kPosFlags) == kPosInc);
      const int stop = inc ? __ffs(inc) - 1 : 31;
      unsigned long long v = lane <= stop ? (w & ~kPosFlags) : 0ull;
#pragma unroll
      for (int d = 16; d >= 1; d >>= 1) v += __shfl_down_sync(kFull, v, d);
      before += __shfl_sync(kFull, v, 0);
      if (inc) break;
    }
    const unsigned long long incl_all = before + mine;
    if (lane == 0) {
      if (t > 0) st[t] = kPosInc | incl_all;
      s_before = (long long)(before & kPosMisses);
      if (t == tiles - 1) {
        counts[0] = (int32_t)(incl_all >> 31);
        counts[1] = (int32_t)(incl_all & kPosMisses);
      }
    }
  }
  __syncthreads();
  const long long before = s_before;
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kPosIters; ++it) {
    if ((miss[it] >> lane) & 1u) {
      const int64_t r = before + (cnt[it * kWarps + warp] & 0xffff) +
                        __popc(miss[it] & lower);
      miss_pos[r] = (int32_t)(base + it * kThreads + threadIdx.x);
      miss_ids[r] = id[it];
    }
  }
}

// the position form's scratch: the ticket's 8 bytes, a status word a tile
long long positions_scratch_bytes(long long n) {
  return 8 + 8 * ((n + kPosTile - 1) / kPosTile);
}

// Step 2: out[pos[j]] = table[ids[j]] for j < *count; a warp moves kUnroll
// rows at once, every load before any store.  In is the table's slice
// (uint4, uint32_t or uint16_t words copied as they are, or float4 and
// float, Half4 and Half1 read as float32 or float16), Out out's (the same
// words, or uint2 and uint16_t: the slice in bfloat16); width in slices.
template <typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
direct_kernel(const In* table, const int32_t* __restrict__ ids,
              const int32_t* __restrict__ pos,
              const int32_t* __restrict__ num_miss, int64_t width,
              Out* __restrict__ out, int64_t n) {
  const int64_t count = min(n, (int64_t)max(*num_miss, 0));
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t j0 = warp * kUnroll; j0 < count; j0 += warps * kUnroll) {
    int64_t dst[kUnroll];
    const In* src[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = j0 + u;
      const int64_t p = j < count ? (int64_t)__ldg(pos + j) : -1;
      dst[u] = p >= 0 && p < n ? p : -1;
      src[u] = table + (dst[u] < 0 ? 0 : (int64_t)__ldg(ids + j)) * width;
    }
    for (int64_t col = lane; col < width; col += 32) {
      In v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (dst[u] >= 0) v[u] = src[u][col];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (dst[u] >= 0)
          out[dst[u] * width + col] = Narrow<In, Out>::run(v[u]);
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename Word>
void launch_write(const int32_t* id, long long n, const int32_t* num,
                  const int32_t* pm, long long num_node, const void* cache,
                  long long width, void* out, const int32_t* tile,
                  int32_t* mp, int32_t* mi, long long num_tiles,
                  cudaStream_t s) {
  split_write_kernel<Word><<<(unsigned)num_tiles, kThreads, 0, s>>>(
      id, n, num, pm, num_node, static_cast<const Word*>(cache), width,
      static_cast<Word*>(out), tile, mp, mi);
}

// The split's first two launches: the exact counts (zeroed first) and each
// tile's misses, then the tiles' offsets
cudaError_t split_count_scan(const int32_t* id, long long n,
                             const int32_t* num, const int32_t* pm,
                             long long num_node, int32_t* counts,
                             int32_t* tile, long long num_tiles,
                             cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(counts, 0, 2 * sizeof(int32_t), s);
  if (e != cudaSuccess) return e;
  split_count_kernel<<<(unsigned)num_tiles, kThreads, 0, s>>>(
      id, n, num, pm, num_node, tile, counts);
  split_scan_kernel<<<1, kScanThreads, 0, s>>>(tile, num_tiles);
  return cudaSuccess;
}

template <typename In, typename Out>
void launch_direct(const void* table, const int32_t* ids, const int32_t* pos,
                   const int32_t* num, long long width, void* out,
                   long long n, long long grid, cudaStream_t s) {
  direct_kernel<In, Out><<<(unsigned)grid, kThreads, 0, s>>>(
      static_cast<const In*>(table), ids, pos, num, width,
      static_cast<Out*>(out), n);
}

}  // namespace

// The registrations of this process, by host address: a count of the
// MappedHostTensors over each range, so that a second one over the same
// memory (two trainers' stores of one process, or two tables over one shared
// mapping) neither registers it again (cudaErrorHostMemoryAlreadyRegistered)
// nor unregisters it under the first.
struct Registration {
  long long bytes;
  int read_only;
  int count;
};
static std::mutex g_reg_lock;
static std::map<void*, Registration> g_regs;

// Pin `bytes` of host memory at `host` and map it, for every device of the
// process (cudaHostRegisterPortable | cudaHostRegisterMapped, and
// cudaHostRegisterReadOnly where `read_only`: memory mapped without write
// access, which only that flag registers); `device`'s address of it goes to
// *dev_ptr (dev_ptr: the address of a void*).  Memory registered already is
// counted, not registered again; its range and access must be the first
// registration's.  Returns the first CUDA error, cudaErrorNotSupported where
// `read_only` is asked of a device that cannot register read-only memory
// (nothing stays registered after a failure, and the error is cleared, so
// the next launch's check does not report it again).
extern "C" int xg_host_map(void* host, long long bytes, int device,
                           int read_only, void* dev_ptr) {
  if (bytes <= 0 || host == nullptr || dev_ptr == nullptr)
    return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> guard(g_reg_lock);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && read_only) {
    int ok = 0;
    e = cudaDeviceGetAttribute(&ok, cudaDevAttrHostRegisterReadOnlySupported,
                               device);
    if (e == cudaSuccess && !ok) return (int)cudaErrorNotSupported;
  }
  auto it = g_regs.find(host);
  const bool fresh = it == g_regs.end();
  if (e == cudaSuccess && !fresh &&
      (it->second.bytes != bytes || it->second.read_only != read_only))
    return (int)cudaErrorHostMemoryAlreadyRegistered;
  if (e == cudaSuccess && fresh) {
    unsigned flags = cudaHostRegisterPortable | cudaHostRegisterMapped;
    if (read_only) flags |= cudaHostRegisterReadOnly;
    e = cudaHostRegister(host, (size_t)bytes, flags);
  }
  if (e == cudaSuccess) {
    e = cudaHostGetDevicePointer(static_cast<void**>(dev_ptr), host, 0);
    if (e != cudaSuccess && fresh) cudaHostUnregister(host);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (fresh)
    g_regs[host] = Registration{bytes, read_only, 1};
  else
    ++it->second.count;
  return 0;
}

// One registration of `host` less; the last unregisters it.
extern "C" int xg_host_unmap(void* host, int device) {
  std::lock_guard<std::mutex> guard(g_reg_lock);
  auto it = g_regs.find(host);
  if (it == g_regs.end()) return (int)cudaErrorHostMemoryNotRegistered;
  if (--it->second.count > 0) return 0;
  g_regs.erase(it);
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaHostUnregister(host);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

// How many MappedHostTensors hold the registration at `host` (0: none).
extern "C" int xg_host_map_count(void* host) {
  std::lock_guard<std::mutex> guard(g_reg_lock);
  auto it = g_regs.find(host);
  return it == g_regs.end() ? 0 : it->second.count;
}

// Step 1.  ids: (n,) int32; num_input: a device int32 scalar; posmap:
// (num_node,) int32 cache slots, EMPTY where not cached, or null (all
// miss); cache: (num_cache, width) elements of elem_bytes (4: float32, 2:
// bfloat16; unused when posmap is null); out: (n, width) of the same
// elements, its miss rows left as they are; counts: 2 int32
// (hits, misses), zeroed here; tiles: ceil(n / kTile) int32 scratch;
// miss_pos, miss_ids: (n,) int32, their first `misses` entries written.
// Returns cudaGetLastError() after the launches.
extern "C" int xg_tiered_split(const void* ids, long long n,
                               const void* num_input, const void* posmap,
                               long long num_node, const void* cache,
                               long long width, int elem_bytes, void* out,
                               void* counts, void* tiles, void* miss_pos,
                               void* miss_ids, void* stream) {
  if (n <= 0 || n > INT32_MAX || width <= 0 || num_node < 0 ||
      num_node > INT32_MAX || counts == nullptr ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* id = static_cast<const int32_t*>(ids);
  const int32_t* num = static_cast<const int32_t*>(num_input);
  const int32_t* pm = static_cast<const int32_t*>(posmap);
  int32_t* tile = static_cast<int32_t*>(tiles);
  int32_t* mp = static_cast<int32_t*>(miss_pos);
  int32_t* mi = static_cast<int32_t*>(miss_ids);
  const long long num_tiles = (n + kTile - 1) / kTile;
  cudaError_t e = split_count_scan(id, n, num, pm, num_node,
                                   static_cast<int32_t*>(counts), tile,
                                   num_tiles, s);
  if (e != cudaSuccess) return (int)e;
  // the widest word that divides a row and both tables' alignment
  const long long row_bytes = width * elem_bytes;
  auto fits = [&](int bytes) {
    return row_bytes % bytes == 0 && aligned(out, bytes) &&
           (posmap == nullptr || aligned(cache, bytes));
  };
  if (fits(16))
    launch_write<uint4>(id, n, num, pm, num_node, cache, row_bytes / 16, out,
                        tile, mp, mi, num_tiles, s);
  else if (fits(4))
    launch_write<uint32_t>(id, n, num, pm, num_node, cache, row_bytes / 4,
                           out, tile, mp, mi, num_tiles, s);
  else
    launch_write<uint16_t>(id, n, num, pm, num_node, cache, row_bytes / 2,
                           out, tile, mp, mi, num_tiles, s);
  return (int)cudaGetLastError();
}

// Step 1's position form.  As xg_tiered_split, with a posmap (not null) and
// no cache: pos, (n,) int32, gets posmap[id] for each hit and EMPTY for a
// miss, an invalid id and a dead slot; no rows are written.  scratch:
// xg_tiered_positions_scratch_bytes(n) bytes, 8-byte aligned (the ticket
// and the tiles' status words), zeroed here by one memset; then one
// launch.  Returns cudaGetLastError() after the launch.
extern "C" int xg_tiered_split_positions(const void* ids, long long n,
                                         const void* num_input,
                                         const void* posmap,
                                         long long num_node, void* pos,
                                         void* counts, void* scratch,
                                         void* miss_pos, void* miss_ids,
                                         void* stream) {
  if (n <= 0 || n > INT32_MAX || num_node < 0 || num_node > INT32_MAX ||
      posmap == nullptr || pos == nullptr || counts == nullptr ||
      scratch == nullptr || !aligned(scratch, 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long num_tiles = (n + kPosTile - 1) / kPosTile;
  cudaError_t e = cudaMemsetAsync(
      scratch, 0, (size_t)positions_scratch_bytes(n), s);
  if (e != cudaSuccess) return (int)e;
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  split_positions_kernel<<<(unsigned)num_tiles, kThreads, 0, s>>>(
      static_cast<const int32_t*>(ids), n,
      static_cast<const int32_t*>(num_input),
      static_cast<const int32_t*>(posmap), num_node,
      static_cast<int32_t*>(pos), static_cast<int32_t*>(counts),
      static_cast<int32_t*>(miss_pos), static_cast<int32_t*>(miss_ids),
      num_tiles, reinterpret_cast<unsigned long long*>(sc + 8),
      reinterpret_cast<unsigned*>(sc));
  return (int)cudaGetLastError();
}

// The bytes of xg_tiered_split_positions's scratch for n ids
extern "C" long long xg_tiered_positions_scratch_bytes(long long n) {
  return positions_scratch_bytes(n);
}

// Step 2.  table: the device address of the mapped (num_node, width) host
// table of host_bytes elements (4: float32, 2: float16); miss_ids,
// miss_pos: (n,) int32, the split's lists; num_miss: a device int32 scalar
// (the split's counts[1]); out: (n, width) of the table's elements, or with
// out_bf16 bfloat16, each element rounded from the table's.  Returns
// cudaGetLastError() after the launch.
extern "C" int xg_tiered_direct(const void* table, long long width,
                                const void* miss_ids, const void* miss_pos,
                                const void* num_miss, void* out, long long n,
                                int host_bytes, int out_bf16, void* stream) {
  if (n <= 0 || width <= 0 || table == nullptr || miss_ids == nullptr ||
      miss_pos == nullptr || num_miss == nullptr || out == nullptr ||
      (host_bytes != 2 && host_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long per_block = (long long)kWarps * kUnroll;
  const long long grid = std::max(
      1ll, std::min((n + per_block - 1) / per_block, (long long)sms / 4));
  const int32_t* ids = static_cast<const int32_t*>(miss_ids);
  const int32_t* pos = static_cast<const int32_t*>(miss_pos);
  const int32_t* num = static_cast<const int32_t*>(num_miss);
  if (out_bf16) {
    // 4 elements a slice where the row and both tables allow it
    const bool vec = width % 4 == 0 && aligned(table, 4 * host_bytes) &&
                     aligned(out, 8);
    if (host_bytes == 4 && vec)
      launch_direct<float4, uint2>(table, ids, pos, num, width / 4, out, n,
                                   grid, s);
    else if (host_bytes == 4)
      launch_direct<float, uint16_t>(table, ids, pos, num, width, out, n,
                                     grid, s);
    else if (vec)
      launch_direct<Half4, uint2>(table, ids, pos, num, width / 4, out, n,
                                  grid, s);
    else
      launch_direct<Half1, uint16_t>(table, ids, pos, num, width, out, n,
                                     grid, s);
    return (int)cudaGetLastError();
  }
  // a copy: the widest word that divides a row and both tables' alignment
  const long long row_bytes = width * host_bytes;
  auto fits = [&](int bytes) {
    return row_bytes % bytes == 0 && aligned(table, bytes) &&
           aligned(out, bytes);
  };
  if (fits(16))
    launch_direct<uint4, uint4>(table, ids, pos, num, row_bytes / 16, out, n,
                                grid, s);
  else if (fits(4))
    launch_direct<uint32_t, uint32_t>(table, ids, pos, num, row_bytes / 4,
                                      out, n, grid, s);
  else
    launch_direct<uint16_t, uint16_t>(table, ids, pos, num, row_bytes / 2,
                                      out, n, grid, s);
  return (int)cudaGetLastError();
}
