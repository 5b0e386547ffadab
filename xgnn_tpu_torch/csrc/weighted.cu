// K8b: weighted neighbour sampling, by prefix-sum search (weighted_khop_prefix)
// and by alias tables (weighted_khop, and weighted_khop_hash_dedup).
//
// Every kernel reads a frontier row v = frontier[b] as K2 does: start =
// indptr[v], deg = indptr[v+1] - start, and deg = 0 for EMPTY and for any id
// outside [0, num_node).  A row of degree 0 is all EMPTY.  Offsets into the
// edge arrays are 64-bit (K8b-prefix keeps a pick's edge position in 32
// bits: indptr is int32, so each fits).  Built without --use_fast_math;
// every float product is __fmul_rn, so it is never fused into anything.
//
// K8b-prefix (xg_sample_prefix):
// For pick k of a row, x = u[b,k] * total with total = prefix[start+deg-1],
// one float32 product rounded to nearest.  The offset is the smallest off with
// prefix[start+off] > x, clamped to deg - 1; out[b,k] = indices[start+off].
// The rows of prefix are nondecreasing (the wrapper states it), so that
// offset is min(#{j < deg : prefix[start+j] <= x}, deg - 1).
//
// Replaces: xgnn_tpu/ops/sampling.py, sample_weighted_khop_prefix (lines
// 339-424), a fixed-depth binary search, or a coarse-CDF bucket, binary
// steps and a tile-pair count, each step a 512-byte tile gather a pick.  The
// picks equal it bit for bit for the same u on nondecreasing rows.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// dependent reads frontier -> indptr -> prefix -> indices.  A row of the
// products graph holds 50.6 entries on average (202 bytes).  With a warp a
// row, each row waited out four round trips to memory, one after another
// (0.379 ms for 1,007,360 rows, NVIDIA H100 80GB HBM3, 700 W).
//
// Design: a warp takes a run of up to 32 rows (fewer where the frontier
// would not fill the card's resident warps, and at most 512 picks) and
// issues each round trip for several rows at once:
// - lane i reads row i's frontier id, then its indptr pair, while the
//   run's uniforms are copied to shared memory (cp.async);
// - the rows' prefix reads are copied (cp.async, so no register waits on
//   them) into a ring of kDepth = 4 row slots in shared memory, 3 rows
//   ahead of the row being searched: a row of at most kDirectMax = 128
//   entries whole, a longer row (a hub) its coarse row, the 128 prefix
//   values at offsets e_j = ceil((j+1)*deg/128) - 1, 512 bytes shared by
//   the K picks (from coarse_cdf when the caller has it, else gathered
//   from prefix), and each row's total;
// - lane k searches pick k's offset in the row in shared memory (a search:
//   the rows are nondecreasing), or in a hub's coarse row its bucket
//   [e_{j-1} + 1, e_j], j the count of coarse values <= x clamped to 127,
//   at most ceil(deg/128) entries, which the warp then counts 32 at a
//   time, 8 picks' bucket reads issued together;
// - each pick's edge position replaces its uniform in shared memory, and
//   the run's index gathers go out together, stored in one coalesced pass.
// The coarse row of every row would cost 512 bytes where the mean row is
// 202: built with -DXG_PREFIX_DIRECT_MAX=0, every row goes that way, a
// design this one was measured against (xgnn_tpu_torch/tools/
// time_prefix.py, which also times other ring depths).
//
// K8b-alias (xg_sample_alias):
// A draw of a row of degree deg > 0 is slot = min(floor(u * deg), deg - 1)
// (the float32 product as in K2), e = start + slot, and the pick is
// alias[e] (a global id, never looked up in indices) when coin >= prob[e],
// else indices[e].
// - Without dedup (weighted_khop): out[b,k] is draw k; one thread per pick,
//   so u, coin and out move coalesced.
// - With dedup (weighted_khop_hash_dedup): `draws` = rounds * K draws a row,
//   and out[b] holds the first K distinct values in draw order, EMPTY after
//   them when fewer appear (the bounded-rounds deviation of PARITY.md).  A
//   row of deg <= K is the whole row in CSR order, EMPTY past deg.  The
//   draws are packed densely over a block's rows, a thread a draw (see
//   sample_alias_dedup_kernel), so u, coin and out move coalesced and a
//   block keeps kPer * 256 draws' reads in flight; a draw is a first
//   occurrence when no earlier draw of its row equals it (a scan in shared
//   memory), and its rank counts the earlier first occurrences by ballot
//   words.
//
// Replaces: xgnn_tpu/ops/sampling.py, sample_weighted_khop (lines 217-242)
// and sample_weighted_khop_hash_dedup (248-304, two lax.sort passes a row),
// bit for bit for the same u and coin.
//
// What bounds it: bytes.  A draw reads u, coin, prob and one of alias or
// indices (16 bytes); the alias and prob reads are random 4-byte reads, each
// a 32-byte sector, and the draws of one row share the row's sectors.  The
// dedup's scan is at most draws - 1 compares a draw, below the card's rate.
//
// The hash-dedup form's design.  The first design took a warp a row: at 20
// draws a row 12 of 32 lanes idled, at 40 and 60 a warp took two passes,
// each warp waited out frontier -> indptr -> prob -> alias with one row in
// flight, and shared memory held 256 draws a warp.  Packing the draws
// densely over a block's rows (2 draws a thread where the frontier still
// fills a wave of blocks, else 1) keeps a block's prob reads in flight
// together, then its alias or index reads, and writes out in one coalesced
// pass, a row of deg <= K among them.  At the main path's three frontiers
// walked by K2 and K3 (8,000 / 133,376 / 1,007,360 rows, 60 / 40 / 20
// draws; xgnn_tpu_torch/tools/time_samplers.py --only hash-dedup, NVIDIA
// H100 80GB HBM3, 700.00 W, medians of turns): 0.0167 / 0.1162 / 0.3578
// device ms against the warp-a-row kernel's 0.0308 / 0.2861 / 1.2271.  The
// variants beside it: 1, 2 or 4 draws a thread always (0.0166 / 0.1228 /
// 0.4025; 0.0178 / 0.1157 / 0.3592; 0.0189 / 0.1242 / 0.3641), lane groups
// of 16, 32 or a multiple of 64 slots a row (0.0161 / 0.1558 / 0.4824: the
// idle slots), and, in first builds since removed, a draw's alias and
// index read beside its prob read (0.0164 / 0.1282 / 0.3823: 1.5x the
// sectors for one round trip less) and a group of 32 lanes a row with
// several draws a lane (0.0297 / 0.2904 / 0.7916).
// Tiered, a cold row's reads are requests to host memory, each distinct
// sector of a warp instruction one, and the host answers a few hundred
// million a second: a row that straddles two warps is asked for twice, so
// the tiered instance takes lane groups (dedup_stride), and a cold row of
// K < deg <= its slots is read whole into shared memory, a coalesced read
// a table, before its draws (C0 in the kernel).  At 0.85 (the same
// frontiers, 1,168 / 18,584 / 143,826 cold rows; --tiered): 0.0763 /
// 1.3201 / 5.6357 device ms against 0.0909 / 1.5827 / 8.6097; without the
// staged rows 0.0958 / 1.5378 / 5.4910, packed densely 0.0901 / 1.4252 /
// 6.7839.
//
// The tiered topology (all three forms; tier.cuh): a cold row is read in
// place from the whole graph's CSR and the tables the form reads, in
// mapped host memory, in the same launch, with 64-bit offsets.  A cold
// row's draws are the hot rows' arithmetic on the same u and coin, so a
// tiered call picks what the untiered call over the whole CSR picks.  A
// host read is a PCIe round trip of a microsecond or more, and what bounds
// the cold rows is the rate at which the link and the host answer
// scattered reads, and the round trips a row waits out one after another.
//
// K8b-prefix takes a cold row through the ring as a hot row, in three
// dependent host round trips (its indptr pair, its row, its indices): its
// prefix entries (at most kDirectMax) or its coarse row (the 128 values at
// coarse_pos, gathered from the host prefix: the card's coarse CDF covers
// the hot rows only) are read kDepth - 1 rows ahead with plain loads, the
// lanes' reads of a row coalesced, and held in registers (host reads never
// go through cp.async) until the row's turn, when they are stored into its
// slot and searched there as a hot row's are (a hub's buckets then read
// from host memory: a fourth round trip).  Its picks' offsets (int32) take
// the slots as -2 - off, the row's 64-bit start stays in its lane, and the
// index reads join the run's batched gathers.  At layer 2 of the main
// path's batch at 0.85 (143,826 cold rows of 1,007,360, K = 5; NVIDIA H100
// 80GB HBM3, 700.00 W, xgnn_tpu_torch/tools/time_samplers.py --tiered) it
// takes 3.94-4.38 device ms against PR 17's 8.30-9.32 (a binary search
// over the host row, about log2(deg) + 2 dependent round trips a row),
// reading 1.76M distinct sectors at 400-450M a second, between the card's
// measured rates for scattered 32-byte and 128-byte mapped host reads
// (PERF.md section 6, PR 18).  At layer 1, where more rows are hubs, it
// is slower than PR 17's, 0.785 against 0.688: a cold hub's coarse row is
// 128 scattered reads where the search touched about 40.  The cold words'
// registers bring the tiered instance to 80 registers against 64 (3 blocks
// an SM); a cap at 64 spilled and was slower.  The alias forms read a cold
// row's tables in place as a hot row's: weighted_khop a thread a draw, the
// hash-dedup form a thread a draw in its row's lane group.  Each kernel is
// built twice, kTiered false (the untiered launch, no cold branch) and
// true.
//
// The cold form, for the partitioned topology's requesting rank: the same
// tiered kernels with no device CSR (indptr and the device tables null,
// num_node the hot prefix's size): a cold row gets its picks, every other
// row EMPTY, and no device row is read.
//
// Replaces, for the cold rows: xgnn_tpu/parallel/ggms.py, HostColdSampler
// (lines 264-453: its alias, hash-dedup and prefix draws) driven by
// cold_sample_callback (456-487), on the partitioned topology from
// xgnn_tpu/parallel/dist_topology.py:315-330.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tier.cuh"

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block of K8b-prefix
constexpr int kMaxFanout = 64;
constexpr int kLanes = 128;  // width of a coarse CDF row
constexpr int kChunks = kLanes / 32;
constexpr int kMaxDraws = 256;
constexpr int kRunPicks = 512;  // K8b-prefix's picks a warp a run
// the hash-dedup form: threads a block, and the most rows a block takes
constexpr int kDedupThreads = 256;
constexpr int kDedupMaxRows = 256;
// Variants of the hash-dedup form, built by xgnn_tpu_torch/tools/
// time_samplers.py only: XG_DEDUP_PER fixes the draws a thread (1, 2 or
// 4; 0 chooses at launch); XG_DEDUP_LAYOUT 1 gives every instance lane
// groups, 2 packs every instance densely (0: dedup_stride's choice);
// XG_DEDUP_STAGE 0 reads every cold draw's entries one by one (see
// sample_alias_dedup_kernel's C0).
#ifndef XG_DEDUP_PER
#define XG_DEDUP_PER 0
#endif
#ifndef XG_DEDUP_LAYOUT
#define XG_DEDUP_LAYOUT 0
#endif
#ifndef XG_DEDUP_STAGE
#define XG_DEDUP_STAGE 1
#endif
#ifndef XG_PREFIX_DIRECT_MAX
#define XG_PREFIX_DIRECT_MAX 128
#endif
// K8b-prefix reads a row of at most this many entries whole
constexpr int kDirectMax = XG_PREFIX_DIRECT_MAX;
static_assert(kDirectMax >= 0 && kDirectMax <= kLanes,
              "a direct row fits a ring slot");

// A frontier row of the device CSR, or (kTiered) of the host CSR: its
// first edge, its degree (0 for EMPTY and any id outside the graph), and
// whether it is cold.  A tiered launch with no device CSR (indptr null) is
// the cold form: no hot row is read, every row but a cold one is EMPTY.
template <bool kTiered>
__device__ __forceinline__ void row_meta(const int32_t* __restrict__ indptr,
                                         const Cold& cold, int32_t v,
                                         int64_t num_node, int64_t* start,
                                         int32_t* deg, bool* c) {
  *start = 0;
  *deg = 0;
  *c = false;
  if ((!kTiered || indptr != nullptr) && v >= 0 && (int64_t)v < num_node) {
    const int32_t s = __ldg(indptr + v);
    *start = s;
    *deg = __ldg(indptr + v + 1) - s;
  } else if (kTiered && v >= 0 && cold_id(cold, v, num_node)) {
    cold_row(cold, v, start, deg);
    *c = true;
  }
}

// ceil((j+1) * deg / kLanes) - 1 without overflow (deg = q * kLanes + r),
// clamped to [lo, deg - 1]
__device__ __forceinline__ int32_t coarse_pos(int32_t j, int32_t deg,
                                              int32_t lo) {
  const int32_t q = deg / kLanes, r = deg % kLanes;
  int32_t e = (j + 1) * q + ((j + 1) * r + kLanes - 1) / kLanes - 1;
  e = e < lo ? lo : e;
  return e > deg - 1 ? deg - 1 : e;
}

// popc of a warp-wide predicate
__device__ __forceinline__ int count(bool pred) {
  return __popc(__ballot_sync(kFull, pred));
}

// The offset of the first entry of a nondecreasing row[0, n) above x,
// clamped to n - 1: min(#{j < n : row[j] <= x}, n - 1)
__device__ __forceinline__ int32_t upper_offset(const float* row, int32_t n,
                                                float x) {
  int32_t lo = 0, hi = n - 1;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (row[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Row r of a run into slot (kLanes + 1 floats), copied asynchronously
// (cp.async: no register waits on it): its entries (a row of at most
// kDirectMax) or its coarse row (a longer one), then its total
__device__ __forceinline__ void issue_row(const float* __restrict__ prefix,
                                          const float* __restrict__ coarse,
                                          int32_t start, int32_t deg,
                                          int32_t v, int lane, float* slot) {
  if (deg <= 0) return;
  const float* p = prefix + start;
  if (deg > kDirectMax) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = lane + 32 * c;
      __pipeline_memcpy_async(slot + i,
                              coarse != nullptr
                                  ? coarse + (int64_t)v * kLanes + i
                                  : p + coarse_pos(i, deg, 0),
                              4);
    }
  } else {
    for (int i = lane; i < deg; i += 32)
      __pipeline_memcpy_async(slot + i, p + i, 4);
  }
  if (lane == 0) __pipeline_memcpy_async(slot + kLanes, p + deg - 1, 4);
}

// A cold row's prefix reads (tiered), as issue_row's, from host memory:
// plain loads into registers at issue (w: lane i's words of the row's
// entries i + 32c, or of its coarse row, the prefix at coarse_pos(i + 32c,
// deg, 0)), so several rows' host reads are in flight at once; stored into
// the row's slot at its turn (store_cold)
__device__ __forceinline__ void issue_cold(const float* p, int32_t deg,
                                           int lane, float (&w)[kChunks]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = lane + 32 * c;
    w[c] = deg > kDirectMax ? __ldcg(p + coarse_pos(i, deg, 0))
                            : (i < deg ? __ldcg(p + i) : 0.f);
  }
}

// a cold row's words into its slot, with its total: the last entry, or the
// coarse row's last value (coarse_pos(127, deg, 0) = deg - 1)
__device__ __forceinline__ void store_cold(float* slot, int32_t deg, int lane,
                                           const float (&w)[kChunks]) {
  const int last = deg > kDirectMax ? kLanes - 1 : deg - 1;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = lane + 32 * c;
    if (deg > kDirectMax || i < deg) slot[i] = w[c];
    if (i == last) slot[kLanes] = w[c];
  }
}

// The offsets of a hub row's picks (lane k holds pick k's in off0, pick
// k + 32's in off1): each pick's bucket from the coarse row cr by a
// search, then the buckets' entries counted by ballots, kPickGroup picks'
// reads issued together (from host memory for a cold row).
template <bool kTiered>
__device__ __forceinline__ void hub_offsets(const float* __restrict__ p,
                                            const float* cr, int32_t deg,
                                            float total, const int32_t* urow,
                                            int fanout, int lane,
                                            int32_t* off0, int32_t* off1,
                                            bool cold) {
  constexpr int kPickGroup = 8;
  int32_t lo0 = 0, lo1 = 0, hi0 = 0, hi1 = 0;
  for (int k = lane; k < fanout; k += 32) {
    const float x = __fmul_rn(__int_as_float(urow[k]), total);
    // the count of coarse values <= x, clamped to 127 (x rounded up to
    // total stays in the last bucket)
    const int32_t j = upper_offset(cr, kLanes, x);
    const int32_t lo = j > 0 ? coarse_pos(j - 1, deg, -1) + 1 : 0;
    const int32_t hi = coarse_pos(j, deg, 0);
    (k < 32 ? lo0 : lo1) = lo;
    (k < 32 ? hi0 : hi1) = hi;
  }
  // a bucket holds at most ceil(deg / 128) entries
  const int32_t span = (deg + kLanes - 1) / kLanes;
  int32_t n0 = lo0, n1 = lo1;
  for (int k0 = 0; k0 < fanout; k0 += kPickGroup) {
    for (int32_t b0 = 0; b0 < span; b0 += 32) {
      float val[kPickGroup];
#pragma unroll
      for (int i = 0; i < kPickGroup; ++i) {
        const int k = k0 + i;
        const int32_t lo = __shfl_sync(kFull, k < 32 ? lo0 : lo1, k & 31);
        const int32_t hi = __shfl_sync(kFull, k < 32 ? hi0 : hi1, k & 31);
        const int32_t at = lo + b0 + lane;
        val[i] = k < fanout && at <= hi ? rd<kTiered>(p + at, cold)
                                        : INFINITY;
      }
#pragma unroll
      for (int i = 0; i < kPickGroup; ++i) {
        const int k = k0 + i;
        if (k < fanout) {
          const float x = __fmul_rn(__int_as_float(urow[k]), total);
          const int c = count(val[i] <= x);
          if (lane == (k & 31)) (k < 32 ? n0 : n1) += c;
        }
      }
    }
  }
  *off0 = n0 < deg - 1 ? n0 : deg - 1;
  *off1 = n1 < deg - 1 ? n1 : deg - 1;
}

// One warp a run of rows (run_rows of them: enough runs to fill the card,
// and at most 32 rows or kRunPicks picks).  The run's uniforms are copied
// to shared memory asynchronously while lane i reads row i's frontier id,
// then its indptr pair.  The rows' prefix reads are copied into a ring of
// kDepth slots, kDepth - 1 rows ahead of the row being searched: lane k
// searches pick k's offset in the row in shared memory, and its edge
// position replaces its uniform.  The run's index gathers then go out
// together and the picks are stored in one coalesced pass.  Tiered, a cold
// row's reads (its entries or its coarse row, from host memory) are loaded
// into registers kDepth - 1 rows ahead and stored into its slot at its
// turn; it is then searched as a hot row, and its picks' index reads join
// the run's gathers, at its 64-bit start plus their offsets.
template <bool kTiered>
__global__ void __launch_bounds__(kWarps * 32)
sample_prefix_kernel(const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ prefix,
                     const float* __restrict__ coarse,
                     const int32_t* __restrict__ frontier,
                     const float* __restrict__ u, int32_t* __restrict__ out,
                     int64_t num_node, int64_t num_rows, int fanout,
                     int run_rows, Cold cold) {
  constexpr int kDepth = 4;
  constexpr int kBatch = 8;  // a lane's gathers in flight
  // the run's picks: each one's uniform (its bits), then its edge
  // position (-1 on a row of degree 0; a cold row's offset off as
  // -2 - off)
  __shared__ int32_t slot[kWarps][kRunPicks];
  // the rows in flight: a row's values and, last, its total
  __shared__ float ring[kWarps][kDepth][kLanes + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t base =
      ((int64_t)blockIdx.x * kWarps + warp) * (int64_t)run_rows;
  if (base >= num_rows) return;  // the whole warp
  const int rows = (int)(num_rows - base < run_rows ? num_rows - base
                                                     : run_rows);
  const int picks = rows * fanout;
  int32_t* sl = slot[warp];
  const float* urun = u + base * fanout;
  for (int i = lane; i < picks; i += 32)
    __pipeline_memcpy_async(sl + i, urun + i, 4);
  __pipeline_commit();
  const int32_t v = lane < rows ? __ldg(frontier + base + lane) : kEmpty;
  int64_t start64;
  int32_t deg;
  bool is_cold;
  row_meta<kTiered>(indptr, cold, v, num_node, &start64, &deg, &is_cold);
  // a hot row's start fits 32 bits (a cold row's stays in start64)
  const int32_t start = is_cold ? 0 : (int32_t)start64;
  if constexpr (kTiered) {
    // the rows' loop unrolled by kDepth, so a row's slot (and its cold
    // words' registers) has a compile-time index
    float stg[kDepth][kChunks];
#pragma unroll
    for (int r = 0; r < kDepth - 1; ++r) {
      if (r < rows) {
        const int32_t da = __shfl_sync(kFull, deg, r);
        const long long ca = __shfl_sync(kFull, (long long)start64, r);
        if (__shfl_sync(kFull, (int)is_cold, r) != 0) {
          if (da > 0) issue_cold(cold.prefix + ca, da, lane, stg[r]);
        } else {
          issue_row(prefix, coarse, __shfl_sync(kFull, start, r), da,
                    __shfl_sync(kFull, v, r), lane, ring[warp][r]);
        }
      }
      __pipeline_commit();
    }
    for (int r0 = 0; r0 < rows; r0 += kDepth) {
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        const int r = r0 + q;
        if (r >= rows) break;
        const int ahead = r + kDepth - 1;
        const int qa = (q + kDepth - 1) % kDepth;
        const int32_t sa = __shfl_sync(kFull, start, ahead & 31);
        const int32_t da = __shfl_sync(kFull, deg, ahead & 31);
        const int32_t va = __shfl_sync(kFull, v, ahead & 31);
        const long long ca = __shfl_sync(kFull, (long long)start64,
                                         ahead & 31);
        const bool cold_a = __shfl_sync(kFull, (int)is_cold, ahead & 31) != 0;
        if (ahead < rows) {
          if (cold_a) {
            if (da > 0) issue_cold(cold.prefix + ca, da, lane, stg[qa]);
          } else {
            issue_row(prefix, coarse, sa, da, va, lane, ring[warp][qa]);
          }
        }
        __pipeline_commit();
        __pipeline_wait_prior(kDepth - 1);  // this lane's copies of row r
        __syncwarp();                       // and every lane's
        const int32_t s = __shfl_sync(kFull, start, r);
        const int32_t d = __shfl_sync(kFull, deg, r);
        const bool c = __shfl_sync(kFull, (int)is_cold, r) != 0;
        const long long cs = __shfl_sync(kFull, (long long)start64, r);
        float* row = ring[warp][q];
        int32_t* urow = sl + r * fanout;
        if (c && d > 0) {
          store_cold(row, d, lane, stg[q]);
          __syncwarp();
        }
        // a pick's edge position, or a cold pick's offset off as -2 - off
        // (its row's 64-bit start stays in lane r's start64)
        if (d > 0 && d <= kDirectMax) {
          for (int k = lane; k < fanout; k += 32) {
            const float x = __fmul_rn(__int_as_float(urow[k]), row[kLanes]);
            const int32_t off = upper_offset(row, d, x);
            urow[k] = c ? -2 - off : s + off;
          }
        } else if (d > 0) {
          int32_t off0, off1;
          hub_offsets<true>(c ? cold.prefix + cs : prefix + s, row, d,
                            row[kLanes], urow, fanout, lane, &off0, &off1, c);
          __syncwarp();  // every lane read the row's uniforms
          if (lane < fanout) urow[lane] = c ? -2 - off0 : s + off0;
          if (lane + 32 < fanout) urow[lane + 32] = c ? -2 - off1 : s + off1;
        } else {
          for (int k = lane; k < fanout; k += 32) urow[k] = -1;
        }
        __syncwarp();  // the slot is read before it is refilled
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kDepth - 1; ++r) {
      if (r < rows)
        issue_row(prefix, coarse, __shfl_sync(kFull, start, r),
                  __shfl_sync(kFull, deg, r), __shfl_sync(kFull, v, r), lane,
                  ring[warp][r]);
      __pipeline_commit();
    }
    for (int r = 0; r < rows; ++r) {
      const int ahead = r + kDepth - 1;
      const int32_t sa = __shfl_sync(kFull, start, ahead & 31);
      const int32_t da = __shfl_sync(kFull, deg, ahead & 31);
      const int32_t va = __shfl_sync(kFull, v, ahead & 31);
      if (ahead < rows)
        issue_row(prefix, coarse, sa, da, va, lane,
                  ring[warp][ahead % kDepth]);
      __pipeline_commit();
      __pipeline_wait_prior(kDepth - 1);  // this lane's copies of row r
      __syncwarp();                       // and every lane's
      const int32_t s = __shfl_sync(kFull, start, r);
      const int32_t d = __shfl_sync(kFull, deg, r);
      const float* row = ring[warp][r % kDepth];
      int32_t* urow = sl + r * fanout;
      if (d > 0 && d <= kDirectMax) {
        // lane k: pick k's uniform in, its position out
        for (int k = lane; k < fanout; k += 32) {
          const float x = __fmul_rn(__int_as_float(urow[k]), row[kLanes]);
          urow[k] = s + upper_offset(row, d, x);
        }
      } else if (d > 0) {
        int32_t off0, off1;
        hub_offsets<false>(prefix + s, row, d, row[kLanes], urow, fanout,
                           lane, &off0, &off1, false);
        __syncwarp();  // every lane read the row's uniforms
        if (lane < fanout) urow[lane] = s + off0;
        if (lane + 32 < fanout) urow[lane + 32] = s + off1;
      } else {
        for (int k = lane; k < fanout; k += 32) urow[k] = -1;
      }
      __syncwarp();  // the slot is read before it is refilled
    }
  }
  int32_t* orun = out + base * fanout;
  for (int i0 = 0; i0 < picks; i0 += 32 * kBatch) {
    int32_t got[kBatch];
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int i = i0 + 32 * t + lane;
      const int32_t e = i < picks ? sl[i] : -1;
      if constexpr (kTiered) {
        // a cold pick: its row's start (lane i / fanout's) plus its offset
        const long long cs = __shfl_sync(kFull, (long long)start64,
                                         (i / fanout) & 31);
        got[t] = e >= 0 ? __ldg(indices + e)
                        : (e != -1 ? __ldcg(cold.indices + cs + (-2 - e))
                                   : kEmpty);
      } else {
        got[t] = e >= 0 ? __ldg(indices + e) : kEmpty;
      }
    }
#pragma unroll
    for (int t = 0; t < kBatch; ++t) {
      const int i = i0 + 32 * t + lane;
      if (i < picks) orun[i] = got[t];
    }
  }
}

// an alias draw of a row of degree deg > 0, from the device's tables or,
// for a cold row, the host's
template <bool kTiered>
__device__ __forceinline__ int32_t alias_draw(
    const int32_t* indices, const float* prob, const int32_t* alias,
    int64_t start, int32_t deg, float u, float coin, bool is_cold) {
  const float x = __fmul_rn(u, __int2float_rn(deg));
  int32_t slot = __float2int_rz(floorf(x));
  slot = slot < deg - 1 ? slot : deg - 1;
  const int64_t e = start + slot;
  return coin >= rd<kTiered>(prob + e, is_cold)
             ? rd<kTiered>(alias + e, is_cold)
             : rd<kTiered>(indices + e, is_cold);
}

// weighted_khop: one thread per pick
template <bool kTiered>
__global__ void sample_alias_kernel(const int32_t* __restrict__ indptr,
                                    const int32_t* __restrict__ indices,
                                    const float* __restrict__ prob,
                                    const int32_t* __restrict__ alias,
                                    const int32_t* __restrict__ frontier,
                                    const float* __restrict__ u,
                                    const float* __restrict__ coin,
                                    int32_t* __restrict__ out,
                                    int64_t num_node, int64_t num_picks,
                                    int fanout, Cold cold) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_picks) return;
  int64_t start;
  int32_t deg;
  bool c;
  row_meta<kTiered>(indptr, cold, __ldg(frontier + t / fanout), num_node,
                    &start, &deg, &c);
  out[t] = deg > 0 ? alias_draw<kTiered>(
                         c ? cold.indices : indices, c ? cold.prob : prob,
                         c ? cold.alias : alias, start, deg, __ldg(u + t),
                         __ldg(coin + t), c)
                   : kEmpty;
}

// weighted_khop_hash_dedup: the draws packed densely over a block's rows,
// a thread a draw (kPer draws a thread: slot d = threadIdx.x + p *
// kDedupThreads).  Row r of the block holds the slots [r * stride, r *
// stride + draws) (dedup_stride), so u, coin and out move coalesced for
// the block's rows.
//   A: rows < block_rows threads read the rows' frontier ids; a block
//      whose ids are all outside the graph writes EMPTY and leaves.
//   B: the same threads read the rows' indptr pairs (a cold row's from
//      host memory); every slot of a live row loads its u and coin.
//   C0 (tiered): a short cold row's entries are read whole into shared
//      memory (see the note at the top of this file).
//   C: every draw's prob read is issued, then its alias or index read; a
//      row of deg <= K reads its entries into its first deg slots.
//   D: a draw is a first occurrence when no earlier slot of its row holds
//      its value (a scan of at most draws - 1 words of shared memory); a
//      whole row's entries are all first occurrences.  A ballot a warp
//      keeps the flags, 32 slots a word.
//   E: a first occurrence's rank is the count of flags before it in its
//      row (at most 9 words); the first K go to `picked`, EMPTY elsewhere.
//   F: the block's rows of out are written from `picked` in one
//      coalesced pass.
template <bool kTiered, int kPer>
__global__ void __launch_bounds__(kDedupThreads)
sample_alias_dedup_kernel(const int32_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const float* __restrict__ prob,
                          const int32_t* __restrict__ alias,
                          const int32_t* __restrict__ frontier,
                          const float* __restrict__ u,
                          const float* __restrict__ coin,
                          int32_t* __restrict__ out, int64_t num_node,
                          int64_t num_rows, int fanout, int draws,
                          int stride, int block_rows, Cold cold) {
  constexpr int kSlots = kPer * kDedupThreads;
  constexpr bool kStage = kTiered && XG_DEDUP_STAGE;
  constexpr int kStaged = kStage ? kSlots : 1;
  __shared__ int32_t drawn[kSlots];
  __shared__ int32_t picked[kSlots];
  // C0's stage: a short cold row's entries in its slots
  __shared__ float st_prob[kStaged];
  __shared__ int32_t st_alias[kStaged], st_index[kStaged];
  __shared__ unsigned flags[kSlots / 32];
  __shared__ long long s_start[kDedupMaxRows];
  __shared__ int32_t s_deg[kDedupMaxRows];
  __shared__ int32_t s_id[kDedupMaxRows];
  __shared__ bool s_cold[kDedupMaxRows];
  const int t = threadIdx.x, lane = t & 31;
  const int64_t row0 = (int64_t)blockIdx.x * block_rows;
  const int rows = (int)(num_rows - row0 < block_rows ? num_rows - row0
                                                       : block_rows);
  const int outs = rows * fanout;
  int32_t* orow = out + row0 * fanout;
  // A
  const int32_t v = t < rows ? __ldg(frontier + row0 + t) : kEmpty;
  const bool live = v >= 0 && (int64_t)v < cold.num_total;
  if (t < rows) s_id[t] = v;
  for (int o = t; o < outs; o += kDedupThreads) picked[o] = kEmpty;
  if (!__syncthreads_or(live)) {
    for (int o = t; o < outs; o += kDedupThreads) orow[o] = kEmpty;
    return;
  }
  // B
  if (t < rows) {
    int64_t start;
    int32_t deg;
    bool c;
    row_meta<kTiered>(indptr, cold, v, num_node, &start, &deg, &c);
    s_start[t] = start;
    s_deg[t] = deg;
    s_cold[t] = c;
  }
  int rr[kPer], at[kPer];  // a slot's row and its draw in the row
  float uu[kPer], cc[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int d = t + p * kDedupThreads;
    rr[p] = d / stride;
    at[p] = d - rr[p] * stride;
    if (rr[p] >= rows || at[p] >= draws) at[p] = -1;  // no draw
    const int32_t id = at[p] >= 0 ? s_id[rr[p]] : -1;
    const bool on = id >= 0 && (int64_t)id < cold.num_total;
    const int64_t g = (row0 + rr[p]) * draws + at[p];
    uu[p] = on ? __ldg(u + g) : 0.f;
    cc[p] = on ? __ldg(coin + g) : 0.f;
  }
  __syncthreads();
  // C0 (tiered): a cold row of K < deg <= stride reads its prob, alias and
  // index entries whole, entry i into the row's slot i (a coalesced read a
  // table, issued together), and its draws read them from the stage: fewer
  // requests to host memory and one round trip less than a read a draw
  if constexpr (kStage) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int d = t + p * kDedupThreads, r = d / stride, i = d - r * stride;
      if (r < rows && s_cold[r] && s_deg[r] > fanout && s_deg[r] <= stride &&
          i < s_deg[r]) {
        const int64_t e = s_start[r] + i;
        st_prob[d] = __ldcg(cold.prob + e);
        st_alias[d] = __ldcg(cold.alias + e);
        st_index[d] = __ldcg(cold.indices + e);
      }
    }
    __syncthreads();
  }
  // C
  int32_t val[kPer];
  int64_t e[kPer];
  int staged[kPer];  // a staged draw's slot in the stage, else -1
  float pr[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    e[p] = -1;
    staged[p] = -1;
    pr[p] = 0.f;
    if (at[p] < 0) continue;
    const int32_t deg = s_deg[rr[p]];
    const int64_t start = s_start[rr[p]];
    const bool c = kTiered && s_cold[rr[p]];
    if (deg > fanout) {
      const float x = __fmul_rn(uu[p], __int2float_rn(deg));
      int32_t sl = __float2int_rz(floorf(x));
      sl = sl < deg - 1 ? sl : deg - 1;
      e[p] = start + sl;
      if (kStage && c && deg <= stride) {
        staged[p] = rr[p] * stride + sl;
        pr[p] = st_prob[kStage ? staged[p] : 0];
      } else {
        pr[p] = rd<kTiered>((c ? cold.prob : prob) + e[p], c);
      }
    } else if (at[p] < deg) {
      e[p] = start + at[p];
    }
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    val[p] = kEmpty;
    if (e[p] < 0) continue;
    const bool c = kTiered && s_cold[rr[p]];
    if (kStage && staged[p] >= 0) {
      const int q = kStage ? staged[p] : 0;
      val[p] = cc[p] >= pr[p] ? st_alias[q] : st_index[q];
    } else if (s_deg[rr[p]] > fanout) {
      val[p] = cc[p] >= pr[p] ? rd<kTiered>((c ? cold.alias : alias) + e[p], c)
                              : rd<kTiered>((c ? cold.indices : indices) + e[p],
                                            c);
    } else {
      val[p] = rd<kTiered>((c ? cold.indices : indices) + e[p], c);
    }
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) drawn[t + p * kDedupThreads] = val[p];
  __syncthreads();
  // D
  bool first[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    first[p] = e[p] >= 0;
    if (first[p] && s_deg[rr[p]] > fanout) {
      const int d = t + p * kDedupThreads;
      for (int j = d - at[p]; j < d; ++j) {
        if (drawn[j] == val[p]) {
          first[p] = false;
          break;
        }
      }
    }
    const unsigned b = __ballot_sync(kFull, first[p]);
    if (lane == 0) flags[(t + p * kDedupThreads) >> 5] = b;
  }
  __syncthreads();
  // E
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (!first[p]) continue;
    const int d = t + p * kDedupThreads, base = d - at[p];
    int rank = 0;
    for (int w = base >> 5; w <= d >> 5; ++w) {
      unsigned bits = flags[w];
      if (w == base >> 5) bits &= ~0u << (base & 31);
      if (w == d >> 5) bits &= (1u << (d & 31)) - 1u;
      rank += __popc(bits);
    }
    if (rank < fanout) picked[rr[p] * fanout + rank] = val[p];
  }
  __syncthreads();
  // F
  for (int o = t; o < outs; o += kDedupThreads) orow[o] = picked[o];
}

// The hash-dedup form's slots a row: its draws untiered (packed densely),
// a lane group of 16, 32 or a multiple of 64 slots tiered, so that no warp
// instruction reads two rows' host entries (a cold row's reads are
// requests to host memory, each distinct sector of an instruction one).
// XG_DEDUP_LAYOUT 1 and 2 (variants) give every instance lane groups or
// dense packing.
inline int dedup_stride(int draws, bool tiered) {
  const int groups =
      draws <= 16 ? 16 : draws <= 32 ? 32 : (draws + 63) / 64 * 64;
#if XG_DEDUP_LAYOUT == 1
  return groups;
#elif XG_DEDUP_LAYOUT == 2
  return draws;
#else
  return tiered ? groups : draws;
#endif
}

template <bool kTiered, int kPer>
void launch_dedup_per(const int32_t* ip, const int32_t* ix, const float* pr,
                      const int32_t* al, const int32_t* fr, const float* uf,
                      const float* cf, int32_t* o, long long num_node,
                      long long num_rows, int fanout, int draws, int stride,
                      const Cold& cold, cudaStream_t s) {
  const int per_block = kPer * kDedupThreads / stride;
  const int rows = per_block < kDedupMaxRows ? per_block : kDedupMaxRows;
  const long long blocks = (num_rows + rows - 1) / rows;
  sample_alias_dedup_kernel<kTiered, kPer>
      <<<(unsigned)blocks, kDedupThreads, 0, s>>>(
          ip, ix, pr, al, fr, uf, cf, o, num_node, num_rows, fanout, draws,
          stride, rows, cold);
}

// The hash-dedup form's launch: two draws a thread where that still gives
// the card a full wave of blocks, else one (four, a variant, measured level
// or slower at the main path's frontiers)
template <bool kTiered>
void launch_dedup(const int32_t* ip, const int32_t* ix, const float* pr,
                  const int32_t* al, const int32_t* fr, const float* uf,
                  const float* cf, int32_t* o, long long num_node,
                  long long num_rows, int fanout, int draws,
                  const Cold& cold, cudaStream_t s) {
  const int stride = dedup_stride(draws, kTiered);
  int per = XG_DEDUP_PER;
  if (per == 0) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long wave = (long long)sms * (2048 / kDedupThreads);
    const int fit = 2 * kDedupThreads / stride;
    const int rows = fit < kDedupMaxRows ? fit : kDedupMaxRows;
    per = (num_rows + rows - 1) / rows >= wave ? 2 : 1;
  }
  if (per == 2)
    launch_dedup_per<kTiered, 2>(ip, ix, pr, al, fr, uf, cf, o, num_node,
                                 num_rows, fanout, draws, stride, cold, s);
#if XG_DEDUP_PER == 4
  else if (per == 4)
    launch_dedup_per<kTiered, 4>(ip, ix, pr, al, fr, uf, cf, o, num_node,
                                 num_rows, fanout, draws, stride, cold, s);
#endif
  else
    launch_dedup_per<kTiered, 1>(ip, ix, pr, al, fr, uf, cf, o, num_node,
                                 num_rows, fanout, draws, stride, cold, s);
}

// K8b-prefix's launch: rows a warp as many as spread the frontier over the
// card's resident warps, at most 32 and kRunPicks / fanout
template <bool kTiered>
void launch_prefix(const int32_t* indptr, const int32_t* indices,
                   const float* prefix, const float* coarse,
                   const int32_t* frontier, const float* u, int32_t* out,
                   long long num_node, long long num_rows, int fanout,
                   const Cold& cold, cudaStream_t s) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sample_prefix_kernel<kTiered>, kWarps * 32, 0);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1) *
                             kWarps;
  long long run_rows = (num_rows + resident - 1) / resident;
  const int most = kRunPicks / fanout < 32 ? kRunPicks / fanout : 32;
  run_rows = run_rows < 1 ? 1 : (run_rows > most ? most : run_rows);
  const long long runs = (num_rows + run_rows - 1) / run_rows;
  const long long blocks = (runs + kWarps - 1) / kWarps;
  sample_prefix_kernel<kTiered><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
      indptr, indices, prefix, coarse, frontier, u, out, num_node, num_rows,
      fanout, (int)run_rows, cold);
}

template <bool kTiered>
void launch_alias(const int32_t* ip, const int32_t* ix, const float* pr,
                  const int32_t* al, const int32_t* fr, const float* uf,
                  const float* cf, int32_t* o, long long num_node,
                  long long num_rows, int fanout, int draws, bool dedup,
                  const Cold& cold, cudaStream_t s) {
  if (dedup) {
    launch_dedup<kTiered>(ip, ix, pr, al, fr, uf, cf, o, num_node, num_rows,
                          fanout, draws, cold, s);
  } else {
    const long long picks = num_rows * fanout;
    sample_alias_kernel<kTiered>
        <<<(unsigned)((picks + 255) / 256), 256, 0, s>>>(
            ip, ix, pr, al, fr, uf, cf, o, num_node, picks, fanout, cold);
  }
}

}  // namespace

// K8b-prefix.  indptr: (num_node + 1,) int32; indices, prefix: (E,) int32
// and float32, prefix nondecreasing within each row; coarse: (num_node, 128)
// float32 or null; frontier: (num_rows,) int32, EMPTY padded; u, out:
// (num_rows, fanout) float32 and int32.  1 <= fanout <= 64.  cold_indptr,
// cold_indices, cold_prefix: the whole graph's CSR and prefix table in
// mapped host memory ((num_total + 1,) int64, int32, float32), read for
// the rows [num_node, num_total); all null and num_total == num_node when
// the topology is not tiered.  The cold form: indptr, indices, prefix and
// coarse null with a tier, num_node the hot prefix's size (a cold row gets
// its picks, every other row EMPTY).  Returns cudaGetLastError() after the
// launch.
extern "C" int xg_sample_prefix(const void* indptr, const void* indices,
                                const void* prefix, const void* coarse,
                                const void* frontier, const void* u,
                                void* out, long long num_node,
                                long long num_rows, int fanout,
                                const void* cold_indptr,
                                const void* cold_indices,
                                const void* cold_prefix, long long num_total,
                                void* stream) {
  Cold cold;
  if (fanout < 1 || fanout > kMaxFanout ||
      !make_cold(cold_indptr, cold_indices, nullptr, nullptr, cold_prefix,
                 num_node, num_total, kPrefixTable, &cold) ||
      (indptr == nullptr && cold_indptr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const float* pf = static_cast<const float*>(prefix);
  const float* cc = static_cast<const float*>(coarse);
  const int32_t* fr = static_cast<const int32_t*>(frontier);
  const float* uf = static_cast<const float*>(u);
  int32_t* o = static_cast<int32_t*>(out);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (cold.indptr != nullptr)
    launch_prefix<true>(ip, ix, pf, cc, fr, uf, o, num_node, num_rows, fanout,
                        cold, s);
  else
    launch_prefix<false>(ip, ix, pf, cc, fr, uf, o, num_node, num_rows,
                         fanout, cold, s);
  return (int)cudaGetLastError();
}

// K8b-alias.  indptr, indices and frontier as above; prob, alias: (E,)
// float32 and int32; u, coin: (num_rows, draws) float32; out: (num_rows,
// fanout) int32.  dedup == 0: draws == fanout, each draw a pick; dedup != 0:
// the first fanout distinct of the draws, fanout <= draws <= 256.
// cold_indptr, cold_indices, cold_prob, cold_alias: the whole graph's CSR
// and alias tables in mapped host memory, as for xg_sample_prefix, and the
// cold form likewise (indptr, indices, prob and alias null).  Returns
// cudaGetLastError() after the launch.
extern "C" int xg_sample_alias(const void* indptr, const void* indices,
                               const void* prob, const void* alias,
                               const void* frontier, const void* u,
                               const void* coin, void* out,
                               long long num_node, long long num_rows,
                               int fanout, int draws, int dedup,
                               const void* cold_indptr,
                               const void* cold_indices,
                               const void* cold_prob, const void* cold_alias,
                               long long num_total, void* stream) {
  Cold cold;
  if (fanout < 1 || fanout > kMaxFanout ||
      (dedup ? draws < fanout || draws > kMaxDraws : draws != fanout) ||
      !make_cold(cold_indptr, cold_indices, cold_prob, cold_alias, nullptr,
                 num_node, num_total, kAliasTables, &cold) ||
      (indptr == nullptr && cold_indptr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const float* pr = static_cast<const float*>(prob);
  const int32_t* al = static_cast<const int32_t*>(alias);
  const int32_t* fr = static_cast<const int32_t*>(frontier);
  const float* uf = static_cast<const float*>(u);
  const float* cf = static_cast<const float*>(coin);
  int32_t* o = static_cast<int32_t*>(out);
  if (cold.indptr != nullptr)
    launch_alias<true>(ip, ix, pr, al, fr, uf, cf, o, num_node, num_rows,
                       fanout, draws, dedup != 0, cold, s);
  else
    launch_alias<false>(ip, ix, pr, al, fr, uf, cf, o, num_node, num_rows,
                        fanout, draws, dedup != 0, cold, s);
  return (int)cudaGetLastError();
}
