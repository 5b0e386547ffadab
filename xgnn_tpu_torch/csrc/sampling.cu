// K2: uniform K-subset neighbour sampler (khop0 / khop2 / khop3), and K8a:
// uniform draws with replacement (uniform_wr) and khop1.
//
// K2:
// For frontier row b with v = frontier[b]: start = indptr[v] and
// deg = indptr[v+1] - start (deg = 0 for EMPTY, int32 max, and for any id
// outside [0, num_node)).  A partial Fisher-Yates over the virtual array
// A = [0..deg): at step j < min(K, deg)
//     span = deg - j
//     t    = j + min(floor(u[b,j] * span), span - 1)
//     emit A[t]; A[t] = A[j]
// and out[b, j] = indices[start + A[t]]; out[b, j] = EMPTY for j >= deg.
//
// Replaces: xgnn_tpu/ops/sampling.py, sample_khop0 with _frontier_meta
// (lines 67-91 and 144-189): XLA ops shaped for the TPU, K^2 vector selects
// over the whole frontier.  The picks equal that function's and the plain
// PyTorch version's bit for bit for the same u: the product u * span is one
// float32 multiply rounded to nearest (__fmul_rn, so it is never fused into
// anything), span is converted to float rounded to nearest, and the file is
// built without --use_fast_math.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// dependent reads indptr -> indices.  Per row it reads the frontier id, two
// indptr entries, at most K uniforms and min(K, deg) random 4-byte indices
// (each costs a 32-byte sector), and writes K ids.  It does about K^2 / 2
// integer compares per row, far below the card's rate.
//
// Design: one thread per frontier row.  Positions < j are never revisited,
// so only the at most K displaced entries (position, value) are kept.  A
// lookup scans the records in step order and the last match wins, as the
// reference's chain of selects does.  The loop stops at min(K, deg), so an
// EMPTY or low-degree row reads no uniform and no index past its degree,
// and an EMPTY row never reads indptr at all.  Offsets into indices are
// 64-bit.
//
// For the fanouts the repo uses (K = 5, 10, 15) the kernel is built for
// that K, so every loop unrolls to compile-time indices and the records
// stay in registers.  A block of 256 rows stages its u tile and its out
// tile (256 x K words, at most 15 KB, one buffer: a thread overwrites only
// its own row) through shared memory, so device memory sees coalesced
// 16-byte loads and stores instead of stride-K ones; each thread reads its
// frontier id and indptr pair before the tile load, so the two overlap.  A
// thread first resolves all min(K, deg) offsets from u and the records,
// then issues its index loads back to back: they are independent, so up to
// K are in flight at once.  Any other K up to kMaxFanout takes the unstaged
// loop with its records in local memory.
//
// K8a:
// For a row of degree deg > 0, every j < K draws with replacement:
//     out[b, j] = indices[start + min(floor(u[b,j] * deg), deg - 1)]
// (uniform_wr: repeats kept).  khop1 then sorts the row ascending and writes
// EMPTY over each pick equal to the one before it; the row is not
// compacted.  A row of degree 0 is all EMPTY and reads no index.
//
// Replaces: xgnn_tpu/ops/sampling.py, sample_uniform_wr (lines 98-117) and
// sample_khop1 with _dedup_rows (120-141), bit for bit for the same u, with
// K2's float32 rules.
//
// Design: K2's.  One thread per row; for K = 5, 10 and 15 the u and out
// tiles are staged through shared memory, the K offsets are computed first
// and the K index loads issued back to back, and khop1 sorts the K picks in
// registers with an odd-even transposition network (K rounds, no
// data-dependent branch).  Any other K up to kMaxFanout takes an unstaged
// loop with the row in local memory and an insertion sort.
//
// The tiered topology (tier.cuh): a cold row is read in place from the
// whole graph's CSR in mapped host memory.  Its draws are the hot rows'
// arithmetic on the same u, so a tiered call picks what the untiered call
// over the whole CSR picks.  A cold row's host reads are two dependent PCIe
// round trips (its indptr pair, then its picks), and what bounds them is the
// rate at which the link and the host answer scattered 32-byte reads, not
// the link's bytes.
//
// K2 gives its cold rows warps of their own work: each warp first writes
// its hot rows' picks (a cold row, an id past the hot prefix, reads there
// as EMPTY), then takes its 32 rows' cold rows together: a ballot compacts
// them, lanes 2r and 2r + 1 read cold row r's indptr pair in one
// instruction, lane r resolves its row's K offsets from u and the degree
// (the offsets need no index), and then a lane a pick reads the picks, a
// row's picks in neighbouring lanes, so picks in one sector or line go out
// as one request and every pick of the warp's cold rows is in flight at
// once.  In the staged kernel the cold picks overwrite their rows of the
// block's out tile before its one coalesced store.  A warp with no cold row
// skips it all.  What bounds it: the rate at which the link and the host
// answer scattered reads.  At layer 2 of the main path's batch at 0.85
// (143,826 cold rows of 1,007,360, K = 5; NVIDIA H100 80GB HBM3, 700.00 W,
// xgnn_tpu_torch/tools/time_samplers.py --tiered) it takes 1.34-1.50
// device ms against PR 17's 2.80-3.23 (a thread a row, each of its 7 reads
// a request of its own): 415-466M distinct sectors a second, between the
// card's measured rates for scattered 32-byte (259-285M sectors a second)
// and 128-byte (525-560M) mapped host reads, since a row's picks share
// lines.  Two
// other shapes measured slower there (PERF.md section 6, PR 18): the same
// warp routine in a second launch after the untiered kernel (1.46-1.57),
// and that launch reading each cold row of at most 64 entries whole before
// selecting its picks (2.02-2.18).
//
// K8a's cold rows take K2's warp shape (cold_rows_wr): after the hot rows,
// a ballot compacts the warp's cold rows, lane pairs read their indptr
// pairs in one instruction (cold_pairs, tier.cuh), and a lane a draw reads
// the picks, each lane computing its own offset from u and the degree
// shuffled from the row's lane: the draws are independent, so no lane
// resolves a row first and the warp's 32 rows go in one run at any K.
// khop1 then sorts each cold row on its own lane (in registers for K = 5,
// 10 and 15).  At the main path's three frontiers at 0.85 (NVIDIA H100 80GB
// HBM3, 700.00 W, tools/time_samplers.py --tiered, on a host answering
// 226M scattered 32-byte mapped reads a second; PERF.md section 6) khop1
// takes 0.0313 / 0.1704 / 1.5556 device ms at layers 0 / 1 / 2 against
// 0.1067 / 1.1455 / 3.3607 for a thread a cold row reading its pair and
// then its picks itself (each read a request of its own, its warp stalled
// on both round trips); layer 2 level with K2's 1.6196 over the same cold
// rows.  Each
// kernel that reads a tier is built twice, kTiered false (the untiered
// launch, no cold branch) and true.
//
// The cold form (the same tiered kernels with no device CSR: indptr and
// indices null, num_node the hot prefix's size) serves the partitioned
// topology, where a rank's device CSR is its part of the hot prefix (local
// rows, not global ones) and the hot rows go to their owners: the
// requesting rank draws its frontier's cold rows alone, every other row
// EMPTY, and no device CSR row is read (row_meta's hot branch is off).
//
// Replaces, for the cold rows: xgnn_tpu/parallel/ggms.py,
// HostColdSampler (lines 264-453) driven by cold_sample_callback
// (456-487), xgnn_tpu/sampler.py:282-310 and, on the partitioned
// topology, xgnn_tpu/parallel/dist_topology.py:315-330: a host callback
// over the compacted cold ids of each layer, merged into the device's
// picks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier.cuh"

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kMaxFanout = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kColdPicks = 512;  // a warp's cold picks at a time
constexpr int kColdBatch = 8;    // a lane's cold pick reads in flight

// A frontier row on the card: its first edge and its degree (0 for EMPTY
// and any id outside the hot rows; a tiered call's cold rows read so here,
// and their warps take them after)
struct Row {
  int64_t start;
  int32_t deg;
};

// (a tiered launch with no device CSR, indptr null, is the cold form: every
// row reads as outside the graph here, so no hot row is read)
template <bool kTiered>
__device__ __forceinline__ Row row_meta(const int32_t* __restrict__ indptr,
                                        const int32_t* __restrict__ frontier,
                                        int64_t row, int64_t num_node) {
  const int32_t v = __ldg(frontier + row);
  Row r{0, 0};
  if ((!kTiered || indptr != nullptr) && v >= 0 && (int64_t)v < num_node) {
    const int32_t start = __ldg(indptr + v);
    r.start = start;
    r.deg = __ldg(indptr + v + 1) - start;
  }
  return r;
}

// index off of a row
__device__ __forceinline__ int32_t edge(const int32_t* __restrict__ indices,
                                        const Row& r, int32_t off) {
  return __ldg(indices + (r.start + off));
}

// the draw of step j: t in [j, deg)
__device__ __forceinline__ int32_t draw(float u, int32_t deg, int j) {
  const int32_t span = deg - j;
  const float x = __fmul_rn(u, __int2float_rn(span));
  const int32_t d = __float2int_rz(floorf(x));
  return j + (d < span - 1 ? d : span - 1);
}

// K2's cold rows among the frontier rows [row0, row0 + n), by one warp
// (every lane calls it; n <= 32 and n * fanout <= kColdPicks): their picks
// into o + i * K, i a row's index in the run (o in device or shared
// memory).  The run's cold rows are compacted by a ballot; lanes 2r and
// 2r + 1 read cold row r's indptr pair in one instruction; lane r resolves
// its row's offsets from u and the degree (K2's records, in registers for a
// compile-time K) into offs; then a lane a pick reads the picks.
template <int kK>
__device__ __forceinline__ void cold_rows(
    const int32_t* __restrict__ frontier, const float* __restrict__ u,
    int32_t* o, int64_t row0, int n, int fanout, int64_t num_node,
    const Cold& cold, int32_t* offs) {
  const int K = kK > 0 ? kK : fanout;
  const int lane = threadIdx.x & 31;
  const int32_t v = lane < n ? __ldg(frontier + row0 + lane) : -1;
  const unsigned mask =
      __ballot_sync(kFull, v >= 0 && cold_id(cold, v, num_node));
  const int nc = __popc(mask);
  if (nc == 0) return;
  // lane r < nc: the run's r-th cold row, its index ri in the run
  const int ri = nth_bit(mask, lane < nc ? lane : 0);
  long long start;
  int32_t deg;
  cold_pairs(cold, __shfl_sync(kFull, v, ri), nc, &start, &deg);
  const int live = deg <= 0 ? 0 : (deg < K ? deg : K);
  if (lane < nc) {
    const float* urow = u + (row0 + ri) * K;
    int32_t* my = offs + lane * K;
    if constexpr (kK > 0) {
      int32_t pos[kK], val[kK];
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        int32_t p = -1;
        if (j < live) {
          const int32_t t = draw(__ldg(urow + j), deg, j);
          int32_t a_j = j;
          p = t;
#pragma unroll
          for (int i = 0; i < kK; ++i) {
            if (i < j) {
              if (pos[i] == t) p = val[i];
              if (pos[i] == j) a_j = val[i];
            }
          }
          pos[j] = t;
          val[j] = a_j;
        }
        my[j] = p;
      }
    } else {
      int32_t pos[kMaxFanout], val[kMaxFanout];
      for (int j = 0; j < live; ++j) {
        const int32_t t = draw(__ldg(urow + j), deg, j);
        int32_t p = t, a_j = j;
        for (int i = 0; i < j; ++i) {
          if (pos[i] == t) p = val[i];
          if (pos[i] == j) a_j = val[i];
        }
        pos[j] = t;
        val[j] = a_j;
        my[j] = p;
      }
      for (int j = live; j < K; ++j) my[j] = -1;
    }
  }
  __syncwarp();
  // pick p is step p % K of cold row p / K; kColdBatch reads a lane in
  // flight
  const int picks = nc * K;
  for (int p0 = 0; p0 < picks; p0 += 32 * kColdBatch) {
    int32_t got[kColdBatch];
#pragma unroll
    for (int t = 0; t < kColdBatch; ++t) {
      const int p = p0 + 32 * t + lane;
      const int r = p < picks ? p / K : 0;
      const long long s = __shfl_sync(kFull, start, r);
      const int32_t off = p < picks ? offs[p] : -1;
      got[t] = off >= 0 ? __ldcg(cold.indices + s + off) : kEmpty;
    }
#pragma unroll
    for (int t = 0; t < kColdBatch; ++t) {
      const int p = p0 + 32 * t + lane;
      const int r = p < picks ? p / K : 0;
      const int i = __shfl_sync(kFull, ri, r);
      if (p < picks) o[i * K + (p - r * K)] = got[t];
    }
  }
}

// n words from src to dst, 16 bytes at a time when both are 16-byte aligned
__device__ __forceinline__ void copy_tile(uint32_t* dst, const uint32_t* src,
                                          int n, bool vec) {
  int done = 0;
  if (vec) {
    const int n4 = n >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kThreads) d4[i] = s4[i];
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

template <int kK, bool kTiered>
__global__ void __launch_bounds__(kThreads)
sample_khop_staged_kernel(const int32_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const int32_t* __restrict__ frontier,
                          const float* __restrict__ u,
                          int32_t* __restrict__ out, int64_t num_node,
                          int64_t num_rows, bool vec, Cold cold) {
  __shared__ __align__(16) uint32_t tile[kThreads * kK];
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t row = row0 + threadIdx.x;
  const int64_t rows = num_rows - row0 < kThreads ? num_rows - row0 : kThreads;
  const int words = (int)rows * kK;
  // a cold row (kTiered) reads as an id outside the graph here, its
  // picks EMPTY until the warp's cold rows overwrite them below
  Row r{0, 0};
  if (row < num_rows)
    r = row_meta<kTiered>(indptr, frontier, row, num_node);
  const int32_t deg = r.deg;
  copy_tile(tile, reinterpret_cast<const uint32_t*>(u) + row0 * kK, words,
            vec);
  __syncthreads();

  if (row < num_rows) {
    uint32_t* trow = tile + threadIdx.x * kK;
    const int live = deg <= 0 ? 0 : (deg < kK ? deg : kK);
    // Both loops run to compile-time bounds and unroll fully, so every
    // record index is a constant and the records stay in registers (an
    // early exit from the unrolled loop would put them on the stack); the
    // guards skip the steps past live.
    int32_t pos[kK], val[kK], pick[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      pick[j] = 0;
      if (j < live) {
        const int32_t t = draw(__uint_as_float(trow[j]), deg, j);
        int32_t p = t, a_j = j;
#pragma unroll
        for (int i = 0; i < kK; ++i) {
          if (i < j) {
            if (pos[i] == t) p = val[i];
            if (pos[i] == j) a_j = val[i];
          }
        }
        pos[j] = t;
        val[j] = a_j;
        pick[j] = p;
      }
    }
    // every offset is known: the index loads go out back to back
#pragma unroll
    for (int j = 0; j < kK; ++j)
      pick[j] = j < live ? edge(indices, r, pick[j]) : kEmpty;
#pragma unroll
    for (int j = 0; j < kK; ++j) trow[j] = (uint32_t)pick[j];
  }
  if constexpr (kTiered) {  // the warp's cold rows
    __shared__ int32_t offs[kWarps][kColdPicks];
    const int warp = threadIdx.x >> 5;
    const int64_t first = row0 + 32 * warp;
    const int64_t left = num_rows - first;
    __syncwarp();
    cold_rows<kK>(frontier, u,
                  reinterpret_cast<int32_t*>(tile) + 32 * warp * kK, first,
                  left < 0 ? 0 : (left < 32 ? (int)left : 32), kK, num_node,
                  cold, offs[warp]);
  }
  __syncthreads();
  copy_tile(reinterpret_cast<uint32_t*>(out) + row0 * kK, tile, words, vec);
}

// any fanout up to kMaxFanout: one thread per row, unstaged, records in
// local memory; tiered, each warp then takes its rows' cold rows, a run of
// at most kColdPicks / fanout rows at a time
template <bool kTiered>
__global__ void sample_khop_kernel(const int32_t* __restrict__ indptr,
                                   const int32_t* __restrict__ indices,
                                   const int32_t* __restrict__ frontier,
                                   const float* __restrict__ u,
                                   int32_t* __restrict__ out,
                                   int64_t num_node, int64_t num_rows,
                                   int fanout, Cold cold) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (!kTiered && row >= num_rows) return;
  if (row < num_rows) {
    const Row r = row_meta<kTiered>(indptr, frontier, row, num_node);
    const int32_t deg = r.deg;
    const int live = deg <= 0 ? 0 : (deg < fanout ? deg : fanout);
    const float* urow = u + row * fanout;
    int32_t* orow = out + row * fanout;
    int32_t pos[kMaxFanout], val[kMaxFanout];
    for (int j = 0; j < live; ++j) {
      const int32_t t = draw(__ldg(urow + j), deg, j);
      int32_t pick = t, a_j = j;
      for (int i = 0; i < j; ++i) {
        if (pos[i] == t) pick = val[i];
        if (pos[i] == j) a_j = val[i];
      }
      pos[j] = t;
      val[j] = a_j;
      orow[j] = edge(indices, r, pick);
    }
    for (int j = live; j < fanout; ++j) orow[j] = kEmpty;
  }
  if constexpr (kTiered) {
    __shared__ int32_t offs[kWarps][kColdPicks];
    const int warp = threadIdx.x >> 5;
    const int64_t first = row - (threadIdx.x & 31);
    const int run = kColdPicks / fanout < 32 ? kColdPicks / fanout : 32;
    __syncwarp();  // the warp's hot rows' stores before the cold ones
    for (int i = 0; i < 32; i += run) {
      const int64_t left = num_rows - (first + i);
      const int m = 32 - i < run ? 32 - i : run;  // the warp's rows in it
      cold_rows<0>(frontier, u, out + (first + i) * fanout, first + i,
                   left <= 0 ? 0 : (left < m ? (int)left : m), fanout,
                   num_node, cold, offs[warp]);
      __syncwarp();  // offs is read before the next run refills it
    }
  }
}

// the K8a draw: an offset in [0, deg), deg > 0
__device__ __forceinline__ int32_t draw_wr(float u, int32_t deg) {
  const float x = __fmul_rn(u, __int2float_rn(deg));
  const int32_t d = __float2int_rz(floorf(x));
  return d < deg - 1 ? d : deg - 1;
}

// sort kK values ascending (odd-even transposition: kK rounds), then EMPTY
// over every value equal to the one before it
template <int kK>
__device__ __forceinline__ void sort_dedup(int32_t (&v)[kK]) {
#pragma unroll
  for (int round = 0; round < kK; ++round) {
#pragma unroll
    for (int j = round & 1; j + 1 < kK; j += 2) {
      const int32_t a = v[j], b = v[j + 1];
      v[j] = a < b ? a : b;
      v[j + 1] = a < b ? b : a;
    }
  }
  int32_t prev = v[0];
#pragma unroll
  for (int j = 1; j < kK; ++j) {
    const int32_t cur = v[j];
    if (cur == prev) v[j] = kEmpty;
    prev = cur;
  }
}

// sort fanout values ascending (insertion sort, v in local memory) into
// orow, with EMPTY over every value equal to the one before it
__device__ __forceinline__ void sort_dedup_into(int32_t* v, int fanout,
                                                int32_t* orow) {
  for (int i = 1; i < fanout; ++i) {
    const int32_t x = v[i];
    int j = i - 1;
    for (; j >= 0 && v[j] > x; --j) v[j + 1] = v[j];
    v[j + 1] = x;
  }
  for (int j = fanout - 1; j > 0; --j)
    if (v[j] == v[j - 1]) orow[j] = kEmpty; else orow[j] = v[j];
  orow[0] = v[0];
}

// K8a's cold rows among the warp's frontier rows [row0, row0 + n) (every
// lane calls it; n <= 32): their draws into o + i * K, i a row's index in
// the warp (o in device or shared memory), each row sorted with EMPTY over
// its repeats when kDedup.  A ballot compacts the cold rows and lane pairs
// read their indptr pairs (cold_pairs); then a lane a pick: pick p is draw
// p % K of cold row p / K, its offset draw_wr(u, deg) from the row's u and
// the degree shuffled from lane p / K, kColdBatch reads a lane in flight
// and a row's draws in neighbouring lanes, so draws in one sector share a
// request (a row of degree d < K repeats offsets at no cost).  The draws
// are independent: no lane resolves a row first (K2's records), and no
// buffer of offsets splits a warp's rows into runs.  Then the lane whose
// row is cold sorts it: in registers for a compile-time K, in local memory
// otherwise.
template <int kK, bool kDedup>
__device__ __forceinline__ void cold_rows_wr(
    const int32_t* __restrict__ frontier, const float* __restrict__ u,
    int32_t* o, int64_t row0, int n, int fanout, int64_t num_node,
    const Cold& cold) {
  const int K = kK > 0 ? kK : fanout;
  const int lane = threadIdx.x & 31;
  const int32_t v = lane < n ? __ldg(frontier + row0 + lane) : -1;
  const bool mine = v >= 0 && cold_id(cold, v, num_node);
  const unsigned mask = __ballot_sync(kFull, mine);
  const int nc = __popc(mask);
  if (nc == 0) return;
  // lane r < nc: the warp's r-th cold row, its index ri in the warp
  const int ri = nth_bit(mask, lane < nc ? lane : 0);
  long long start;
  int32_t deg;
  cold_pairs(cold, __shfl_sync(kFull, v, ri), nc, &start, &deg);
  const int picks = nc * K;
  for (int p0 = 0; p0 < picks; p0 += 32 * kColdBatch) {
    int32_t got[kColdBatch], at[kColdBatch];
#pragma unroll
    for (int t = 0; t < kColdBatch; ++t) {
      const int p = p0 + 32 * t + lane;
      const int r = p < picks ? p / K : 0;
      const long long s = __shfl_sync(kFull, start, r);
      const int32_t d = __shfl_sync(kFull, deg, r);
      const int i = __shfl_sync(kFull, ri, r);
      at[t] = i * K + (p - r * K);  // the pick's slot
      got[t] = kEmpty;
      if (p < picks && d > 0)
        got[t] = __ldcg(cold.indices + s +
                        draw_wr(__ldg(u + row0 * K + at[t]), d));
    }
#pragma unroll
    for (int t = 0; t < kColdBatch; ++t)
      if (p0 + 32 * t + lane < picks) o[at[t]] = got[t];
  }
  if constexpr (kDedup) {
    __syncwarp();  // the warp's draws before a lane sorts its row
    if (mine) {
      int32_t* orow = o + lane * K;
      if constexpr (kK > 0) {
        int32_t pick[kK];
#pragma unroll
        for (int j = 0; j < kK; ++j) pick[j] = orow[j];
        sort_dedup<kK>(pick);
#pragma unroll
        for (int j = 0; j < kK; ++j) orow[j] = pick[j];
      } else {
        int32_t w[kMaxFanout];
        for (int j = 0; j < K; ++j) w[j] = orow[j];
        sort_dedup_into(w, K, orow);
      }
    }
  }
}

template <int kK, bool kDedup, bool kTiered>
__global__ void __launch_bounds__(kThreads)
sample_wr_staged_kernel(const int32_t* __restrict__ indptr,
                        const int32_t* __restrict__ indices,
                        const int32_t* __restrict__ frontier,
                        const float* __restrict__ u,
                        int32_t* __restrict__ out, int64_t num_node,
                        int64_t num_rows, bool vec, Cold cold) {
  __shared__ __align__(16) uint32_t tile[kThreads * kK];
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t row = row0 + threadIdx.x;
  const int64_t rows = num_rows - row0 < kThreads ? num_rows - row0 : kThreads;
  const int words = (int)rows * kK;
  // a cold row (kTiered) reads as an id outside the graph here, its
  // draws EMPTY until the warp's cold rows overwrite them below
  Row r{0, 0};
  if (row < num_rows)
    r = row_meta<kTiered>(indptr, frontier, row, num_node);
  const int32_t deg = r.deg;
  copy_tile(tile, reinterpret_cast<const uint32_t*>(u) + row0 * kK, words,
            vec);
  __syncthreads();

  if (row < num_rows) {
    uint32_t* trow = tile + threadIdx.x * kK;
    int32_t pick[kK];
    if (deg > 0) {
      // every offset first, then the index loads back to back
#pragma unroll
      for (int j = 0; j < kK; ++j)
        pick[j] = draw_wr(__uint_as_float(trow[j]), deg);
#pragma unroll
      for (int j = 0; j < kK; ++j)
        pick[j] = edge(indices, r, pick[j]);
      if (kDedup) sort_dedup<kK>(pick);
    } else {
#pragma unroll
      for (int j = 0; j < kK; ++j) pick[j] = kEmpty;
    }
#pragma unroll
    for (int j = 0; j < kK; ++j) trow[j] = (uint32_t)pick[j];
  }
  if constexpr (kTiered) {  // the warp's cold rows
    const int warp = threadIdx.x >> 5;
    const int64_t first = row0 + 32 * warp;
    const int64_t left = num_rows - first;
    __syncwarp();
    cold_rows_wr<kK, kDedup>(
        frontier, u, reinterpret_cast<int32_t*>(tile) + 32 * warp * kK, first,
        left < 0 ? 0 : (left < 32 ? (int)left : 32), kK, num_node, cold);
  }
  __syncthreads();
  copy_tile(reinterpret_cast<uint32_t*>(out) + row0 * kK, tile, words, vec);
}

// one row of the unstaged K8a kernel: its draws, sorted when dedup, in
// local memory (a cold row, kTiered, reads here as EMPTY)
template <bool kTiered>
__device__ __forceinline__ void wr_row(const int32_t* __restrict__ indptr,
                                       const int32_t* __restrict__ indices,
                                       const int32_t* __restrict__ frontier,
                                       const float* __restrict__ u,
                                       int32_t* __restrict__ out,
                                       int64_t num_node, int64_t row,
                                       int fanout, bool dedup) {
  const Row r = row_meta<kTiered>(indptr, frontier, row, num_node);
  const int32_t deg = r.deg;
  const float* urow = u + row * fanout;
  int32_t* orow = out + row * fanout;
  if (deg <= 0) {
    for (int j = 0; j < fanout; ++j) orow[j] = kEmpty;
    return;
  }
  int32_t v[kMaxFanout];
  for (int j = 0; j < fanout; ++j)
    v[j] = edge(indices, r, draw_wr(__ldg(urow + j), deg));
  if (dedup) {
    sort_dedup_into(v, fanout, orow);
  } else {
    for (int j = 0; j < fanout; ++j) orow[j] = v[j];
  }
}

// any fanout up to kMaxFanout: one thread per row, unstaged, the row in
// local memory; tiered, each warp then takes its rows' cold rows
template <bool kTiered>
__global__ void sample_wr_kernel(const int32_t* __restrict__ indptr,
                                 const int32_t* __restrict__ indices,
                                 const int32_t* __restrict__ frontier,
                                 const float* __restrict__ u,
                                 int32_t* __restrict__ out, int64_t num_node,
                                 int64_t num_rows, int fanout, bool dedup,
                                 Cold cold) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (!kTiered && row >= num_rows) return;
  if (row < num_rows)
    wr_row<kTiered>(indptr, indices, frontier, u, out, num_node, row, fanout,
                    dedup);
  if constexpr (kTiered) {
    const int64_t first = row - (threadIdx.x & 31);
    const int64_t left = num_rows - first;
    const int n = left <= 0 ? 0 : (left < 32 ? (int)left : 32);
    __syncwarp();  // the warp's hot rows' stores before the cold ones
    if (dedup)
      cold_rows_wr<0, true>(frontier, u, out + first * fanout, first, n,
                            fanout, num_node, cold);
    else
      cold_rows_wr<0, false>(frontier, u, out + first * fanout, first, n,
                             fanout, num_node, cold);
  }
}

template <int kK, bool kTiered>
void launch_staged(const int32_t* indptr, const int32_t* indices,
                   const int32_t* frontier, const float* u, int32_t* out,
                   long long num_node, long long num_rows, bool vec,
                   const Cold& cold, cudaStream_t s) {
  const long long blocks = (num_rows + kThreads - 1) / kThreads;
  sample_khop_staged_kernel<kK, kTiered><<<(unsigned)blocks, kThreads, 0, s>>>(
      indptr, indices, frontier, u, out, num_node, num_rows, vec, cold);
}

template <bool kTiered>
void launch_khop(const int32_t* ip, const int32_t* ix, const int32_t* fr,
                 const float* uf, int32_t* o, long long num_node,
                 long long num_rows, int fanout, bool vec, const Cold& cold,
                 cudaStream_t s) {
  switch (fanout) {
    case 5:
      launch_staged<5, kTiered>(ip, ix, fr, uf, o, num_node, num_rows, vec,
                                cold, s);
      break;
    case 10:
      launch_staged<10, kTiered>(ip, ix, fr, uf, o, num_node, num_rows, vec,
                                 cold, s);
      break;
    case 15:
      launch_staged<15, kTiered>(ip, ix, fr, uf, o, num_node, num_rows, vec,
                                 cold, s);
      break;
    default: {
      const long long blocks = (num_rows + kThreads - 1) / kThreads;
      sample_khop_kernel<kTiered><<<(unsigned)blocks, kThreads, 0, s>>>(
          ip, ix, fr, uf, o, num_node, num_rows, fanout, cold);
    }
  }
}

template <int kK, bool kDedup, bool kTiered>
void launch_wr_staged(const int32_t* indptr, const int32_t* indices,
                      const int32_t* frontier, const float* u, int32_t* out,
                      long long num_node, long long num_rows, bool vec,
                      const Cold& cold, cudaStream_t s) {
  const long long blocks = (num_rows + kThreads - 1) / kThreads;
  sample_wr_staged_kernel<kK, kDedup, kTiered>
      <<<(unsigned)blocks, kThreads, 0, s>>>(indptr, indices, frontier, u, out,
                                            num_node, num_rows, vec, cold);
}

template <bool kDedup, bool kTiered>
bool launch_wr_fixed(int fanout, const int32_t* ip, const int32_t* ix,
                     const int32_t* fr, const float* uf, int32_t* o,
                     long long num_node, long long num_rows, bool vec,
                     const Cold& cold, cudaStream_t s) {
  switch (fanout) {
    case 5:
      launch_wr_staged<5, kDedup, kTiered>(ip, ix, fr, uf, o, num_node,
                                           num_rows, vec, cold, s);
      return true;
    case 10:
      launch_wr_staged<10, kDedup, kTiered>(ip, ix, fr, uf, o, num_node,
                                            num_rows, vec, cold, s);
      return true;
    case 15:
      launch_wr_staged<15, kDedup, kTiered>(ip, ix, fr, uf, o, num_node,
                                            num_rows, vec, cold, s);
      return true;
    default:
      return false;
  }
}

template <bool kTiered>
void launch_wr(const int32_t* ip, const int32_t* ix, const int32_t* fr,
               const float* uf, int32_t* o, long long num_node,
               long long num_rows, int fanout, bool dedup, bool vec,
               const Cold& cold, cudaStream_t s) {
  const bool fixed =
      dedup ? launch_wr_fixed<true, kTiered>(fanout, ip, ix, fr, uf, o,
                                             num_node, num_rows, vec, cold, s)
            : launch_wr_fixed<false, kTiered>(fanout, ip, ix, fr, uf, o,
                                              num_node, num_rows, vec, cold,
                                              s);
  if (!fixed) {
    const long long blocks = (num_rows + kThreads - 1) / kThreads;
    sample_wr_kernel<kTiered><<<(unsigned)blocks, kThreads, 0, s>>>(
        ip, ix, fr, uf, o, num_node, num_rows, fanout, dedup, cold);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// indptr: (num_node + 1,) int32; indices: (E,) int32; frontier: (num_rows,)
// int32, EMPTY padded; u: (num_rows, fanout) float32; out: (num_rows,
// fanout) int32.  1 <= fanout <= 64.  cold_indptr, cold_indices: the whole
// graph's CSR in mapped host memory ((num_total + 1,) int64 and int32),
// read for the rows [num_node, num_total); both null and num_total ==
// num_node when the topology is not tiered.  The cold form: indptr and
// indices null with a tier, num_node the hot prefix's size; no device CSR
// is read, a cold row gets its picks and every other row EMPTY.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a fanout
// or a tier it does not take).
extern "C" int xg_sample_khop(const void* indptr, const void* indices,
                              const void* frontier, const void* u, void* out,
                              long long num_node, long long num_rows,
                              int fanout, const void* cold_indptr,
                              const void* cold_indices, long long num_total,
                              void* stream) {
  Cold cold;
  if (fanout < 1 || fanout > kMaxFanout ||
      !make_cold(cold_indptr, cold_indices, nullptr, nullptr, nullptr,
                 num_node, num_total, kNoTables, &cold) ||
      ((indptr == nullptr) != (indices == nullptr)) ||
      (indptr == nullptr && cold_indptr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const int32_t* fr = static_cast<const int32_t*>(frontier);
  const float* uf = static_cast<const float*>(u);
  int32_t* o = static_cast<int32_t*>(out);
  const bool vec = aligned16(u) && aligned16(out);
  if (cold.indptr != nullptr)
    launch_khop<true>(ip, ix, fr, uf, o, num_node, num_rows, fanout, vec, cold,
                      s);
  else
    launch_khop<false>(ip, ix, fr, uf, o, num_node, num_rows, fanout, vec,
                       cold, s);
  return (int)cudaGetLastError();
}

// K8a.  indptr, indices, frontier, u, out, the tier and the cold form as
// for xg_sample_khop; dedup != 0 is khop1 (each row sorted, EMPTY over
// repeats), 0 uniform_wr.  Returns cudaGetLastError() after the launch.
extern "C" int xg_sample_wr(const void* indptr, const void* indices,
                            const void* frontier, const void* u, void* out,
                            long long num_node, long long num_rows,
                            int fanout, int dedup, const void* cold_indptr,
                            const void* cold_indices, long long num_total,
                            void* stream) {
  Cold cold;
  if (fanout < 1 || fanout > kMaxFanout ||
      !make_cold(cold_indptr, cold_indices, nullptr, nullptr, nullptr,
                 num_node, num_total, kNoTables, &cold) ||
      ((indptr == nullptr) != (indices == nullptr)) ||
      (indptr == nullptr && cold_indptr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const int32_t* fr = static_cast<const int32_t*>(frontier);
  const float* uf = static_cast<const float*>(u);
  int32_t* o = static_cast<int32_t*>(out);
  const bool vec = aligned16(u) && aligned16(out);
  if (cold.indptr != nullptr)
    launch_wr<true>(ip, ix, fr, uf, o, num_node, num_rows, fanout, dedup != 0,
                    vec, cold, s);
  else
    launch_wr<false>(ip, ix, fr, uf, o, num_node, num_rows, fanout,
                     dedup != 0, vec, cold, s);
  return (int)cudaGetLastError();
}
