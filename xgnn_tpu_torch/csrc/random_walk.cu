// K9: restart random walks with the top-K most-visited nodes (PinSAGE's
// sampler).
//
// For frontier row b with seed = frontier[b], W walkers each take L steps.
// Before step s > 0 a walker restarts at the seed where
// u_restart[s, b, w] < restart_prob (float32).  A step from node v is one
// uniform draw with replacement:
//     deg = indptr[v+1] - indptr[v]   (0 for EMPTY and any v outside
//                                      [0, num_node))
//     off = min(floor(u_step[s, b, w] * deg), deg - 1)
//     nxt = deg > 0 ? indices[indptr[v] + off] : EMPTY
// The walker visits nxt and moves there, or back to the seed when nxt is
// EMPTY.  Visits are kept walker-major (walker w's step s at w*L + s); a
// visit equal to the seed becomes EMPTY.  Each distinct visit is counted,
// the distinct visits are ranked by count, descending, ties by the position
// of their first occurrence, lower first, and the first K give
// neigh[b, :] and, as float32, weights[b, :]; slots past the distinct
// visits get EMPTY and 0.
//
// Replaces: xgnn_tpu/ops/random_walk.py, sample_random_walk (lines 38-120)
// with _uniform_step (24-35): XLA ops shaped for the TPU (a take_1d gather
// per step over the whole (B, W) walker grid, then a (B, M, M) match matrix
// and lax.top_k, whose ties go to the lower index).  The result equals that
// function's and the plain PyTorch version's bit for bit for the same
// uniforms: the product u * deg is one float32 multiply rounded to nearest
// (__fmul_rn), deg is converted rounded to nearest, the restart test is a
// float32 compare, and the file is built without --use_fast_math.
//
// What bounds it on an H100: the latency of L dependent steps, each a read
// of indptr[v], indptr[v+1] and then indices[start + off] at random
// addresses; 12 bytes a walker-step, but two 32-byte sectors (three where
// v % 8 == 7 puts indptr[v + 1] in the next one).  The count
// and the ranking are O(M^2) integer compares per row (M = W*L, 144 at the
// bench's W = 4, L = 3), far below the card's rate.
//
// Design: one thread per walker.  A block of up to 256 threads holds the W
// walkers of up to 256 / W seeds (at most 2048 visits: 16 KB of shared
// memory for the visits and their counts).  Each walker takes its L
// dependent steps alone and writes its visits into shared memory; then the
// W threads of a seed share its count and its ranking, visit i going to
// thread i % W.  Each first occurrence's rank among the distinct visits is
// counted directly (no sort), and it writes its slot if the rank is below
// K.  For the bench's (W, L) = (4, 3) the kernel is built for those
// constants; any other W*L up to kMaxVisits takes the same code with
// run-time bounds.  Measured against one thread per seed walking its W
// walkers in registers, at the bench's two layers (8,000 and 59,392 seeds)
// on an H100 80GB HBM3 at 700 W: 4.27 against 6.29-6.31 us and
// 20.25-20.29 against 21.02-21.06 us a launch
// (xgnn_tpu_torch/tools/time_walk.py, one process each, in turns): four
// times the threads hide more of the step latency.
//
// The tiered topology (tier.cuh): a walker standing on a cold node takes
// its step from the whole graph's CSR in mapped host memory, in the same
// launch, with the same arithmetic on the same uniform: the walk equals
// the untiered walk over the whole CSR.  What bounds it: the requests that
// the link and the host answer (tools/host_reads.py), and at layer 0, less
// than a wave, the chain of dependent round trips.  Design (walk_tiered):
// each seed's first edge and degree are read once, before the walk, and
// kept in its walkers' registers, so a walker standing on its seed (all of
// step 0 and, at restart 0.5, half of the later steps) reads no indptr, hot
// or cold, and a cold step from the seed is one round trip; a cold seed's
// pair is read by lane pairs, asked for by the seed's first lane in the
// warp.  At a step from a cold node other than the seed, a ballot compacts
// the warp's walkers there and lane pairs read their pairs in one
// instruction; then each walker reads its index.  The block is padded to
// whole warps for the ballots.  At PinSAGE's two layers at 0.85 (NVIDIA
// H100 80GB HBM3, 700.00 W, tools/time_samplers.py --tiered, 226M
// scattered 32-byte mapped reads a second; PERF.md section 6) it takes
// 0.0737 / 0.4300 device ms against 0.1244 / 0.7293 for a walker reading
// its node's indptr pair in
// two loads at every step, its seed's again at each restart.  The kernel is
// built twice, kTiered false (the untiered launch, no cold branch) and
// true.  Replaces, for the cold steps:
// xgnn_tpu/ops/random_walk.py:83-103, each step's host callback
// (xgnn_tpu/parallel/ggms.py, cold_sample_callback) over the walkers that
// stand on cold nodes.
//
// walk_topk_kernel (xg_walk_topk) is the count and the ranking alone, over
// visits walked elsewhere: the walk over the partitioned topology, whose
// every step is an owner exchange (xgnn_tpu_torch/parallel/dist_topology.py).
// Replaces: xgnn_tpu/parallel/dist_topology.py:405-418, the same (B, M, M)
// match matrix and lax.top_k as above.  Launches are counted as walk_topk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier.cuh"

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kWalkThreads = 256;
constexpr int kMaxVisits = 64;

// the step's offset in a row of degree deg > 0
__device__ __forceinline__ int32_t step_offset(float u, int32_t deg) {
  const float x = __fmul_rn(u, __int2float_rn(deg));
  const int32_t off = __float2int_rz(floorf(x));
  return off < deg - 1 ? off : deg - 1;
}

// one uniform step of the untiered walk from v; EMPTY where v has no
// neighbour
__device__ __forceinline__ int32_t walk_step(const int32_t* __restrict__ indptr,
                                             const int32_t* __restrict__ indices,
                                             int64_t num_node, int32_t v,
                                             float u) {
  if (v < 0 || (int64_t)v >= num_node) return kEmpty;
  const int32_t start = __ldg(indptr + v);
  const int32_t deg = __ldg(indptr + v + 1) - start;
  if (deg <= 0) return kEmpty;
  return __ldg(indices + ((int64_t)start + step_offset(u, deg)));
}

// The pair of cold node v for every lane of the warp that asks (every
// lane calls it): a ballot compacts the askers and lane pairs read their
// pairs (cold_pairs); the lane gets the pair that lane `me` asked for, and
// returns false, reading nothing, when no lane asks.
__device__ __forceinline__ bool warp_pairs(const Cold& cold, bool ask,
                                           int32_t v, int me,
                                           long long* start, int32_t* deg) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned mask = __ballot_sync(kFull, ask);
  if (mask == 0) return false;
  const int n = __popc(mask);
  cold_pairs(cold, __shfl_sync(kFull, v, nth_bit(mask, lane < n ? lane : 0)),
             n, start, deg);
  const int r = __popc(mask & ((1u << me) - 1u));
  *start = __shfl_sync(kFull, *start, r);
  *deg = __shfl_sync(kFull, *deg, r);
  return true;
}

// The walk of the tiered build (every lane of the warp calls it; the block
// is whole warps, so a ballot holds all 32 lanes): walker w of seed takes
// nl steps, its visits into vis where active.  The seed's first edge and
// degree are read once, before the walk, and kept: a walker that stands on
// its seed reads no indptr, hot or cold, and a cold seed's pair is read by
// the warp's lane pairs, asked for by the seed's first lane in the warp.
// A step from a cold node that is not the seed: a ballot compacts the
// warp's walkers there, lane pairs read their pairs in one instruction,
// and each walker reads its index, hot or cold, in the same warp
// instruction as the others.  The arithmetic and the uniforms are the
// untiered walk's, so the walk equals it over the whole CSR.
template <int kL>
__device__ __forceinline__ void walk_tiered(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    const float* __restrict__ u_step, const float* __restrict__ u_restart,
    const Cold& cold, int64_t num_node, int64_t num_rows, int64_t row,
    int nw, int w, int nl, float restart_prob, bool active, int32_t seed,
    int32_t* vis) {
  const int lane = threadIdx.x & 31;
  const bool seed_cold = seed >= 0 && cold_id(cold, seed, num_node);
  long long seed_start = 0, start;
  int32_t seed_deg = 0, deg;
  if (seed >= 0 && (int64_t)seed < num_node) {
    const int32_t st = __ldg(indptr + seed);
    seed_start = st;
    seed_deg = __ldg(indptr + seed + 1) - st;
  }
  const int lead = lane - (w < lane ? w : lane);  // the seed's first lane
  if (warp_pairs(cold, seed_cold && lead == lane, seed, lead, &start, &deg) &&
      seed_cold) {
    seed_start = start;
    seed_deg = deg;
  }
  int32_t cur = seed;
#pragma unroll
  for (int s = 0; s < (kL > 0 ? kL : nl); ++s) {
    const int64_t at = ((int64_t)s * num_rows + row) * nw + w;
    float u = 0.0f;
    if (active) {
      if (s > 0 && __ldg(u_restart + at) < restart_prob) cur = seed;
      u = __ldg(u_step + at);
    }
    bool on_cold = seed_cold;
    start = seed_start;
    deg = seed_deg;
    if (cur != seed) {
      on_cold = cur >= 0 && cold_id(cold, cur, num_node);
      deg = 0;
      if (cur >= 0 && (int64_t)cur < num_node) {
        const int32_t st = __ldg(indptr + cur);
        start = st;
        deg = __ldg(indptr + cur + 1) - st;
      }
    }
    const bool ask = cur != seed && on_cold;
    long long cs;
    int32_t cd;
    if (warp_pairs(cold, ask, cur, lane, &cs, &cd) && ask) {
      start = cs;
      deg = cd;
    }
    int32_t nxt = kEmpty;
    if (deg > 0) {
      const int64_t e = start + step_offset(u, deg);
      nxt = on_cold ? __ldcg(cold.indices + e) : __ldg(indices + e);
    }
    if (active) vis[w * nl + s] = nxt == seed ? kEmpty : nxt;
    cur = nxt == kEmpty ? seed : nxt;
  }
}

// Each first occurrence among a seed's m visits gets its count, a repeat or
// an EMPTY visit 0; thread w of the seed's nw takes visits w, w + nw, ...
__device__ __forceinline__ void count_visits(const int32_t* vis, int32_t* cnt,
                                             int m, int w, int nw) {
  for (int i = w; i < m; i += nw) {
    const int32_t v = vis[i];
    int32_t c = 0;
    bool first = v != kEmpty;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      const bool eq = vis[j] == v;
      c += eq;
      if (j < i && eq) first = false;
    }
    cnt[i] = first ? c : 0;
  }
}

// The distinct visits ranked by count, higher first, then by position,
// lower first: the first fanout into nrow and wrow, EMPTY and 0 past them
// (after count_visits and a barrier)
__device__ __forceinline__ void rank_visits(const int32_t* vis,
                                            const int32_t* cnt, int m, int w,
                                            int nw, int fanout, int32_t* nrow,
                                            float* wrow) {
  int distinct = 0;
#pragma unroll
  for (int j = 0; j < m; ++j) distinct += cnt[j] > 0;
  for (int i = w; i < m; i += nw) {
    const int32_t ci = cnt[i];
    if (ci == 0) continue;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < m; ++j)
      rank += cnt[j] > ci || (cnt[j] == ci && j < i);
    if (rank < fanout) {
      nrow[rank] = vis[i];
      wrow[rank] = (float)ci;
    }
  }
  for (int k = distinct + w; k < fanout; k += nw) {
    nrow[k] = kEmpty;
    wrow[k] = 0.0f;
  }
}

// kW, kL > 0: built for those constants; 0: run-time w and l.  A block
// holds the walkers of `rows` seeds, thread t walker t % W of seed t / W.
template <int kW, int kL, bool kTiered>
__global__ void __launch_bounds__(kWalkThreads)
random_walk_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const int32_t* __restrict__ frontier,
                   const float* __restrict__ u_step,
                   const float* __restrict__ u_restart,
                   int32_t* __restrict__ neigh, float* __restrict__ weights,
                   int64_t num_node, int64_t num_rows, int w_rt, int l_rt,
                   int fanout, float restart_prob, int rows, Cold cold) {
  constexpr bool kFixed = kW > 0 && kL > 0;
  const int nw = kFixed ? kW : w_rt;
  const int nl = kFixed ? kL : l_rt;
  const int m = nw * nl;
  extern __shared__ int32_t smem[];
  const int local = threadIdx.x / nw, w = threadIdx.x % nw;
  const int64_t row = (int64_t)blockIdx.x * rows + local;
  const bool active = local < rows && row < num_rows;
  int32_t* vis = smem + local * m;
  int32_t* cnt = smem + rows * m + local * m;
  int32_t seed = kEmpty;
  if constexpr (kTiered) {
    seed = active ? __ldg(frontier + row) : kEmpty;
    walk_tiered<kL>(indptr, indices, u_step, u_restart, cold, num_node,
                    num_rows, row, nw, w, nl, restart_prob, active, seed,
                    vis);
  } else if (active) {
    seed = __ldg(frontier + row);
    int32_t cur = seed;
#pragma unroll
    for (int s = 0; s < nl; ++s) {
      const int64_t at = ((int64_t)s * num_rows + row) * nw + w;
      if (s > 0 && __ldg(u_restart + at) < restart_prob) cur = seed;
      const int32_t nxt =
          walk_step(indptr, indices, num_node, cur, __ldg(u_step + at));
      vis[w * nl + s] = nxt == seed ? kEmpty : nxt;
      cur = nxt == kEmpty ? seed : nxt;
    }
  }
  __syncthreads();
  if (active) count_visits(vis, cnt, m, w, nw);
  __syncthreads();
  if (active)
    rank_visits(vis, cnt, m, w, nw, fanout, neigh + row * fanout,
                weights + row * fanout);
}

// The count and the ranking alone, over visits already walked (the walk
// over the partitioned topology, whose steps are exchanges): visits is
// (num_rows, m) walker-major; a visit equal to the row's seed becomes
// EMPTY.  A block holds `rows` seeds, nw threads each.
__global__ void __launch_bounds__(kWalkThreads)
walk_topk_kernel(const int32_t* __restrict__ visits,
                 const int32_t* __restrict__ frontier,
                 int32_t* __restrict__ neigh, float* __restrict__ weights,
                 int64_t num_rows, int m, int nw, int fanout, int rows) {
  extern __shared__ int32_t smem[];
  const int local = threadIdx.x / nw, w = threadIdx.x % nw;
  const int64_t row = (int64_t)blockIdx.x * rows + local;
  const bool active = local < rows && row < num_rows;
  int32_t* vis = smem + local * m;
  int32_t* cnt = smem + rows * m + local * m;
  if (active) {
    const int32_t seed = __ldg(frontier + row);
    for (int i = w; i < m; i += nw) {
      const int32_t v = __ldg(visits + row * m + i);
      vis[i] = v == seed ? kEmpty : v;
    }
  }
  __syncthreads();
  if (active) count_visits(vis, cnt, m, w, nw);
  __syncthreads();
  if (active)
    rank_visits(vis, cnt, m, w, nw, fanout, neigh + row * fanout,
                weights + row * fanout);
}

// sizes: at most 2048 visits a block (16 KB of shared memory)
template <bool kTiered>
void launch_walk(const int32_t* ip, const int32_t* ix, const int32_t* fr,
                 const float* us, const float* ur, int32_t* nb, float* wt,
                 long long num_node, long long num_rows, int num_walk,
                 int walk_len, int fanout, float restart_prob,
                 const Cold& cold, cudaStream_t s) {
  const int m = num_walk * walk_len;
  int rows = kWalkThreads / num_walk;
  if (rows * m > 2048) rows = 2048 / m;
  const unsigned blocks = (unsigned)((num_rows + rows - 1) / rows);
  // tiered: whole warps, for the cold steps' ballots
  const unsigned threads =
      kTiered ? (unsigned)((rows * num_walk + 31) / 32 * 32)
              : (unsigned)(rows * num_walk);
  const size_t smem = (size_t)2 * rows * m * sizeof(int32_t);
  if (num_walk == 4 && walk_len == 3) {
    random_walk_kernel<4, 3, kTiered><<<blocks, threads, smem, s>>>(
        ip, ix, fr, us, ur, nb, wt, num_node, num_rows, num_walk, walk_len,
        fanout, restart_prob, rows, cold);
  } else {
    random_walk_kernel<0, 0, kTiered><<<blocks, threads, smem, s>>>(
        ip, ix, fr, us, ur, nb, wt, num_node, num_rows, num_walk, walk_len,
        fanout, restart_prob, rows, cold);
  }
}

}  // namespace

// indptr: (num_node + 1,) int32; indices: (E,) int32; frontier: (num_rows,)
// int32, EMPTY padded; u_step, u_restart: (walk_len, num_rows, num_walk)
// float32 (u_restart[0] is not read); neigh: (num_rows, fanout) int32;
// weights: (num_rows, fanout) float32.  1 <= num_walk * walk_len <= 64 and
// 1 <= fanout <= num_walk * walk_len.  cold_indptr, cold_indices: the whole
// graph's CSR in mapped host memory ((num_total + 1,) int64 and int32),
// read for the nodes [num_node, num_total); both null and num_total ==
// num_node when the topology is not tiered.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for sizes or a tier it does not
// take).
extern "C" int xg_random_walk(const void* indptr, const void* indices,
                              const void* frontier, const void* u_step,
                              const void* u_restart, void* neigh,
                              void* weights, long long num_node,
                              long long num_rows, int num_walk, int walk_len,
                              int fanout, float restart_prob,
                              const void* cold_indptr,
                              const void* cold_indices, long long num_total,
                              void* stream) {
  Cold cold;
  if (num_walk < 1 || walk_len < 1 || num_walk * walk_len > kMaxVisits ||
      fanout < 1 || fanout > num_walk * walk_len ||
      !make_cold(cold_indptr, cold_indices, nullptr, nullptr, nullptr,
                 num_node, num_total, kNoTables, &cold))
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const int32_t* fr = static_cast<const int32_t*>(frontier);
  const float* us = static_cast<const float*>(u_step);
  const float* ur = static_cast<const float*>(u_restart);
  int32_t* nb = static_cast<int32_t*>(neigh);
  float* wt = static_cast<float*>(weights);
  if (cold.indptr != nullptr)
    launch_walk<true>(ip, ix, fr, us, ur, nb, wt, num_node, num_rows, num_walk,
                      walk_len, fanout, restart_prob, cold, s);
  else
    launch_walk<false>(ip, ix, fr, us, ur, nb, wt, num_node, num_rows,
                       num_walk, walk_len, fanout, restart_prob, cold, s);
  return (int)cudaGetLastError();
}

// visits: (num_rows, num_walk * walk_len) int32, walker-major (walker w's
// step s at w * walk_len + s), EMPTY where a walker had no step; frontier:
// (num_rows,) int32; neigh, weights: (num_rows, fanout).  The same limits
// as xg_random_walk.  Returns cudaGetLastError() after the launch.
extern "C" int xg_walk_topk(const void* visits, const void* frontier,
                            void* neigh, void* weights, long long num_rows,
                            int num_walk, int walk_len, int fanout,
                            void* stream) {
  const int m = num_walk * walk_len;
  if (num_walk < 1 || walk_len < 1 || m > kMaxVisits || fanout < 1 ||
      fanout > m)
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  int rows = kWalkThreads / num_walk;
  if (rows * m > 2048) rows = 2048 / m;
  const unsigned blocks = (unsigned)((num_rows + rows - 1) / rows);
  const size_t smem = (size_t)2 * rows * m * sizeof(int32_t);
  walk_topk_kernel<<<blocks, rows * num_walk, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(visits),
      static_cast<const int32_t*>(frontier), static_cast<int32_t*>(neigh),
      static_cast<float*>(weights), num_rows, m, num_walk, fanout, rows);
  return (int)cudaGetLastError();
}
