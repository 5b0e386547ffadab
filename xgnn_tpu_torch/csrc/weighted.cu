// K8b: weighted neighbour sampling, by prefix-sum search (weighted_khop_prefix)
// and by alias tables (weighted_khop, and weighted_khop_hash_dedup).
//
// Every kernel reads a frontier row v = frontier[b] as K2 does: start =
// indptr[v], deg = indptr[v+1] - start, and deg = 0 for EMPTY and for any id
// outside [0, num_node).  A row of degree 0 is all EMPTY.  Offsets into the
// edge arrays are 64-bit.  Built without --use_fast_math; every float product
// is __fmul_rn, so it is never fused into anything.
//
// K8b-prefix (xg_sample_prefix):
// For pick k of a row, x = u[b,k] * total with total = prefix[start+deg-1],
// one float32 product rounded to nearest.  The offset is the smallest off with
// prefix[start+off] > x, clamped to deg - 1; out[b,k] = indices[start+off].
// The rows of prefix are nondecreasing (the wrapper states it), so that
// offset is min(#{j < deg : prefix[start+j] <= x}, deg - 1): a count, and no
// search.
//
// Replaces: xgnn_tpu/ops/sampling.py, sample_weighted_khop_prefix (lines
// 339-424), a fixed-depth binary search, or a coarse-CDF bucket, binary
// steps and a tile-pair count, each step a 512-byte tile gather a pick.  The
// picks equal it bit for bit for the same u on nondecreasing rows.
//
// What bounds it on an H100: bytes, and in practice the latency of the
// dependent reads frontier -> indptr -> prefix -> indices.  A row of the
// products graph holds 50.6 entries on average (202 bytes).
//
// Design: one warp per frontier row; lane k holds pick k's x (and lane
// k - 32 pick k for K > 32).
// - A row of at most kDirectMax = 128 entries is read once, coalesced,
//   4 entries a lane.  Each pick's offset is a warp-wide count: a ballot of
//   "entry <= x" and a popc per 32 entries.
// - A longer row (a hub) reads its coarse row instead: the 128 prefix values
//   at offsets e_j = ceil((j+1)*deg/128) - 1, 512 bytes shared by the K picks
//   (from coarse_cdf when the caller has it, else gathered from prefix).  The
//   count j of coarse values <= x (clamped to 127) picks the bucket
//   [e_{j-1} + 1, e_j], at most ceil(deg/128) entries, which the warp then
//   counts 32 at a time.  The coarse row of every row would cost 512 bytes
//   where the mean row is 202: built with -DXG_PREFIX_DIRECT_MAX=0, every
//   row goes that way, the design this one was measured against
//   (xgnn_tpu_torch/tools/time_prefix.py).
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
//   row of deg <= K is the whole row in CSR order, EMPTY past deg.  One warp
//   per row: lane i holds draws i, i + 32, ..., the warp's draws sit in
//   shared memory, a draw is a first occurrence when no earlier draw equals
//   it (every lane scans the same word at once: a broadcast), and ballots
//   give each first occurrence its rank.
//
// Replaces: xgnn_tpu/ops/sampling.py, sample_weighted_khop (lines 217-242)
// and sample_weighted_khop_hash_dedup (248-304, two lax.sort passes a row),
// bit for bit for the same u and coin.
//
// What bounds it: bytes.  A draw reads u, coin, prob and one of alias or
// indices (16 bytes); the alias and prob reads are random 4-byte reads, each
// a 32-byte sector.  The dedup's scan is at most draws * ceil(draws/32)
// compares a lane, below the card's rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block in the warp-per-row kernels
constexpr int kMaxFanout = 64;
constexpr int kLanes = 128;  // width of a coarse CDF row
constexpr int kChunks = kLanes / 32;
constexpr int kMaxDraws = 256;
constexpr int kDrawChunks = kMaxDraws / 32;
#ifndef XG_PREFIX_DIRECT_MAX
#define XG_PREFIX_DIRECT_MAX 128
#endif
// K8b-prefix reads a row of at most this many entries whole
constexpr int kDirectMax = XG_PREFIX_DIRECT_MAX;
static_assert(kDirectMax >= 0 && kDirectMax <= kLanes,
              "a direct row fits the warp's kChunks registers");

__device__ __forceinline__ void row_meta(const int32_t* __restrict__ indptr,
                                         int32_t v, int64_t num_node,
                                         int32_t* start, int32_t* deg) {
  *start = 0;
  *deg = 0;
  if (v >= 0 && (int64_t)v < num_node) {
    *start = __ldg(indptr + v);
    *deg = __ldg(indptr + v + 1) - *start;
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

__global__ void __launch_bounds__(kWarps * 32)
sample_prefix_kernel(const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ indices,
                     const float* __restrict__ prefix,
                     const float* __restrict__ coarse,
                     const int32_t* __restrict__ frontier,
                     const float* __restrict__ u, int32_t* __restrict__ out,
                     int64_t num_node, int64_t num_rows, int fanout) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= num_rows) return;  // the whole warp: row is warp-uniform
  const int32_t v = __ldg(frontier + row);
  int32_t start, deg;
  row_meta(indptr, v, num_node, &start, &deg);
  int32_t* orow = out + row * fanout;
  if (deg <= 0) {
    for (int k = lane; k < fanout; k += 32) orow[k] = kEmpty;
    return;
  }
  const float* p = prefix + start;
  const float total = __ldg(p + deg - 1);
  const float* urow = u + row * fanout;
  // lane k holds pick k's x, and pick k + 32's
  const float x0 = lane < fanout ? __fmul_rn(__ldg(urow + lane), total) : 0.f;
  const float x1 =
      lane + 32 < fanout ? __fmul_rn(__ldg(urow + lane + 32), total) : 0.f;
  int32_t off0 = 0, off1 = 0;

  if (deg <= kDirectMax) {
    // the whole row, at most 128 entries, read once
    const int chunks = (deg + 31) >> 5;
    float r[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = lane + 32 * c;
      r[c] = c < chunks && i < deg ? __ldg(p + i) : 0.f;
    }
    for (int k = 0; k < fanout; ++k) {
      const float x = __shfl_sync(kFull, k < 32 ? x0 : x1, k & 31);
      int n = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        if (c < chunks) n += count(lane + 32 * c < deg && r[c] <= x);
      const int32_t off = n < deg - 1 ? n : deg - 1;
      if (lane == (k & 31)) (k < 32 ? off0 : off1) = off;
    }
  } else {
    // the coarse row, 128 values, shared by the K picks
    float cr[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int j = lane + 32 * c;
      cr[c] = coarse != nullptr ? __ldg(coarse + (int64_t)v * kLanes + j)
                                : __ldg(p + coarse_pos(j, deg, 0));
    }
    for (int k = 0; k < fanout; ++k) {
      const float x = __shfl_sync(kFull, k < 32 ? x0 : x1, k & 31);
      int j = 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) j += count(cr[c] <= x);
      j = j < kLanes - 1 ? j : kLanes - 1;  // x rounded up to total
      const int32_t lo = j > 0 ? coarse_pos(j - 1, deg, -1) + 1 : 0;
      const int32_t hi = coarse_pos(j, deg, 0);
      int32_t n = lo;
      for (int32_t base = lo; base <= hi; base += 32) {
        const int32_t i = base + lane;
        n += count(i <= hi && __ldg(p + i) <= x);
      }
      const int32_t off = n < deg - 1 ? n : deg - 1;
      if (lane == (k & 31)) (k < 32 ? off0 : off1) = off;
    }
  }
  if (lane < fanout) orow[lane] = __ldg(indices + ((int64_t)start + off0));
  if (lane + 32 < fanout)
    orow[lane + 32] = __ldg(indices + ((int64_t)start + off1));
}

// an alias draw of a row of degree deg > 0
__device__ __forceinline__ int32_t alias_draw(
    const int32_t* __restrict__ indices, const float* __restrict__ prob,
    const int32_t* __restrict__ alias, int32_t start, int32_t deg, float u,
    float coin) {
  const float x = __fmul_rn(u, __int2float_rn(deg));
  int32_t slot = __float2int_rz(floorf(x));
  slot = slot < deg - 1 ? slot : deg - 1;
  const int64_t e = (int64_t)start + slot;
  return coin >= __ldg(prob + e) ? __ldg(alias + e) : __ldg(indices + e);
}

// weighted_khop: one thread per pick
__global__ void sample_alias_kernel(const int32_t* __restrict__ indptr,
                                    const int32_t* __restrict__ indices,
                                    const float* __restrict__ prob,
                                    const int32_t* __restrict__ alias,
                                    const int32_t* __restrict__ frontier,
                                    const float* __restrict__ u,
                                    const float* __restrict__ coin,
                                    int32_t* __restrict__ out,
                                    int64_t num_node, int64_t num_picks,
                                    int fanout) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= num_picks) return;
  int32_t start, deg;
  row_meta(indptr, __ldg(frontier + t / fanout), num_node, &start, &deg);
  out[t] = deg > 0 ? alias_draw(indices, prob, alias, start, deg, __ldg(u + t),
                                __ldg(coin + t))
                   : kEmpty;
}

// weighted_khop_hash_dedup: one warp per row
__global__ void __launch_bounds__(kWarps * 32)
sample_alias_dedup_kernel(const int32_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const float* __restrict__ prob,
                          const int32_t* __restrict__ alias,
                          const int32_t* __restrict__ frontier,
                          const float* __restrict__ u,
                          const float* __restrict__ coin,
                          int32_t* __restrict__ out, int64_t num_node,
                          int64_t num_rows, int fanout, int draws) {
  __shared__ int32_t drawn[kWarps][kMaxDraws];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= num_rows) return;  // the whole warp
  int32_t start, deg;
  row_meta(indptr, __ldg(frontier + row), num_node, &start, &deg);
  int32_t* orow = out + row * fanout;
  if (deg <= fanout) {  // the whole row (none when deg = 0)
    for (int k = lane; k < fanout; k += 32)
      orow[k] = k < deg ? __ldg(indices + ((int64_t)start + k)) : kEmpty;
    return;
  }
  const int chunks = (draws + 31) >> 5;
  const float* urow = u + row * draws;
  const float* crow = coin + row * draws;
  int32_t* s = drawn[warp];
  int32_t val[kDrawChunks];
  bool first[kDrawChunks];
#pragma unroll
  for (int c = 0; c < kDrawChunks; ++c) {
    const int i = lane + 32 * c;
    first[c] = c < chunks && i < draws;
    val[c] = first[c] ? alias_draw(indices, prob, alias, start, deg,
                                   __ldg(urow + i), __ldg(crow + i))
                      : kEmpty;
    if (first[c]) s[i] = val[c];
  }
  __syncwarp();
  // draw i is a first occurrence when no draw j < i equals it
  for (int j = 0; j < draws; ++j) {
    const int32_t w = s[j];
#pragma unroll
    for (int c = 0; c < kDrawChunks; ++c)
      if (j < lane + 32 * c && w == val[c]) first[c] = false;
  }
  // the first occurrences in draw order: the first K of them are the row
  const unsigned below = (1u << lane) - 1u;
  int taken = 0;
#pragma unroll
  for (int c = 0; c < kDrawChunks; ++c) {
    if (c < chunks) {
      const unsigned mask = __ballot_sync(kFull, first[c]);
      const int rank = taken + __popc(mask & below);
      if (first[c] && rank < fanout) orow[rank] = val[c];
      taken += __popc(mask);
    }
  }
  for (int k = taken + lane; k < fanout; k += 32) orow[k] = kEmpty;
}

}  // namespace

// K8b-prefix.  indptr: (num_node + 1,) int32; indices, prefix: (E,) int32
// and float32, prefix nondecreasing within each row; coarse: (num_node, 128)
// float32 or null; frontier: (num_rows,) int32, EMPTY padded; u, out:
// (num_rows, fanout) float32 and int32.  1 <= fanout <= 64.  Returns
// cudaGetLastError() after the launch.
extern "C" int xg_sample_prefix(const void* indptr, const void* indices,
                                const void* prefix, const void* coarse,
                                const void* frontier, const void* u,
                                void* out, long long num_node,
                                long long num_rows, int fanout,
                                void* stream) {
  if (fanout < 1 || fanout > kMaxFanout) return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  const long long blocks = (num_rows + kWarps - 1) / kWarps;
  sample_prefix_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(indices),
      static_cast<const float*>(prefix), static_cast<const float*>(coarse),
      static_cast<const int32_t*>(frontier), static_cast<const float*>(u),
      static_cast<int32_t*>(out), num_node, num_rows, fanout);
  return (int)cudaGetLastError();
}

// K8b-alias.  indptr, indices and frontier as above; prob, alias: (E,)
// float32 and int32; u, coin: (num_rows, draws) float32; out: (num_rows,
// fanout) int32.  dedup == 0: draws == fanout, each draw a pick; dedup != 0:
// the first fanout distinct of the draws, fanout <= draws <= 256.  Returns
// cudaGetLastError() after the launch.
extern "C" int xg_sample_alias(const void* indptr, const void* indices,
                               const void* prob, const void* alias,
                               const void* frontier, const void* u,
                               const void* coin, void* out,
                               long long num_node, long long num_rows,
                               int fanout, int draws, int dedup,
                               void* stream) {
  if (fanout < 1 || fanout > kMaxFanout ||
      (dedup ? draws < fanout || draws > kMaxDraws : draws != fanout))
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
  if (dedup) {
    const long long blocks = (num_rows + kWarps - 1) / kWarps;
    sample_alias_dedup_kernel<<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        ip, ix, pr, al, fr, uf, cf, o, num_node, num_rows, fanout, draws);
  } else {
    const long long picks = num_rows * fanout;
    sample_alias_kernel<<<(unsigned)((picks + 255) / 256), 256, 0, s>>>(
        ip, ix, pr, al, fr, uf, cf, o, num_node, picks, fanout);
  }
  return (int)cudaGetLastError();
}
