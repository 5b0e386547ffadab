// The tiered topology's host half, as the samplers read it: K2 and K8a
// (sampling.cu), K8b's three forms (weighted.cu) and K9 (random_walk.cu).
//
// A tiered topology keeps the hot node-id prefix [0, num_node) of the CSR,
// and of the tables its sample type reads, on the card; the whole graph's
// CSR and tables stay in pinned, mapped host memory, and a row num_node <=
// v < num_total (a cold row) is read there in place, in the same launch as
// the hot rows, with 64-bit offsets (the host CSR may hold 2^31 edges or
// more).  The host reads are plain ld.global.cg loads (L2 only; never the
// read-only path or cp.async), each a PCIe round trip.  Each kernel takes
// the tier as a template flag, kTiered: an untiered launch compiles no cold
// branch, so a tier costs the untiered main path nothing.
//
// Every C entry point that takes a tier builds it with make_cold from its
// last arguments (the host arrays' device addresses and num_total), in the
// order of ops/_build.py's SIGNATURES and ops/sampling.py's _cold_args.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The host CSR and tables of a tiered topology, for the rows [num_node,
// num_total) of the whole graph (null pointers, and num_total == num_node,
// when the topology is not tiered)
struct Cold {
  const long long* indptr;  // (num_total + 1,) int64
  const int32_t* indices;   // int32
  const float* prob;        // the alias forms' tables
  const int32_t* alias;
  const float* prefix;      // the prefix form's table
  long long num_total;
};

// the tables a form reads besides the indptr and the indices
enum ColdTables { kNoTables = 0, kAliasTables = 1, kPrefixTable = 2 };

// The tier from an entry point's arguments: all null with num_total ==
// num_node (not tiered), or the host indptr, the indices and the `tables`
// with num_total >= num_node.  false for anything else.
inline bool make_cold(const void* indptr, const void* indices,
                      const void* prob, const void* alias,
                      const void* prefix, long long num_node,
                      long long num_total, ColdTables tables, Cold* cold) {
  *cold = Cold{static_cast<const long long*>(indptr),
               static_cast<const int32_t*>(indices),
               static_cast<const float*>(prob),
               static_cast<const int32_t*>(alias),
               static_cast<const float*>(prefix), num_total};
  if (indptr == nullptr) {
    cold->num_total = num_node;
    return num_total == num_node;
  }
  return indices != nullptr && num_total >= num_node &&
         (tables != kAliasTables || (prob != nullptr && alias != nullptr)) &&
         (tables != kPrefixTable || prefix != nullptr);
}

// v names a cold row: past the hot prefix, inside the whole graph
__device__ __forceinline__ bool cold_id(const Cold& cold, int32_t v,
                                        int64_t num_node) {
  return (int64_t)v >= num_node && (int64_t)v < cold.num_total;
}

// a cold row's first edge (64-bit) and degree (it fits int32)
__device__ __forceinline__ void cold_row(const Cold& cold, int32_t v,
                                         int64_t* start, int32_t* deg) {
  const long long s = __ldcg(cold.indptr + v);
  *start = s;
  *deg = (int32_t)(__ldcg(cold.indptr + v + 1) - s);
}

// The position of the (r + 1)-th set bit of mask (r < popc(mask))
__device__ __forceinline__ int nth_bit(unsigned mask, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(mask & ((1u << w) - 1u));
    if (r >= c) {
      r -= c;
      mask >>= w;
      pos += w;
    }
  }
  return pos;
}

// The indptr pairs of a warp's n <= 32 cold nodes, compacted by a ballot
// (every lane calls it): lane r < n names the r-th node, cv.  Lanes 2r and
// 2r + 1 read node r's two 8-byte halves in one instruction, so 16 pairs
// go out as one warp load (a second for nodes 16-31) and neighbouring
// pairs share a request.  Lane r < n gets its node's first edge and
// degree; the other lanes degree 0.
__device__ __forceinline__ void cold_pairs(const Cold& cold, int32_t cv,
                                           int n, long long* start,
                                           int32_t* deg) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  long long e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * h + (lane >> 1);
    const int32_t vr = __shfl_sync(full, cv, r);
    e[h] = r < n ? __ldcg(cold.indptr + vr + (lane & 1)) : 0;
  }
  const int src = (2 * lane) & 31;
  const long long s0 = __shfl_sync(full, e[0], src);
  const long long t0 = __shfl_sync(full, e[0], src + 1);
  const long long s1 = __shfl_sync(full, e[1], src);
  const long long t1 = __shfl_sync(full, e[1], src + 1);
  *start = lane < 16 ? s0 : s1;
  *deg = lane < n ? (int32_t)((lane < 16 ? t0 : t1) - *start) : 0;
}

// an element of a hot or a cold array: the read-only path on the card, a
// plain load from host memory
template <bool kTiered, typename T>
__device__ __forceinline__ T rd(const T* p, bool cold) {
  return kTiered && cold ? __ldcg(p) : __ldg(p);
}

}  // namespace
