// K6: full-graph aggregation over a CSR graph, for layer-wise inference.
//
// K6a, the SpMM:  out[v, :] = sum over e in [indptr[v], indptr[v+1]) of
//                              h[indices[e], :]
//                 times 1 / max(deg(v), 1) in its mean form.
// K6b, GAT's exact segment-softmax aggregate, per head hd:
//   score(v, u) = leaky(el[v, hd] + er[u, hd])
//   w(v, u)     = exp(score(v, u) - max over the row's u of score(v, .))
//   out[v, hd, :] = sum_u w * feat[u, hd, :] / max(sum_u w, 1e-9)
// An empty row gives a zero row in both.  Ids outside [0, num_rows) are
// clipped into it, as jnp.take(mode="clip") does.
//
// Replaces: xgnn_tpu/ops/spmm.py, spmm_csr (:29-72) with
// spmm_csr_planned (:437-483), and gat_aggregate_csr (:114-177) with
// segment_max_csr (:75-111) and gat_aggregate_planned (:617-691).  On the
// TPU they were XLA ops (an edge-chunked scan of gathers and sorted
// scatter-adds, then a degree-bucketed plan of padded slabs); the plan is a
// TPU transaction-cost workaround and is not ported.
//
// What bounds them on an H100: bytes.  Every edge reads its neighbour's
// row (K6b also its er entries): at products scale (123,999,946 edges) a
// 256-wide layer reads 127 GB a row a pick, 38.8 ms at 3.35 TB/s, against
// 1.65 ms for the distinct rows read once.  The tables (1.25-2.5 GB) are
// far larger than the 50 MB L2, so the per-pick bytes are the realistic
// bound.  One add (K6a) or a few multiply-adds and an exp (K6b) per
// element read are far below the card's arithmetic rate.
//
// Design: one warp per CSR row, in a grid-stride loop over the rows.  The
// warp loads the row's ids 32 at a time in one coalesced read and hands
// them round by shuffles; it issues kGroup neighbours' row loads before it
// consumes them, so several rows are in flight a warp (K4's forward,
// csrc/fanout.cu, is the pattern).  Lanes hold 16-byte column slices
// (float4) where the width is a multiple of 4 and the tables are aligned,
// else single floats (the 47-wide logits layer): two slices a lane cover a
// 256-wide row in one pass.  K6a sums in CSR order from 0 in registers, with
// no atomics and no zero fill, multiplies by the mean's factor and writes
// each row once with an evict-first store; a row of at most hub_cap edges
// equals the plain version's in-order index_add_ bit for bit.
//
// K6b keeps an online softmax a head: a running max and sum, and the
// weighted row, so the row is read once (JAX reads the scores twice, in
// two passes).  Each edge is scored once a head: lane j loads er[id_j, h]
// for the pass's heads (at most 8; a wider row takes passes of 8 heads),
// forms leaky(el[v, h] + er[id_j, h]), and the warp takes the batch's max
// and weight sum by shuffles; w_j = exp(s_j - max) is taken once an edge
// and head and put in shared memory, where every lane of the head reads
// it, and the lanes' slices are rescaled once a batch of up to 32 edges,
// so the inner loop is a load and a multiply-add an element.  The next
// batch's ids and the first group's rows are in flight while a batch is
// scored.  At one head the feature rows are read evict-first, so that er
// (4 bytes a node) stays in the L2 for the next edge of its node, and the
// scalar rows (the 47-wide logits layer) run 48 warps an SM, 4 edges'
// rows in flight a warp: that layer waits on the latency of its 188-byte
// rows, not on its bytes.  The result is divided (IEEE) by max(sum,
// 1e-9).
//
// Rows with more than hub_cap edges (the products graph's largest degree
// is 18,969; JAX's plan splits rows at 2048) would leave one warp working
// long after the others: the rows kernel skips them and a second kernel
// gives each a block.  Its warps each take one contiguous part of the row
// (the split depends only on the degree), and warp 0 combines the parts in
// warp order (K6b: the parts' maxima and sums rescaled to the largest
// maximum), so the result is deterministic, though its rounding is not the
// single chain of a short row.  The blocks of the second kernel find the
// hub rows themselves, 256 rows at a time, so nothing waits on the host.
//
// K6a's float16 form (xg_spmm_csr_f16; full-graph inference's layer 0 over
// an F16 feature file) rounds where JAX's spmm_csr_planned rounds over a
// float16 h (xgnn_tpu/ops/spmm.py :374-394, :455): a row is cut into
// segments of `seg` (2048) edges from its start, each segment's rows are
// read as float16, widened exactly and summed in float32 in CSR order, the
// sum is rounded to float16 (jnp.sum's upcast), the mean form multiplies it
// by the float32 1 / max(deg, 1) and rounds again, and the segments are
// added into a float16 accumulator, each addition rounded.  A row of one
// segment is the rows kernel's, a warp a row; a longer row is the hub
// kernel's, whose warps take its segments 8 at a time and warp 0 adds them
// in the order of JAX's plan: the buckets run from the smallest cap up, so
// a last partial segment of at most first_max (1536, the cap below 2048 in
// JAX's fine buckets) edges comes first, and the full segments (and a
// longer partial one, in their bucket) follow from the row's start.  The
// reads are 8 bytes (4 float16) a lane where the width is a multiple of 4
// and the tables are 8-byte aligned, else 2 bytes.  Bytes bound it as they
// bound the float32 form, at half the row's bytes.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 8;  // neighbours whose row loads fly together
constexpr float kGatEps = 1e-9f;

__device__ __forceinline__ int32_t clip_id(int32_t r, int32_t num_rows) {
  return r < 0 ? 0 : (r >= num_rows ? num_rows - 1 : r);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

template <typename V>
__device__ __forceinline__ V zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero_value<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// a * q, rounded once (never fused into a later add)
__device__ __forceinline__ float vmul(float a, float q) {
  return __fmul_rn(a, q);
}
__device__ __forceinline__ float4 vmul(float4 a, float q) {
  return make_float4(__fmul_rn(a.x, q), __fmul_rn(a.y, q), __fmul_rn(a.z, q),
                     __fmul_rn(a.w, q));
}

// acc + w * x
__device__ __forceinline__ float vfma(float acc, float w, float x) {
  return acc + w * x;
}
__device__ __forceinline__ float4 vfma(float4 acc, float w, float4 x) {
  return make_float4(acc.x + w * x.x, acc.y + w * x.y, acc.z + w * x.z,
                     acc.w + w * x.w);
}

__device__ __forceinline__ float vdiv(float a, float q) {
  return __fdiv_rn(a, q);
}
__device__ __forceinline__ float4 vdiv(float4 a, float q) {
  return make_float4(__fdiv_rn(a.x, q), __fdiv_rn(a.y, q), __fdiv_rn(a.z, q),
                     __fdiv_rn(a.w, q));
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// ---- K6a ----------------------------------------------------------------

// A table's slice S as the float32 slice the sums take: float4 and float
// as they are, 4 float16 (uint2) or one (uint16_t) widened exactly.
template <typename S>
struct Wide {
  using T = S;
};
template <>
struct Wide<uint2> {
  using T = float4;
};
template <>
struct Wide<uint16_t> {
  using T = float;
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float half_bits(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)(b & 0xffffu)));
}
__device__ __forceinline__ float widen(uint16_t v) { return half_bits(v); }
__device__ __forceinline__ float4 widen(uint2 v) {  // low half first
  return make_float4(half_bits(v.x), half_bits(v.x >> 16), half_bits(v.y),
                     half_bits(v.y >> 16));
}

// acc[u] += h[indices[k], c0 + lane + 32 u] for k in [s, e), in order, each
// slice widened to float32.  The warp's lanes all call it with the same s,
// e and c0.
template <typename S, int kV>
__device__ __forceinline__ void sum_edges(const int32_t* __restrict__ indices,
                                          const S* __restrict__ h, int64_t s,
                                          int64_t e, int32_t num_rows,
                                          int64_t wv, int64_t c0, int lane,
                                          typename Wide<S>::T (&acc)[kV]) {
  using V = typename Wide<S>::T;
  for (int64_t k0 = s; k0 < e; k0 += 32) {
    const int n = (int)min64(32, e - k0);
    int32_t id = 0;
    if (lane < n) id = clip_id(__ldg(indices + k0 + lane), num_rows);
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      V v[kGroup][kV];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int32_t r = __shfl_sync(kFull, id, (g0 + j) & 31);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          const int64_t c = c0 + lane + 32 * u;
          v[j][u] = zero_value<V>();
          if (g0 + j < n && c < wv)
            v[j][u] = widen(__ldg(h + (int64_t)r * wv + c));
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (g0 + j < n) {
#pragma unroll
          for (int u = 0; u < kV; ++u) acc[u] = vadd(acc[u], v[j][u]);
        }
      }
    }
  }
}

template <typename V, int kV, bool kMean>
__device__ __forceinline__ void store_row(V* __restrict__ orow,
                                          const V (&acc)[kV], float inv,
                                          int64_t wv, int64_t c0, int lane) {
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    const int64_t c = c0 + lane + 32 * u;
    if (c < wv) __stcs(orow + c, kMean ? vmul(acc[u], inv) : acc[u]);
  }
}

// 1 / max(deg, 1), as the plain version's 1.0 / clamp(deg, min=1) in float32
__device__ __forceinline__ float inverse_degree(int64_t deg) {
  return __fdiv_rn(1.f, (float)(deg > 1 ? deg : 1));
}

template <typename V, int kV, bool kMean>
__global__ void __launch_bounds__(kThreads)
spmm_rows_kernel(const int32_t* __restrict__ indptr,
                 const int32_t* __restrict__ indices, const V* __restrict__ h,
                 V* __restrict__ out, int64_t num_node, int32_t num_rows,
                 int64_t wv, int64_t hub_cap) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < num_node; row += warps) {
    const int64_t s = __ldg(indptr + row), e = __ldg(indptr + row + 1);
    if (e - s > hub_cap) continue;  // the hub kernel's
    const float inv = kMean ? inverse_degree(e - s) : 1.f;
    for (int64_t c0 = 0; c0 < wv; c0 += 32 * kV) {
      V acc[kV];
#pragma unroll
      for (int u = 0; u < kV; ++u) acc[u] = zero_value<V>();
      sum_edges<V, kV>(indices, h, s, e, num_rows, wv, c0, lane, acc);
      store_row<V, kV, kMean>(out + row * wv, acc, inv, wv, c0, lane);
    }
  }
}

// The hub rows of rows [base, base + kThreads) into hubs; returns how many.
// Every thread of the block calls it.
__device__ __forceinline__ int find_hubs(const int32_t* __restrict__ indptr,
                                         int64_t base, int64_t num_node,
                                         int64_t hub_cap, int32_t* hubs,
                                         int* num_hubs) {
  if (threadIdx.x == 0) *num_hubs = 0;
  __syncthreads();
  const int64_t row = base + threadIdx.x;
  if (row < num_node && __ldg(indptr + row + 1) - __ldg(indptr + row) > hub_cap)
    hubs[atomicAdd(num_hubs, 1)] = (int32_t)row;
  __syncthreads();
  return *num_hubs;
}

// warp w's part of a hub row [s, e): the same split for every launch
__device__ __forceinline__ void warp_part(int64_t s, int64_t e, int warp,
                                          int64_t* ws, int64_t* we) {
  const int64_t per = (e - s + kWarps - 1) / kWarps;
  *ws = min64(e, s + warp * per);
  *we = min64(e, *ws + per);
}

template <typename V, int kV, bool kMean>
__global__ void __launch_bounds__(kThreads)
spmm_hub_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices, const V* __restrict__ h,
                V* __restrict__ out, int64_t num_node, int32_t num_rows,
                int64_t wv, int64_t hub_cap) {
  __shared__ int32_t hubs[kThreads];
  __shared__ int num_hubs;
  __shared__ V part[kWarps][32 * kV];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < num_node;
       base += (int64_t)gridDim.x * kThreads) {
    const int nh = find_hubs(indptr, base, num_node, hub_cap, hubs, &num_hubs);
    for (int i = 0; i < nh; ++i) {
      const int64_t row = hubs[i];
      const int64_t s = __ldg(indptr + row), e = __ldg(indptr + row + 1);
      int64_t ws, we;
      warp_part(s, e, warp, &ws, &we);
      for (int64_t c0 = 0; c0 < wv; c0 += 32 * kV) {
        V acc[kV];
#pragma unroll
        for (int u = 0; u < kV; ++u) acc[u] = zero_value<V>();
        sum_edges<V, kV>(indices, h, ws, we, num_rows, wv, c0, lane, acc);
#pragma unroll
        for (int u = 0; u < kV; ++u) part[warp][lane + 32 * u] = acc[u];
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int u = 0; u < kV; ++u) {
            acc[u] = part[0][lane + 32 * u];
            for (int w = 1; w < kWarps; ++w)
              acc[u] = vadd(acc[u], part[w][lane + 32 * u]);
          }
          store_row<V, kV, kMean>(out + row * wv, acc,
                                  kMean ? inverse_degree(e - s) : 1.f, wv, c0,
                                  lane);
        }
        __syncthreads();
      }
    }
    __syncthreads();  // num_hubs is read before thread 0 resets it
  }
}

// ---- K6a over float16 ----------------------------------------------------

// x rounded to float16 (to nearest, ties to even), as a float32
__device__ __forceinline__ float r16(float x) {
  return __half2float(__float2half_rn(x));
}
__device__ __forceinline__ float4 r16(float4 x) {
  return make_float4(r16(x.x), r16(x.y), r16(x.z), r16(x.w));
}

__device__ __forceinline__ uint16_t narrow16(float x) {
  return __half_as_ushort(__float2half_rn(x));
}
__device__ __forceinline__ uint2 narrow16(float4 x) {
  return make_uint2(narrow16(x.x) | ((uint32_t)narrow16(x.y) << 16),
                    narrow16(x.z) | ((uint32_t)narrow16(x.w) << 16));
}

// One segment [s, e) of a row at the lane's columns: its float32 sum
// rounded to float16, and with kMean that times inv rounded again.
template <typename S, int kV, bool kMean>
__device__ __forceinline__ void segment16(const int32_t* __restrict__ indices,
                                          const S* __restrict__ h, int64_t s,
                                          int64_t e, int32_t num_rows,
                                          int64_t wv, int64_t c0, int lane,
                                          float inv,
                                          typename Wide<S>::T (&v)[kV]) {
#pragma unroll
  for (int u = 0; u < kV; ++u) v[u] = zero_value<typename Wide<S>::T>();
  sum_edges<S, kV>(indices, h, s, e, num_rows, wv, c0, lane, v);
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    v[u] = r16(v[u]);
    if (kMean) v[u] = r16(vmul(v[u], inv));
  }
}

template <typename S, int kV>
__device__ __forceinline__ void store16(S* __restrict__ orow,
                                        const typename Wide<S>::T (&v)[kV],
                                        int64_t wv, int64_t c0, int lane) {
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    const int64_t c = c0 + lane + 32 * u;
    if (c < wv) orow[c] = narrow16(v[u]);
  }
}

// the rows of at most seg edges (one segment), a warp a row
template <typename S, int kV, bool kMean>
__global__ void __launch_bounds__(kThreads)
spmm16_rows_kernel(const int32_t* __restrict__ indptr,
                   const int32_t* __restrict__ indices,
                   const S* __restrict__ h, S* __restrict__ out,
                   int64_t num_node, int32_t num_rows, int64_t wv,
                   int64_t seg) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < num_node; row += warps) {
    const int64_t s = __ldg(indptr + row), e = __ldg(indptr + row + 1);
    if (e - s > seg) continue;  // the hub kernel's
    const float inv = kMean ? inverse_degree(e - s) : 1.f;
    for (int64_t c0 = 0; c0 < wv; c0 += 32 * kV) {
      typename Wide<S>::T v[kV];
      segment16<S, kV, kMean>(indices, h, s, e, num_rows, wv, c0, lane, inv,
                              v);
      store16<S, kV>(out + row * wv, v, wv, c0, lane);
    }
  }
}

// The rows of more than seg edges, a block a row: its warps take the
// row's segments kWarps at a time, in the order of JAX's plan (the partial
// last segment first where it has at most first_max edges), and warp 0
// adds each round's segments into the float16 accumulator in that order.
template <typename S, int kV, bool kMean>
__global__ void __launch_bounds__(kThreads)
spmm16_hub_kernel(const int32_t* __restrict__ indptr,
                  const int32_t* __restrict__ indices,
                  const S* __restrict__ h, S* __restrict__ out,
                  int64_t num_node, int32_t num_rows, int64_t wv, int64_t seg,
                  int64_t first_max) {
  using V = typename Wide<S>::T;
  __shared__ int32_t hubs[kThreads];
  __shared__ int num_hubs;
  __shared__ V part[kWarps][32 * kV];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < num_node;
       base += (int64_t)gridDim.x * kThreads) {
    const int nh = find_hubs(indptr, base, num_node, seg, hubs, &num_hubs);
    for (int i = 0; i < nh; ++i) {
      const int64_t row = hubs[i];
      const int64_t s = __ldg(indptr + row), e = __ldg(indptr + row + 1);
      const int64_t nseg = (e - s + seg - 1) / seg, rem = (e - s) % seg;
      const bool first = rem != 0 && rem <= first_max;
      const float inv = kMean ? inverse_degree(e - s) : 1.f;
      for (int64_t c0 = 0; c0 < wv; c0 += 32 * kV) {
        V acc[kV];
#pragma unroll
        for (int u = 0; u < kV; ++u) acc[u] = zero_value<V>();
        for (int64_t r0 = 0; r0 < nseg; r0 += kWarps) {
          const int64_t k = r0 + warp;
          if (k < nseg) {
            const int64_t sg = first ? (k == 0 ? nseg - 1 : k - 1) : k;
            V v[kV];
            segment16<S, kV, kMean>(indices, h, s + sg * seg,
                                    min64(e, s + (sg + 1) * seg), num_rows,
                                    wv, c0, lane, inv, v);
#pragma unroll
            for (int u = 0; u < kV; ++u) part[warp][lane + 32 * u] = v[u];
          }
          __syncthreads();
          if (warp == 0) {
            const int64_t n = min64(kWarps, nseg - r0);
            for (int w = 0; w < n; ++w) {
#pragma unroll
              for (int u = 0; u < kV; ++u)
                acc[u] = r16(vadd(acc[u], part[w][lane + 32 * u]));
            }
          }
          __syncthreads();
        }
        if (warp == 0) store16<S, kV>(out + row * wv, acc, wv, c0, lane);
      }
    }
    __syncthreads();  // num_hubs is read before thread 0 resets it
  }
}

// ---- K6b ----------------------------------------------------------------

// K6b's scalar one-head rows (the 47-wide logits layer) are lean: 4 edges
// a group and at most 40 registers, so that 6 blocks (48 warps) fit an SM;
// more rows in flight a warp, or fewer warps, were slower
// (xgnn_tpu_torch/tools/time_spmm.py).
template <typename V, int kH>
constexpr bool kLean = sizeof(V) == sizeof(float) && kH == 1;

// A warp's shared state in a column pass of a row that holds kH heads (1,
// or up to 8): w[t][j], edge j's weight for the pass's head t in the
// current batch of up to 32 edges, and w[t][32] the rescale of head t's
// earlier terms in that batch; at the end of the pass each head's max and
// sum, read by the lanes of its columns.
template <int kH>
struct GatScratch {
  float w[kH][33];
  float m[kH], sum[kH];
};

// A lane's share of the column pass [c0, c1) of a row: its kV slices, 32
// vectors apart, each slice's head counted from the pass's first head h0,
// and el[row, h0 + t] for the pass's nh heads.
template <int kV, int kH>
struct GatPass {
  int c1;
  int col[kV];  // a slice's vector (none at or past c1)
  int t[kV];
  int h0, nh;
  float el_v[kH];
};

template <int kV, int kH>
__device__ __forceinline__ GatPass<kV, kH> gat_pass(
    const float* __restrict__ el, int64_t row, int heads, int d, int vw,
    int wv, int c0, int lane) {
  GatPass<kV, kH> p;
  p.c1 = min(wv, c0 + 32 * kV);
  if constexpr (kH == 1) {  // one head: no head arithmetic
    p.h0 = 0;
    p.nh = 1;
  } else {
    // at most kH heads (a vector lies in one head)
    p.h0 = c0 * vw / d;
    p.c1 = min(p.c1, (p.h0 + kH) * d / vw);
    p.nh = (p.c1 - 1) * vw / d - p.h0 + 1;
  }
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    p.col[u] = c0 + lane + 32 * u;
    p.t[u] = kH == 1 || p.col[u] >= p.c1 ? 0 : p.col[u] * vw / d - p.h0;
  }
#pragma unroll
  for (int t = 0; t < kH; ++t)
    p.el_v[t] = t < p.nh ? __ldg(el + row * heads + p.h0 + t) : 0.f;
  return p;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// the same bits in every lane: each step adds a pair in both orders
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// x[i] <- a lane's slices of the row of the batch's edge g0 + i (zero past
// the batch's n edges); lane j of the warp holds edge j's id.  At one head
// the rows stream (evict-first), so that er, read again by every edge of
// its node, stays in the L2.
template <typename V, int kV, int kH, int G>
__device__ __forceinline__ void load_group(const V* __restrict__ feat,
                                           int32_t id, int g0, int n, int wv,
                                           const GatPass<kV, kH>& p,
                                           V (&x)[G][kV]) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int32_t r = __shfl_sync(kFull, id, (g0 + i) & 31);
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      x[i][u] = zero_value<V>();
      if (g0 + i < n && p.col[u] < p.c1) {
        const V* at = feat + (int64_t)r * wv + p.col[u];
        x[i][u] = kH == 1 ? __ldcs(at) : __ldg(at);
      }
    }
  }
}

// The online softmax of a column pass over edges [s, e) of a row, a batch
// of up to 32 edges at a time: lane j scores edge j once a head (its er
// words loaded together), the batch's max and weight sum come from warp
// shuffles, each weight exp(score - max) is taken once, and the lanes'
// slices are rescaled once a batch and then take one multiply-add an
// element, the weight read from shared memory.  m and sum (a head each,
// the same in every lane) and acc carry over between calls.
template <typename V, int kV, int kH>
__device__ __forceinline__ void attend_edges(
    const int32_t* __restrict__ indices, const V* __restrict__ feat,
    const float* __restrict__ er, int64_t s, int64_t e, int32_t num_rows,
    int heads, int wv, const GatPass<kV, kH>& p, float slope, int lane,
    GatScratch<kH>& g, float (&m)[kH], float (&sum)[kH], V (&acc)[kV]) {
  // a lane's rows of a group in registers: fewer at 8 floats and on the
  // lean rows
  constexpr int G =
      kLean<V, kH> || sizeof(V) * kV > 16 ? kGroup / 2 : kGroup;
  // each batch's ids are read while the batch before it is weighed
  int32_t next = 0;
  if (lane < min64(32, e - s)) next = __ldg(indices + s + lane);
  for (int64_t k0 = s; k0 < e; k0 += 32) {
    const int n = (int)min64(32, e - k0);
    const int32_t id = lane < n ? clip_id(next, num_rows) : 0;
    if (lane < min64(32, e - k0 - 32)) next = __ldg(indices + k0 + 32 + lane);
    // the first group's rows fly while the scores are formed
    V x[G][kV];
    load_group<V, kV, kH, G>(feat, id, 0, n, wv, p, x);
    float z[kH];
#pragma unroll
    for (int t = 0; t < kH; ++t)
      z[t] = t < p.nh && lane < n
                 ? __ldg(er + (int64_t)id * heads + p.h0 + t) : 0.f;
#pragma unroll
    for (int t = 0; t < kH; ++t) {
      if (t < p.nh) {
        z[t] = lane < n ? leaky(p.el_v[t] + z[t], slope) : -INFINITY;
        const float mx = fmaxf(m[t], warp_max(z[t]));
        const float w = lane < n ? expf(z[t] - mx) : 0.f;
        // the earlier terms rescaled to the new max (1 when it did not
        // grow, 0 before the first batch)
        const float scale = m[t] == -INFINITY ? 0.f : expf(m[t] - mx);
        sum[t] = sum[t] * scale + warp_sum(w);
        m[t] = mx;
        g.w[t][lane] = w;
        if (lane == 0) g.w[t][32] = scale;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kV; ++u)
      acc[u] = vmul(acc[u], g.w[kH == 1 ? 0 : p.t[u]][32]);
    for (int g0 = 0; g0 < n; g0 += G) {
      if (g0 > 0) load_group<V, kV, kH, G>(feat, id, g0, n, wv, p, x);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (g0 + i < n) {
#pragma unroll
          for (int u = 0; u < kV; ++u)
            acc[u] = vfma(acc[u], g.w[kH == 1 ? 0 : p.t[u]][g0 + i], x[i][u]);
        }
      }
    }
    __syncwarp();  // the weights are read before the next batch writes them
  }
}

// A warp's column pass over edges [s, e) of a row: acc, and each head's
// max and sum in g.m, g.sum.
template <typename V, int kV, int kH>
__device__ __forceinline__ void attend_part(
    const int32_t* __restrict__ indices, const V* __restrict__ feat,
    const float* __restrict__ er, int64_t s, int64_t e, int32_t num_rows,
    int heads, int wv, const GatPass<kV, kH>& p, float slope, int lane,
    GatScratch<kH>& g, V (&acc)[kV]) {
  float m[kH], sum[kH];
#pragma unroll
  for (int t = 0; t < kH; ++t) {
    m[t] = -INFINITY;
    sum[t] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < kV; ++u) acc[u] = zero_value<V>();
  attend_edges<V, kV, kH>(indices, feat, er, s, e, num_rows, heads, wv, p,
                          slope, lane, g, m, sum, acc);
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < kH; ++t) {
      g.m[t] = m[t];
      g.sum[t] = sum[t];
    }
  }
  __syncwarp();
}

template <typename V, int kV, int kH>
__global__ void __launch_bounds__(kThreads, kLean<V, kH> ? 6 : 1)
gat_rows_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices, const V* __restrict__ feat,
                const float* __restrict__ el, const float* __restrict__ er,
                V* __restrict__ out, int64_t num_node, int32_t num_rows,
                int heads, int d, int vw, int wv, float slope,
                int64_t hub_cap) {
  __shared__ GatScratch<kH> scratch[kWarps];
  const int lane = threadIdx.x & 31;
  GatScratch<kH>& g = scratch[threadIdx.x >> 5];
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < num_node; row += warps) {
    const int64_t s = __ldg(indptr + row), e = __ldg(indptr + row + 1);
    if (e - s > hub_cap) continue;  // the hub kernel's
    for (int c0 = 0; c0 < wv;) {
      const GatPass<kV, kH> p =
          gat_pass<kV, kH>(el, row, heads, d, vw, wv, c0, lane);
      V acc[kV];
      attend_part<V, kV, kH>(indices, feat, er, s, e, num_rows, heads, wv, p,
                             slope, lane, g, acc);
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        if (p.col[u] < p.c1)
          __stcs(out + row * wv + p.col[u],
                 vdiv(acc[u], fmaxf(g.sum[p.t[u]], kGatEps)));
      }
      __syncwarp();  // g.sum is read before the next pass writes it
      c0 = p.c1;
    }
  }
}

template <typename V, int kV, int kH>
__global__ void __launch_bounds__(kThreads)
gat_hub_kernel(const int32_t* __restrict__ indptr,
               const int32_t* __restrict__ indices, const V* __restrict__ feat,
               const float* __restrict__ el, const float* __restrict__ er,
               V* __restrict__ out, int64_t num_node, int32_t num_rows,
               int heads, int d, int vw, int wv, float slope,
               int64_t hub_cap) {
  __shared__ int32_t hubs[kThreads];
  __shared__ int num_hubs;
  __shared__ GatScratch<kH> scratch[kWarps];
  __shared__ V part[kWarps][32 * kV];
  __shared__ float part_m[kWarps][32 * kV], part_s[kWarps][32 * kV];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  GatScratch<kH>& g = scratch[warp];
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < num_node;
       base += (int64_t)gridDim.x * kThreads) {
    const int nh = find_hubs(indptr, base, num_node, hub_cap, hubs, &num_hubs);
    for (int i = 0; i < nh; ++i) {
      const int64_t row = hubs[i];
      const int64_t s = __ldg(indptr + row), e = __ldg(indptr + row + 1);
      int64_t ws, we;
      warp_part(s, e, warp, &ws, &we);
      for (int c0 = 0; c0 < wv;) {
        const GatPass<kV, kH> p =
            gat_pass<kV, kH>(el, row, heads, d, vw, wv, c0, lane);
        V acc[kV];
        attend_part<V, kV, kH>(indices, feat, er, ws, we, num_rows, heads,
                               wv, p, slope, lane, g, acc);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          const int k = lane + 32 * u;
          part[warp][k] = acc[u];
          part_m[warp][k] = g.m[p.t[u]];
          part_s[warp][k] = g.sum[p.t[u]];
        }
        __syncthreads();
        if (warp == 0) {
#pragma unroll
          for (int u = 0; u < kV; ++u) {
            const int k = lane + 32 * u;
            float mx = part_m[0][k];
            for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, part_m[w][k]);
            V a = zero_value<V>();
            float t = 0.f;
            for (int w = 0; w < kWarps; ++w) {
              // an empty part (m = -inf) adds nothing
              const float f = part_m[w][k] == -INFINITY
                                  ? 0.f : expf(part_m[w][k] - mx);
              a = vfma(a, f, part[w][k]);
              t += part_s[w][k] * f;
            }
            if (p.col[u] < p.c1)
              __stcs(out + row * wv + p.col[u], vdiv(a, fmaxf(t, kGatEps)));
          }
        }
        __syncthreads();
        c0 = p.c1;
      }
    }
    __syncthreads();  // num_hubs is read before thread 0 resets it
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// blocks for a grid-stride kernel: as many as stay resident on the card,
// and no more than the work needs at per_block items a block (a resident
// grid striding over the rows beat a block per 8 rows: tools/time_spmm.py)
template <typename K>
unsigned grid_for(K kernel, int64_t work, int64_t per_block) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t want = (work + per_block - 1) / per_block;
  const int64_t resident = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(want < resident ? (want > 0 ? want : 1) : resident);
}

template <typename V, int kV, bool kMean>
void launch_spmm(const int32_t* indptr, const int32_t* indices,
                 const float* h, float* out, int64_t num_node,
                 int32_t num_rows, int64_t wv, int64_t hub_cap,
                 cudaStream_t s) {
  const V* hv = reinterpret_cast<const V*>(h);
  V* ov = reinterpret_cast<V*>(out);
  auto rows = spmm_rows_kernel<V, kV, kMean>;
  rows<<<grid_for(rows, num_node, kWarps), kThreads, 0, s>>>(
      indptr, indices, hv, ov, num_node, num_rows, wv, hub_cap);
  if (hub_cap < INT32_MAX) {
    auto hub = spmm_hub_kernel<V, kV, kMean>;
    hub<<<grid_for(hub, num_node, kThreads), kThreads, 0, s>>>(
        indptr, indices, hv, ov, num_node, num_rows, wv, hub_cap);
  }
}

template <typename S, int kV, bool kMean>
void launch_spmm16(const int32_t* indptr, const int32_t* indices,
                   const void* h, void* out, int64_t num_node,
                   int32_t num_rows, int64_t wv, int64_t seg,
                   int64_t first_max, cudaStream_t s) {
  const S* hv = static_cast<const S*>(h);
  S* ov = static_cast<S*>(out);
  auto rows = spmm16_rows_kernel<S, kV, kMean>;
  rows<<<grid_for(rows, num_node, kWarps), kThreads, 0, s>>>(
      indptr, indices, hv, ov, num_node, num_rows, wv, seg);
  auto hub = spmm16_hub_kernel<S, kV, kMean>;
  hub<<<grid_for(hub, num_node, kThreads), kThreads, 0, s>>>(
      indptr, indices, hv, ov, num_node, num_rows, wv, seg, first_max);
}

template <typename V, int kV, int kH>
void launch_gat(const int32_t* indptr, const int32_t* indices,
                const float* feat, const float* el, const float* er,
                float* out, int64_t num_node, int32_t num_rows, int heads,
                int d, int wv, float slope, int64_t hub_cap,
                cudaStream_t s) {
  const int vw = (int)(sizeof(V) / sizeof(float));
  const V* fv = reinterpret_cast<const V*>(feat);
  V* ov = reinterpret_cast<V*>(out);
  auto rows = gat_rows_kernel<V, kV, kH>;
  rows<<<grid_for(rows, num_node, kWarps), kThreads, 0, s>>>(
      indptr, indices, fv, el, er, ov, num_node, num_rows, heads, d, vw, wv,
      slope, hub_cap);
  if (hub_cap < INT32_MAX) {
    auto hub = gat_hub_kernel<V, kV, kH>;
    hub<<<grid_for(hub, num_node, kThreads), kThreads, 0, s>>>(
        indptr, indices, fv, el, er, ov, num_node, num_rows, heads, d, vw, wv,
        slope, hub_cap);
  }
}

}  // namespace

// indptr: (>= num_node + 1,) int32, nondecreasing; indices: int32 ids;
// h: (num_rows, width) f32; out: (num_node, width) f32, every row written.
// mean != 0 multiplies each row by 1 / max(deg, 1).  Rows of more than
// hub_cap edges go to the block-a-row kernel (none for hub_cap >=
// INT32_MAX).  Returns cudaGetLastError() after the last launch.
extern "C" int xg_spmm_csr(const void* indptr, const void* indices,
                           const void* h, void* out, long long num_node,
                           long long num_rows, long long width, int mean,
                           long long hub_cap, void* stream) {
  if (num_rows >= INT32_MAX || (num_rows <= 0 && num_node > 0))
    return (int)cudaErrorInvalidValue;
  if (num_node <= 0 || width <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const float* hf = static_cast<const float*>(h);
  float* of = static_cast<float*>(out);
  const int32_t nr = (int32_t)num_rows;
  const bool vec = width % 4 == 0 && aligned16(h) && aligned16(out);
#define XG_SPMM(V, KV, WV)                                                  \
  (mean ? launch_spmm<V, KV, true>(ip, ix, hf, of, num_node, nr, WV,         \
                                   hub_cap, s)                              \
        : launch_spmm<V, KV, false>(ip, ix, hf, of, num_node, nr, WV,        \
                                    hub_cap, s))
  if (vec && width <= 128) XG_SPMM(float4, 1, width / 4);
  else if (vec) XG_SPMM(float4, 2, width / 4);
  else XG_SPMM(float, 2, width);
#undef XG_SPMM
  return (int)cudaGetLastError();
}

// K6a's float16 form: h: (num_rows, width) float16; out: (num_node,
// width) float16, every row written; seg: the segment's edges (2048);
// first_max: the longest partial last segment that JAX's plan adds first
// (1536).  indptr, indices and mean as above.
extern "C" int xg_spmm_csr_f16(const void* indptr, const void* indices,
                               const void* h, void* out, long long num_node,
                               long long num_rows, long long width, int mean,
                               long long seg, long long first_max,
                               void* stream) {
  if (num_rows >= INT32_MAX || (num_rows <= 0 && num_node > 0) || seg <= 0)
    return (int)cudaErrorInvalidValue;
  if (num_node <= 0 || width <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const int32_t nr = (int32_t)num_rows;
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 8 == 0;
#define XG_SPMM16(S, KV, WV)                                                \
  (mean ? launch_spmm16<S, KV, true>(ip, ix, h, out, num_node, nr, WV, seg,  \
                                     first_max, s)                          \
        : launch_spmm16<S, KV, false>(ip, ix, h, out, num_node, nr, WV, seg, \
                                      first_max, s))
  if (vec && width <= 128) XG_SPMM16(uint2, 1, width / 4);
  else if (vec) XG_SPMM16(uint2, 2, width / 4);
  else XG_SPMM16(uint16_t, 2, width);
#undef XG_SPMM16
  return (int)cudaGetLastError();
}

// feat: (num_rows, heads * head_dim) f32 (head-major rows); el, er:
// (num_rows, heads) f32 with num_rows >= num_node; out: (num_node, heads *
// head_dim) f32, every row written.  indptr, indices and hub_cap as above.
extern "C" int xg_gat_csr(const void* indptr, const void* indices,
                          const void* feat, const void* el, const void* er,
                          void* out, long long num_node, long long num_rows,
                          int heads, int head_dim, float negative_slope,
                          long long hub_cap, void* stream) {
  if (num_rows >= INT32_MAX || num_rows < num_node || heads <= 0 ||
      head_dim <= 0 || (int64_t)heads * head_dim >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (num_node <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const float* ff = static_cast<const float*>(feat);
  const float* elf = static_cast<const float*>(el);
  const float* erf = static_cast<const float*>(er);
  float* of = static_cast<float*>(out);
  const int32_t nr = (int32_t)num_rows;
  const int width = heads * head_dim;
  // a float4 slice must lie in one head
  const bool vec = head_dim % 4 == 0 && aligned16(feat) && aligned16(out);
#define XG_GAT(V, KV, WV)                                                    \
  (heads == 1 ? launch_gat<V, KV, 1>(ip, ix, ff, elf, erf, of, num_node, nr, \
                                     heads, head_dim, WV, negative_slope,    \
                                     hub_cap, s)                             \
              : launch_gat<V, KV, 8>(ip, ix, ff, elf, erf, of, num_node, nr, \
                                     heads, head_dim, WV, negative_slope,    \
                                     hub_cap, s))
  if (vec && width <= 128) XG_GAT(float4, 1, width / 4);
  else if (vec) XG_GAT(float4, 2, width / 4);
  else XG_GAT(float, 2, width);
#undef XG_GAT
  return (int)cudaGetLastError();
}
