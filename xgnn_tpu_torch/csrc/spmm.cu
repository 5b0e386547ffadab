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
// equals the plain version's in-order index_add_ bit for bit.  K6b keeps
// an online softmax a slice: a running max and sum, and the weighted row,
// rescaled once a group of edges when the max grows, so the row is
// read once (JAX reads the scores twice, in two passes).  A lane's slice
// lies in one head, so the lanes of a head load the same er[u, hd] word:
// one transaction for them.  The result is divided (IEEE) by max(s, 1e-9).
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

// acc * scale + w * x
__device__ __forceinline__ float vaxpby(float acc, float scale, float w,
                                        float x) {
  return acc * scale + w * x;
}
__device__ __forceinline__ float4 vaxpby(float4 acc, float scale, float w,
                                         float4 x) {
  return make_float4(acc.x * scale + w * x.x, acc.y * scale + w * x.y,
                     acc.z * scale + w * x.z, acc.w * scale + w * x.w);
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

// acc[u] += h[indices[k], c0 + lane + 32 u] for k in [s, e), in order.  The
// warp's lanes all call it with the same s, e and c0.
template <typename V, int kV>
__device__ __forceinline__ void sum_edges(const int32_t* __restrict__ indices,
                                          const V* __restrict__ h, int64_t s,
                                          int64_t e, int32_t num_rows,
                                          int64_t wv, int64_t c0, int lane,
                                          V (&acc)[kV]) {
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
          if (g0 + j < n && c < wv) v[j][u] = __ldg(h + (int64_t)r * wv + c);
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

// ---- K6b ----------------------------------------------------------------

// The online softmax of a lane's kV slices over edges [s, e) of a row:
// m, sum and acc carry over between calls.  hd[u] is slice u's head,
// el_v[u] = el[v, hd[u]].
template <typename V, int kV>
__device__ __forceinline__ void attend_edges(
    const int32_t* __restrict__ indices, const V* __restrict__ feat,
    const float* __restrict__ er, int64_t s, int64_t e, int32_t num_rows,
    int heads, int64_t wv, int64_t c0, int lane, const int (&hd)[kV],
    const float (&el_v)[kV], float slope, float (&m)[kV], float (&sum)[kV],
    V (&acc)[kV]) {
  // a lane's rows and scores of a group in registers: fewer at 8 floats
  constexpr int G = sizeof(V) * kV > 16 ? kGroup / 2 : kGroup;
  for (int64_t k0 = s; k0 < e; k0 += 32) {
    const int n = (int)min64(32, e - k0);
    int32_t id = 0;
    if (lane < n) id = clip_id(__ldg(indices + k0 + lane), num_rows);
    for (int g0 = 0; g0 < n; g0 += G) {
      V x[G][kV];
      float sc[G][kV];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int32_t r = __shfl_sync(kFull, id, (g0 + j) & 31);
        const bool live = g0 + j < n;
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          const int64_t c = c0 + lane + 32 * u;
          x[j][u] = zero_value<V>();
          sc[j][u] = 0.f;
          if (live) {
            if (c < wv) x[j][u] = __ldg(feat + (int64_t)r * wv + c);
            sc[j][u] = __ldg(er + (int64_t)r * heads + hd[u]);
          }
        }
      }
      // the scores once every load of the group is in flight: computed
      // as each er word arrived, they held the next edge's loads back
#pragma unroll
      for (int j = 0; j < G; ++j) {
#pragma unroll
        for (int u = 0; u < kV; ++u)
          sc[j][u] = g0 + j < n ? leaky(el_v[u] + sc[j][u], slope)
                                : -INFINITY;
      }
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        float mx = m[u];
#pragma unroll
        for (int j = 0; j < G; ++j) mx = fmaxf(mx, sc[j][u]);
        // the old terms rescaled to the new max (1 when it did not grow)
        const float scale = m[u] == -INFINITY ? 0.f : expf(m[u] - mx);
        V a = acc[u];
        float t = sum[u] * scale;
        bool first = true;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (g0 + j < n) {
            const float w = expf(sc[j][u] - mx);
            a = vaxpby(a, first ? scale : 1.f, w, x[j][u]);
            t += w;
            first = false;
          }
        }
        acc[u] = a;
        sum[u] = t;
        m[u] = mx;
      }
    }
  }
}

template <typename V, int kV>
__device__ __forceinline__ void slice_heads(const float* __restrict__ el,
                                            int64_t row, int heads, int d,
                                            int vw, int64_t wv, int64_t c0,
                                            int lane, int (&hd)[kV],
                                            float (&el_v)[kV]) {
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    const int64_t c = c0 + lane + 32 * u;
    hd[u] = c < wv ? (int)(c * vw / d) : 0;
    el_v[u] = __ldg(el + row * heads + hd[u]);
  }
}

template <typename V, int kV>
__global__ void __launch_bounds__(kThreads)
gat_rows_kernel(const int32_t* __restrict__ indptr,
                const int32_t* __restrict__ indices, const V* __restrict__ feat,
                const float* __restrict__ el, const float* __restrict__ er,
                V* __restrict__ out, int64_t num_node, int32_t num_rows,
                int heads, int d, int vw, int64_t wv, float slope,
                int64_t hub_cap) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < num_node; row += warps) {
    const int64_t s = __ldg(indptr + row), e = __ldg(indptr + row + 1);
    if (e - s > hub_cap) continue;  // the hub kernel's
    for (int64_t c0 = 0; c0 < wv; c0 += 32 * kV) {
      int hd[kV];
      float el_v[kV], m[kV], sum[kV];
      V acc[kV];
      slice_heads<V, kV>(el, row, heads, d, vw, wv, c0, lane, hd, el_v);
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        m[u] = -INFINITY;
        sum[u] = 0.f;
        acc[u] = zero_value<V>();
      }
      attend_edges<V, kV>(indices, feat, er, s, e, num_rows, heads, wv, c0,
                          lane, hd, el_v, slope, m, sum, acc);
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        const int64_t c = c0 + lane + 32 * u;
        if (c < wv)
          __stcs(out + row * wv + c, vdiv(acc[u], fmaxf(sum[u], kGatEps)));
      }
    }
  }
}

template <typename V, int kV>
__global__ void __launch_bounds__(kThreads)
gat_hub_kernel(const int32_t* __restrict__ indptr,
               const int32_t* __restrict__ indices, const V* __restrict__ feat,
               const float* __restrict__ el, const float* __restrict__ er,
               V* __restrict__ out, int64_t num_node, int32_t num_rows,
               int heads, int d, int vw, int64_t wv, float slope,
               int64_t hub_cap) {
  __shared__ int32_t hubs[kThreads];
  __shared__ int num_hubs;
  __shared__ V part[kWarps][32 * kV];
  __shared__ float part_m[kWarps][32 * kV], part_s[kWarps][32 * kV];
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
        int hd[kV];
        float el_v[kV], m[kV], sum[kV];
        V acc[kV];
        slice_heads<V, kV>(el, row, heads, d, vw, wv, c0, lane, hd, el_v);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          m[u] = -INFINITY;
          sum[u] = 0.f;
          acc[u] = zero_value<V>();
        }
        attend_edges<V, kV>(indices, feat, er, ws, we, num_rows, heads, wv,
                            c0, lane, hd, el_v, slope, m, sum, acc);
#pragma unroll
        for (int u = 0; u < kV; ++u) {
          part[warp][lane + 32 * u] = acc[u];
          part_m[warp][lane + 32 * u] = m[u];
          part_s[warp][lane + 32 * u] = sum[u];
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
              a = vaxpby(a, 1.f, f, part[w][k]);
              t += part_s[w][k] * f;
            }
            const int64_t c = c0 + k;
            if (c < wv) __stcs(out + row * wv + c, vdiv(a, fmaxf(t, kGatEps)));
          }
        }
        __syncthreads();
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

template <typename V, int kV>
void launch_gat(const int32_t* indptr, const int32_t* indices,
                const float* feat, const float* el, const float* er,
                float* out, int64_t num_node, int32_t num_rows, int heads,
                int d, int64_t wv, float slope, int64_t hub_cap,
                cudaStream_t s) {
  const int vw = (int)(sizeof(V) / sizeof(float));
  const V* fv = reinterpret_cast<const V*>(feat);
  V* ov = reinterpret_cast<V*>(out);
  auto rows = gat_rows_kernel<V, kV>;
  rows<<<grid_for(rows, num_node, kWarps), kThreads, 0, s>>>(
      indptr, indices, fv, el, er, ov, num_node, num_rows, heads, d, vw, wv,
      slope, hub_cap);
  if (hub_cap < INT32_MAX) {
    auto hub = gat_hub_kernel<V, kV>;
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

// feat: (num_rows, heads * head_dim) f32 (head-major rows); el, er:
// (num_rows, heads) f32 with num_rows >= num_node; out: (num_node, heads *
// head_dim) f32, every row written.  indptr, indices and hub_cap as above.
extern "C" int xg_gat_csr(const void* indptr, const void* indices,
                          const void* feat, const void* el, const void* er,
                          void* out, long long num_node, long long num_rows,
                          int heads, int head_dim, float negative_slope,
                          long long hub_cap, void* stream) {
  if (num_rows >= INT32_MAX || num_rows < num_node || heads <= 0 ||
      head_dim <= 0)
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
  const int64_t width = (int64_t)heads * head_dim;
  // a float4 slice must lie in one head
  const bool vec = head_dim % 4 == 0 && aligned16(feat) && aligned16(out);
  if (vec && width <= 128)
    launch_gat<float4, 1>(ip, ix, ff, elf, erf, of, num_node, nr, heads,
                          head_dim, width / 4, negative_slope, hub_cap, s);
  else if (vec)
    launch_gat<float4, 2>(ip, ix, ff, elf, erf, of, num_node, nr, heads,
                          head_dim, width / 4, negative_slope, hub_cap, s);
  else
    launch_gat<float, 2>(ip, ix, ff, elf, erf, of, num_node, nr, heads,
                         head_dim, width, negative_slope, hub_cap, s);
  return (int)cudaGetLastError();
}
