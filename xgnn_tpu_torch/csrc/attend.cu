// K5: GAT's edge-softmax aggregate over a block's picks, forward and the
// backward's per-dst-row pass.
//
// For dst row b, head h and its valid picks k (a pick is valid when it lies
// in [0, num_rows); EMPTY, int32 max, is not):
//   pre_k = el_dst[b,h] + score_h(row_k),   e_k = leaky_relu(pre_k, slope)
//   out[b,h,:] = sum_k exp(e_k - m) payload_h(row_k) / max(s, 1e-9)
// with m = max_k e_k and s = sum_k exp(e_k - m); m and s are saved for the
// backward (m = 0 for a row without a valid pick).
//   shared mode:   proj = wr (W, H) row-major; score_h = row . wr[:,h]; the
//                  payload of every head is the whole W-wide row; out (D,H,W).
//   per-head mode: the table is (N, H*d); proj = attn_r (H, d); head h scores
//                  and carries its slice row[h*d:(h+1)*d]; out (D, H, d).
// Backward, with a_k = exp(e_k - m) / max(s, 1e-9), ga_k = g_out[b,h] .
// payload_h(row_k) and dot_h = sum_k a_k ga_k / sum_k a_k (= g_out[b,h] .
// out[b,h], so out is never read):
//   g_pre_k = a_k (ga_k - dot_h) * leaky'(pre_k)
//   g_el[b,h] = sum_k g_pre_k;  g_proj = sum over every pick of g_pre_k row_k
//   (per head, or per head's slice); and, when the table needs a gradient,
//   its src row r gets v_k = sum_h a_k g_out[b,h] (on the payload) +
//   g_pre_k proj_h (through the score) from each of its picks.  The caller
//   sums those by src row with K4's segmented backward (csrc/fanout.cu):
//   - one head: this pass writes only a_k and g_pre_k, two floats a pick
//     (zeros for an invalid pick), since sum_k v_k over r's picks is
//     sum_k a_k g_out[b] + (sum_k g_pre_k) proj: K4's weighted sum over
//     g_out with weights a and its rank-1 term with c = g_pre, u = proj;
//   - more heads: v_k mixes every head's g_out row, so this pass writes
//     the W-wide row v_k a pick, which K4 sums as (D * K) rows of one pick.
//
// Replaces: xgnn_tpu/models/gnn.py, GATConv._online_attend (a K-pass XLA
// loop with a (dst, H, W) accumulator in HBM) with the score and payload of
// its aggregate-first and transform-first paths, and its autodiff.  On the
// TPU it was XLA ops, not a Pallas kernel.
//
// What bounds it on an H100: bytes.  The forward reads each valid pick's
// row once and writes each output row once (the main path's layer 0 at 8
// heads: 1.98M distinct rows of 512 B and a 4.1 GB output, about 1.6 ms at
// 3.35 TB/s); per pick element it does 2H multiply-adds, far below the
// card's float32 rate.  The backward reads the rows and g_out; at more
// than one head it writes the per-pick rows, which the segmented sum reads
// back, and at one head two floats a pick (layer 1 of gat1: 10.7 MB in
// place of 1.37 GB of rows written and read back).
//
// Design: one warp per dst row (persistent warps walk the rows), lanes
// across the width (a float4 per lane where the row is 16-byte aligned,
// else a float).  The picks go in windows of 32, one ballot each: the
// valid ones are the set bits, a pick's id comes from its lane by a
// shuffle, and the next valid pick's row is in flight while one is used.
// Every head's partial dot products of a pick are summed over the warp in
// one transpose-reduce (V values in V - 1 + log2(32 / V) shuffles, not
// 5 V), after which each lane holds one head's value, so the softmax
// arithmetic is lane-local.  Two forms, by what the accumulator costs:
// - Scores first (shared mode, two heads or more, where the accumulator
//   would be H * W / 32 floats a lane): pass 1 forms each pick's scores and
//   the exact max and sum, and keeps the window's records (the scores, or
//   in the backward a, ga and leaky') in shared memory, [pick][head].  Pass
//   2 walks the picks again (their rows come back from L1/L2) one 16-byte
//   column chunk of the lane at a time, reads each pick's H weights by
//   broadcast and keeps one chunk of every head in registers: H float4s.
//   The backward's g_proj share is formed there per window and added once
//   (not per pick) into lane-private slots of shared memory.
// - Online (one head in shared mode, and per-head mode, where the
//   accumulator is the lane's chunks whatever the heads): one pass with the
//   running max and sum, rescaling the accumulator when the max grows.  Its
//   backward needs dot before any g_pre, but g_pre = c1 - dot c2 with c2 =
//   a leaky' and c1 = c2 ga, so one pass sums c1 row and c2 row and the
//   dst row's g_proj share is their difference: the rows are read once.
// Rows of more than 32 picks keep the exact softmax: scores first walks
// every window for m and s (or dot) and computes each window's records
// again in pass 2, adding later windows' output into out.
// Backward: no read of out (dot_h from a and ga), g_out's row in
// registers only while pass 1 runs, the table's share (a template flag:
// none, the per-pick rows v, or at one head a and g_pre a pick) only when
// the table needs a gradient, formed from the records with no table row;
// each block adds its warps' g_proj shares in warp order and writes one
// partial, and a second launch sums the partials in block order.  No
// float atomics anywhere, so the result is the same from run to run.  Cfg
// below holds the choices measured on the card: which
// kernels keep the projection in registers, and a register cap where
// more blocks an SM paid (tools/time_attend.py, PERF.md).
// fits() holds the limits (heads, width, H * W in shared mode); the
// wrapper refuses more (ROADMAP K5 wide rows).  Per-head mode takes its
// head count (at most kMaxHeads) at run time past one head.
//
// The table's element (Elem) is float32, or with XG_ATTEND_ELEM 1 or 2 at
// build time bfloat16 or float16: ops/_build.py builds this source three
// times, as the libraries attend, attend_bf16 and attend_f16, which nvcc
// compiles in parallel.  A 2-byte table is layer 0's under feat_dtype or
// compute_dtype "bfloat16" (JAX's GATConv over a bf16 h_src) or an F16
// feature file: its rows are read 4 elements (8 bytes) or 1 a lane and
// widened to float32 in registers, exactly, and everything after the load
// (the scores, the softmax, the payload, out, m, s and the backward's sums)
// is the float32 kernel's.  Such a table is layer 0's input and never
// needs a gradient, so its libraries build only the backward that writes
// none (g_el and g_proj).  The projections come in float32; under bf16
// the model passes them rounded to bfloat16, as JAX's _mp_dot rounds them,
// so each product of a bf16 element and a projection is exact in float32.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#ifndef XG_ATTEND_ELEM
#define XG_ATTEND_ELEM 0
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRow = 2048;  // floats of proj staged in shared memory
constexpr int kMaxHeads = 8;
constexpr int kMaxWidth = 512;
constexpr int kRedThreads = 1024;
constexpr int kWin = 32;                 // picks of a window: one ballot
constexpr int kFwdMaxBlocks = 132 * 16;  // the forward's persistent grid

template <bool kVec>
struct Lane;
template <>
struct Lane<true> {
  using T = float4;
  static constexpr int kF = 4;
};
template <>
struct Lane<false> {
  using T = float;
  static constexpr int kF = 1;
};

__device__ __forceinline__ float dot(float a, float b) { return a * b; }
__device__ __forceinline__ float dot(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ void axpy(float& acc, float w, float v) {
  acc += w * v;
}
__device__ __forceinline__ void axpy(float4& acc, float w, float4 v) {
  acc.x += w * v.x;
  acc.y += w * v.y;
  acc.z += w * v.z;
  acc.w += w * v.w;
}
__device__ __forceinline__ void scal(float& a, float s) { a *= s; }
__device__ __forceinline__ void scal(float4& a, float s) {
  a.x *= s;
  a.y *= s;
  a.z *= s;
  a.w *= s;
}
__device__ __forceinline__ void divide(float& a, float s) { a /= s; }
__device__ __forceinline__ void divide(float4& a, float s) {
  a.x /= s;
  a.y /= s;
  a.z /= s;
  a.w /= s;
}
__device__ __forceinline__ void add(float& a, float b) { a += b; }
__device__ __forceinline__ void add(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <typename T>
__device__ __forceinline__ T ldg(const float* p) {
  return __ldg(reinterpret_cast<const T*>(p));
}
template <typename T>
__device__ __forceinline__ T ld(const float* p) {
  return *reinterpret_cast<const T*>(p);
}
template <typename T>
__device__ __forceinline__ void st(float* p, T v) {
  *reinterpret_cast<T*>(p) = v;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// A 2-byte table element: bfloat16 or float16 bits
struct Bf16 {
  uint16_t bits;
};
struct Half {
  uint16_t bits;
};
using Elem = std::conditional_t<
    XG_ATTEND_ELEM == 1, Bf16,
    std::conditional_t<XG_ATTEND_ELEM == 2, Half, float>>;
constexpr bool kWide = std::is_same_v<Elem, float>;

__device__ __forceinline__ float widen(Bf16, uint32_t b) {
  return __uint_as_float((b & 0xffffu) << 16);
}
__device__ __forceinline__ float widen(Half, uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)(b & 0xffffu)));
}

// A lane's slice T (float4 or float) of a table row at p, as float32: a
// float32 table's read as it is, a 2-byte table's 4 (8 bytes) or 1
// elements widened exactly.
template <typename T>
__device__ __forceinline__ T ldt(const float* p) {
  return ldg<T>(p);
}
template <typename T, typename E>
__device__ __forceinline__ T ldt(const E* p) {
  if constexpr (std::is_same_v<T, float4>) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));  // low first
    return make_float4(widen(E{}, v.x), widen(E{}, v.x >> 16),
                       widen(E{}, v.y), widen(E{}, v.y >> 16));
  } else {
    return widen(E{}, __ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

// x[0..V) summed over the warp, V a power of two up to 32, in V - 1 +
// log2(32 / V) shuffles: each halving step keeps half the values in the
// lanes whose bit o is set and the other half in their partners.  On return
// lane l holds the sum of value l >> (5 - log2 V), bit-equal in all the
// 32 / V lanes that hold it.
template <int V>
__device__ __forceinline__ float transpose_sum(float (&x)[V], int lane) {
#pragma unroll
  for (int n = V, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = up ? x[i] : x[i + n / 2];
      const float keep = up ? x[i + n / 2] : x[i];
      x[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float t = x[0];
#pragma unroll
  for (int o = 16 / V; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
  return t;
}

// the picks neigh[b, w0 + lane] of one window: the lane's id (0 where not
// valid) and the warp's mask of the valid ones
__device__ __forceinline__ unsigned window(const int32_t* nrow, int w0,
                                           int fanout, int64_t num_rows,
                                           int lane, int32_t* id) {
  const int k = w0 + lane;
  const int32_t v = k < fanout ? __ldg(nrow + k) : -1;
  const bool ok = v >= 0 && (int64_t)v < num_rows;
  *id = ok ? v : 0;
  return __ballot_sync(kFull, ok);
}

// the next set bit of *mm (cleared), or -1; its pick's id, from its lane
__device__ __forceinline__ int next_pick(unsigned* mm, int32_t id,
                                         int32_t* pid) {
  if (*mm == 0) return -1;
  const int p = __ffs(*mm) - 1;
  *mm &= *mm - 1;
  *pid = __shfl_sync(kFull, id, p);
  return p;
}

// the lane's NV elements of a table row (zero past the row's ne elements)
template <typename T, int NV>
__device__ __forceinline__ void load_row(T (&r)[NV], const Elem* table,
                                         int32_t id, int width, int ne,
                                         int lane) {
  constexpr int kF = sizeof(T) / sizeof(float);
  const Elem* p = table + (int64_t)id * width;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    r[j] = e < ne ? ldt<T>(p + e * kF) : zero<T>();
  }
}

// proj into shared memory: shared mode as sp[h * W + c] (wr transposed,
// zero for the heads from nh up to H), per-head mode as given (sp[h * d +
// i] = attn_r[h, i])
template <int H, bool kShared>
__device__ __forceinline__ void stage_proj(const float* proj, float* sp,
                                           int width, int nh) {
  const int n = kShared ? width * H : width;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    if (kShared) {
      const int h = t / width, c = t - h * width;
      sp[t] = h < nh ? __ldg(proj + (int64_t)c * nh + h) : 0.f;
    } else {
      sp[t] = __ldg(proj + t);
    }
  }
  __syncthreads();
}

template <int NV>
__device__ __forceinline__ void lane_heads(int (&hd)[NV], int kF, int d,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < NV; ++j) hd[j] = ((lane + 32 * j) * kF) / d;
}

// The score projection as a lane reads it: with kReg (shared mode), the
// lane's columns of every head in registers, else the copy staged in
// shared memory.
template <int H, int NV, bool kShared, bool kReg, typename T>
struct Proj {
  static constexpr int kF = sizeof(T) / sizeof(float);
  T q[kReg ? H : 1][kReg ? NV : 1];
  const float* sp;
  int width;

  __device__ __forceinline__ Proj(const float* staged, int w, int ne,
                                  int lane)
      : sp(staged), width(w) {
    if constexpr (kReg) {
#pragma unroll
      for (int h = 0; h < H; ++h)
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int e = lane + 32 * j;
          q[h][j] = e < ne ? ld<T>(sp + h * width + e * kF) : zero<T>();
        }
    }
  }
  // head h's (shared) or element e's head's (per-head) coefficients at the
  // lane's chunk j, element e
  __device__ __forceinline__ T at(int h, int j, int e) const {
    if constexpr (kReg) return q[h][j];
    return kShared ? ld<T>(sp + h * width + e * kF) : ld<T>(sp + e * kF);
  }
};

// the lane's share of every head's score of row r: x[h] += r . q_h, q_h
// the projection's head h (shared) or the head's slice (per-head: element
// j belongs to head hd[j])
template <int H, int NV, bool kShared, typename T, typename Q, int V>
__device__ __forceinline__ void score_parts(float (&x)[V], const T (&r)[NV],
                                            const Q& q, const int (&hd)[NV],
                                            int ne, int lane) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    if (e >= ne) continue;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (kShared) {
        x[h] += dot(r[j], q.at(h, j, e));
      } else if (hd[j] == h) {
        x[h] += dot(r[j], q.at(0, j, e));
      }
    }
  }
}

// Per (H, NV, kVec, kShared): whether a kernel takes the online form (one
// head in shared mode, or per-head mode: the accumulator is the lane's NV
// chunks whatever the heads), whether the projection stays in registers,
// whether the online backward keeps its g_proj share in registers, and
// the blocks an SM should hold (a register cap; 1: none).
template <int H, int NV, bool kVec, bool kShared>
struct Cfg {
  static constexpr int kF = Lane<kVec>::kF;
  static constexpr bool kOnline = H == 1 || !kShared;
  static constexpr int kFwdBlocks =
      kOnline ? (kVec && NV == 1 ? 8 : 1) : (NV == 1 ? 3 : 1);
  static constexpr bool kFwdReg = kOnline && kShared && kFwdBlocks == 1;
  static constexpr bool kBwdReg = kShared && H * NV <= 8;
  static constexpr bool kGpReg = kOnline && NV * kF <= 4;
  static constexpr int kBwdBlocks = kOnline ? (kVec && NV > 1 ? 3 : 1) : 2;
};

// The online form, where the accumulator is the lane's NV chunks whatever
// the heads (one head in shared mode, or per-head mode): for one window,
// each valid pick's score, the running max and sum, and the payload added
// with the rescale.  A head's scale and weight reach the lanes of its
// chunks by a shuffle from a lane that holds them.
template <int H, int NV, bool kShared, typename T, typename Q>
__device__ __forceinline__ void fwd_online(
    const Elem* __restrict__ table, const Q& q,
    unsigned mask, int32_t id, float el, float slope, int width, int ne,
    const int (&hd)[NV], int lane, float* mx, float* sm, T (&acc)[NV]) {
  constexpr int R = 32 / H;
  unsigned mm = mask;
  int32_t pid = 0;
  int p = next_pick(&mm, id, &pid);
  T cur[NV];
  if (p >= 0) load_row<T, NV>(cur, table, pid, width, ne, lane);
  while (p >= 0) {
    int32_t nid = 0;
    const int pn = next_pick(&mm, id, &nid);
    T nxt[NV];
    if (pn >= 0) load_row<T, NV>(nxt, table, nid, width, ne, lane);
    float x[H];
#pragma unroll
    for (int h = 0; h < H; ++h) x[h] = 0.f;
    score_parts<H, NV, kShared, T>(x, cur, q, hd, ne, lane);
    const float e = leaky(el + transpose_sum<H>(x, lane), slope);
    // the max grows: rescale the sum and the payload
    float scale = 1.f;
    if (e > *mx) {
      scale = expf(*mx - e);
      *sm *= scale;
      *mx = e;
    }
    const float w = expf(e - *mx);
    *sm += w;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float sj = H == 1 ? scale : __shfl_sync(kFull, scale, hd[j] * R);
      const float wj = H == 1 ? w : __shfl_sync(kFull, w, hd[j] * R);
      if (sj != 1.f) scal(acc[j], sj);
      axpy(acc[j], wj, cur[j]);
    }
    p = pn;
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

// Scores first (shared mode, two heads or more), pass 1 over one window:
// each valid pick's e = leaky(el + score) into rec[p * H + head] (the
// lane's head: lane / (32 / H)), and with kMax the running max and sum of
// exp(e - max).
template <int H, int NV, bool kMax, typename T, typename Q>
__device__ __forceinline__ void fwd_scores(
    const Elem* __restrict__ table, const Q& q,
    float* rec, unsigned mask, int32_t id, float el, float slope, int width,
    int ne, const int (&hd)[NV], int lane, float* mx, float* sm) {
  constexpr int R = 32 / H;
  const int hl = lane / R;
  unsigned mm = mask;
  int32_t pid = 0;
  int p = next_pick(&mm, id, &pid);
  T cur[NV];
  if (p >= 0) load_row<T, NV>(cur, table, pid, width, ne, lane);
  while (p >= 0) {
    int32_t nid = 0;
    const int pn = next_pick(&mm, id, &nid);
    T nxt[NV];
    if (pn >= 0) load_row<T, NV>(nxt, table, nid, width, ne, lane);
    float x[H];
#pragma unroll
    for (int h = 0; h < H; ++h) x[h] = 0.f;
    score_parts<H, NV, true, T>(x, cur, q, hd, ne, lane);
    const float e = leaky(el + transpose_sum<H>(x, lane), slope);
    if (lane % R == 0) rec[p * H + hl] = e;
    if (kMax) {
      const float m_new = fmaxf(*mx, e);
      *sm = *sm * expf(*mx - m_new) + expf(e - m_new);
      *mx = m_new;
    }
    p = pn;
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

// a warp per dst row, persistent over rows
template <int H, int NV, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads,
                                  (Cfg<H, NV, kVec, kShared>::kFwdBlocks))
attend_fwd_kernel(const Elem* __restrict__ table,
                  const int32_t* __restrict__ neigh,
                  const float* __restrict__ el_dst,
                  const float* __restrict__ proj, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ s_out,
                  int64_t num_rows, int64_t num_dst, int fanout, int width,
                  int nh, float slope) {
  using T = typename Lane<kVec>::T;
  constexpr int kF = Lane<kVec>::kF;
  using C = Cfg<H, NV, kVec, kShared>;
  constexpr int R = 32 / H;  // lanes of a head after the transpose-reduce
  constexpr bool kOnline = C::kOnline;
  __shared__ __align__(16) float sp[kMaxRow];
  __shared__ __align__(16) float recs[kWarps][kOnline ? 1 : kWin * H];
  stage_proj<H, kShared>(proj, sp, width, nh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ne = width / kF;
  const int hl = lane / R;
  int hd[NV];
  lane_heads<NV>(hd, kF, kShared ? width : width / nh, lane);
  const Proj<H, NV, kShared, C::kFwdReg, T> q(sp, width, ne, lane);
  float* rec = recs[warp];
  const bool multi = fanout > kWin;
  // row stride of out: H rows of W (shared) or one of H*d
  const int64_t orow = kShared ? (int64_t)nh * width : width;

  for (int64_t b = (int64_t)blockIdx.x * kWarps + warp; b < num_dst;
       b += (int64_t)gridDim.x * kWarps) {
    const float el = hl < nh ? __ldg(el_dst + b * nh + hl) : 0.f;
    const int32_t* nrow = neigh + b * fanout;
    float mx = -INFINITY, sm = 0.f;
    int32_t id = 0;
    unsigned mask = 0;
    if constexpr (kOnline) {
      T acc[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j] = zero<T>();
      for (int w0 = 0; w0 < fanout; w0 += kWin) {
        mask = window(nrow, w0, fanout, num_rows, lane, &id);
        fwd_online<H, NV, kShared, T>(table, q, mask, id, el, slope, width,
                                      ne, hd, lane, &mx, &sm, acc);
      }
      const float den = fmaxf(sm, 1e-9f);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float dj = H == 1 ? den : __shfl_sync(kFull, den, hd[j] * R);
        const int e = lane + 32 * j;
        if (e < ne) {
          divide(acc[j], dj);
          st<T>(out + b * orow + e * kF, acc[j]);
        }
      }
    } else {
      for (int w0 = 0; w0 < fanout; w0 += kWin) {
        mask = window(nrow, w0, fanout, num_rows, lane, &id);
        fwd_scores<H, NV, true, T>(table, q, rec, mask, id, el,
                                            slope, width, ne, hd, lane, &mx,
                                            &sm);
      }
      const float den = fmaxf(sm, 1e-9f);
      for (int w0 = 0; w0 < fanout; w0 += kWin) {
        if (multi) {  // this window's records again (pass 1 kept the last)
          __syncwarp();
          mask = window(nrow, w0, fanout, num_rows, lane, &id);
          fwd_scores<H, NV, false, T>(table, q, rec, mask, id, el,
                                               slope, width, ne, hd, lane,
                                               &mx, &sm);
        }
        __syncwarp();
        for (int p = lane % R; p < kWin; p += R)
          if ((mask >> p) & 1u)
            rec[p * H + hl] = expf(rec[p * H + hl] - mx) / den;
        __syncwarp();
        // pass 2, a lane's chunk j at a time: acc[h] = sum_p a[p][h] row_p
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int e = lane + 32 * j;
          const bool live = e < ne;
          T acc[H];
          float* o = out + b * orow + e * kF;
#pragma unroll
          for (int h = 0; h < H; ++h)
            acc[h] = (w0 > 0 && live && h < nh) ? ld<T>(o + h * width)
                                                : zero<T>();
          unsigned mm = mask;
          int32_t pid = 0;
          int p = next_pick(&mm, id, &pid);
          T cur = zero<T>();
          if (p >= 0 && live)
            cur = ldt<T>(table + (int64_t)pid * width + e * kF);
          while (p >= 0) {
            int32_t nid = 0;
            const int pn = next_pick(&mm, id, &nid);
            T nxt = zero<T>();
            if (pn >= 0 && live)
              nxt = ldt<T>(table + (int64_t)nid * width + e * kF);
            const float* wp = rec + p * H;
#pragma unroll
            for (int h = 0; h < H; ++h) axpy(acc[h], wp[h], cur);
            p = pn;
            cur = nxt;
          }
          if (live) {
#pragma unroll
            for (int h = 0; h < H; ++h)
              if (h < nh) st<T>(o + h * width, acc[h]);
          }
        }
      }
    }
    if (lane % R == 0 && hl < nh) {
      m_out[b * nh + hl] = isfinite(mx) ? mx : 0.f;
      s_out[b * nh + hl] = sm;
    }
    __syncwarp();  // the next row's pass 1 writes rec
  }
}

// floats of one head's g_proj share per warp in the backward: the lanes'
// NV elements of kF floats
template <int NV, bool kVec>
__host__ __device__ constexpr int bwd_head_floats() {
  return NV * 32 * Lane<kVec>::kF;
}

// The backward's records of a window, [p * H + head]: a, ga and leaky'.
struct Recs {
  float* a;
  float* g;  // ga, then g_pre
  float* d;  // leaky'(pre): 1 or slope
};

// Backward pass 1 over one window: g_out's row (loaded here, so it is live
// only while this runs), then for each valid pick the score and ga of
// every head in one transpose-reduce of 2H values; lanes 0-15 hold the
// scores and 16-31 the ga, and one more shuffle gives each lane both for
// its head (lane & 15) / (16 / H).  Returns sum_p a ga of the lane's head
// and adds sum_p a into *as: dot is their ratio, which stays exact where
// the saved m and s come from scores summed in another order (sum_p a is
// then 1 only to the scores' rounding, about 1e-6 at width 256).
// With kAcc (the online form), also the sums that give this dst row's
// g_proj share and g_el without a second pass over the rows: with c2 = a
// leaky' and c1 = c2 ga, g_pre = c1 - dot c2, so the share is
// sum_p c1 row_p - dot sum_p c2 row_p (gpa, gpb) and g_el is sa - dot sb.
template <int H, int NV, bool kShared, bool kAcc, bool kRec, typename T,
          typename Q>
__device__ __forceinline__ float bwd_records(
    const Elem* __restrict__ table, const float* __restrict__ g_out,
    const Q& q, Recs rec, unsigned mask, int32_t id,
    int64_t b, float el, float mx, float rden, float slope, int width,
    int ne, int nh, const int (&hd)[NV], int lane, T (&gpa)[NV],
    T (&gpb)[NV], float* as, float* sa, float* sb) {
  constexpr int kF = sizeof(T) / sizeof(float);
  constexpr int HA = kShared ? H : 1;
  constexpr int R2 = 16 / H;
  const int hl = (lane & 15) / R2;
  const bool writer = lane < 16 && lane % R2 == 0;
  const int64_t orow = kShared ? (int64_t)nh * width : width;
  T go[HA][NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
#pragma unroll
    for (int a = 0; a < HA; ++a) {
      const bool live = e < ne && (a < nh || !kShared);
      go[a][j] = live ? ldg<T>(g_out + b * orow + (int64_t)a * width + e * kF)
                      : zero<T>();
    }
  }
  float dt = 0.f;
  unsigned mm = mask;
  int32_t pid = 0;
  int p = next_pick(&mm, id, &pid);
  T cur[NV];
  if (p >= 0) load_row<T, NV>(cur, table, pid, width, ne, lane);
  while (p >= 0) {
    int32_t nid = 0;
    const int pn = next_pick(&mm, id, &nid);
    T nxt[NV];
    if (pn >= 0) load_row<T, NV>(nxt, table, nid, width, ne, lane);
    float x[2 * H];
#pragma unroll
    for (int h = 0; h < 2 * H; ++h) x[h] = 0.f;
    score_parts<H, NV, kShared, T>(x, cur, q, hd, ne, lane);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = lane + 32 * j;
      if (e >= ne) continue;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (kShared) {
          x[H + h] += dot(cur[j], go[h][j]);
        } else if (hd[j] == h) {
          x[H + h] += dot(cur[j], go[0][j]);
        }
      }
    }
    const float t = transpose_sum<2 * H>(x, lane);
    const float u = __shfl_xor_sync(kFull, t, 16);
    const float sc = lane < 16 ? t : u, ga = lane < 16 ? u : t;
    const float pre = el + sc;
    const float a = expf(leaky(pre, slope) - mx) * rden;
    const float d = pre >= 0.f ? 1.f : slope;
    dt += a * ga;
    *as += a;
    if (kRec && writer) {
      rec.a[p * H + hl] = a;
      rec.g[p * H + hl] = ga;
      rec.d[p * H + hl] = d;
    }
    if constexpr (kAcc) {
      const float c2 = a * d, c1 = c2 * ga;
      *sa += c1;
      *sb += c2;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float c1j = H == 1 ? c1 : __shfl_sync(kFull, c1, hd[j] * R2);
        const float c2j = H == 1 ? c2 : __shfl_sync(kFull, c2, hd[j] * R2);
        axpy(gpa[j], c1j, cur[j]);
        axpy(gpb[j], c2j, cur[j]);
      }
    }
    p = pn;
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
  return dt;
}

// The window's g_pre = a (ga - dot) leaky' in place of ga, each (pick,
// head) by one of the head's 32 / H lanes (rep, its replica index).
template <int H>
__device__ __forceinline__ void bwd_gpre(Recs rec, unsigned mask, float dt,
                                         int hl, int rep) {
  constexpr int R = 32 / H;
  __syncwarp();
  for (int p = rep; p < kWin; p += R) {
    if ((mask >> p) & 1u) {
      const int i = p * H + hl;
      rec.g[i] = rec.a[i] * (rec.g[i] - dt) * rec.d[i];
    }
  }
  __syncwarp();
}

// The window's per-pick rows v = sum_h a[p][h] g_out[b,h] + g_pre[p][h]
// proj_h (no table row needed): with float4 lanes or several shared heads
// a lane's chunk j at a time (its H chunks of g_out and proj in
// registers); with float lanes a pick at a time over the lane's NV chunks,
// which spends fewer instructions a pick.
template <int H, int NV, bool kShared, typename T, typename Q>
__device__ __forceinline__ void bwd_picks(
    const float* __restrict__ g_out, const Q& q, Recs rec, unsigned mask,
    int64_t b, int w0, float* __restrict__ per_pick, int fanout, int width,
    int ne, int nh, const int (&hd)[NV], int lane) {
  constexpr int kF = sizeof(T) / sizeof(float);
  const int64_t orow = kShared ? (int64_t)nh * width : width;
  if constexpr (kF == 4 || (kShared && H > 1)) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = lane + 32 * j;
      if (e >= ne) continue;
      T goc[H], qc[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        goc[h] = h < nh ? ldg<T>(g_out + b * orow + (int64_t)h * width +
                                 e * kF)
                        : zero<T>();
        qc[h] = q.at(h, j, e);
      }
      for (unsigned mm = mask; mm; mm &= mm - 1) {
        const int p = __ffs(mm) - 1;
        const float* aw = rec.a + p * H;
        const float* gw = rec.g + p * H;
        T v = zero<T>();
#pragma unroll
        for (int h = 0; h < H; ++h) {
          axpy(v, aw[h], goc[h]);
          axpy(v, gw[h], qc[h]);
        }
        st<T>(per_pick + (b * fanout + w0 + p) * (int64_t)width + e * kF, v);
      }
    }
  } else {
    T goc[NV], qc[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = lane + 32 * j;
      goc[j] = e < ne ? ldg<T>(g_out + b * orow + e * kF) : zero<T>();
      qc[j] = e < ne ? q.at(0, j, e) : zero<T>();
    }
    for (unsigned mm = mask; mm; mm &= mm - 1) {
      const int p = __ffs(mm) - 1;
      float* row = per_pick + (b * fanout + w0 + p) * (int64_t)width;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e = lane + 32 * j;
        // the element's head (per-head mode) or the one head
        float a = rec.a[p * H], g = rec.g[p * H];
#pragma unroll
        for (int h = 1; h < H; ++h) {
          if (hd[j] == h) {
            a = rec.a[p * H + h];
            g = rec.g[p * H + h];
          }
        }
        T v = zero<T>();
        axpy(v, a, goc[j]);
        axpy(v, g, qc[j]);
        if (e < ne) st<T>(row + e * kF, v);
      }
    }
  }
}

// What the backward writes for the table's gradient: nothing (the table
// needs none), a W-wide row v a pick (several heads), or a and g_pre a
// pick (one head).
enum TableGrad { kNone, kRows, kScalars };

template <int H, int NV, bool kVec, bool kShared, TableGrad kTable>
__global__ void __launch_bounds__(kThreads,
                                  (Cfg<H, NV, kVec, kShared>::kBwdBlocks))
attend_bwd_kernel(const Elem* __restrict__ table,
                  const int32_t* __restrict__ neigh,
                  const float* __restrict__ el_dst,
                  const float* __restrict__ proj,
                  const float* __restrict__ m_in,
                  const float* __restrict__ s_in,
                  const float* __restrict__ g_out, float* __restrict__ g_el,
                  float* __restrict__ partials, float* __restrict__ per_pick,
                  float* __restrict__ a_pick, float* __restrict__ gpre_pick,
                  int64_t num_rows, int64_t num_dst, int fanout, int width,
                  int nh, float slope) {
  static_assert(kTable != kScalars || H == 1, "two scalars a pick: one head");
  constexpr bool kPass2 = kTable != kNone;  // the window pass after dot
  using T = typename Lane<kVec>::T;
  constexpr int kF = Lane<kVec>::kF;
  constexpr int HA = kShared ? H : 1;
  constexpr int S = bwd_head_floats<NV, kVec>();
  using C = Cfg<H, NV, kVec, kShared>;
  constexpr int R2 = 16 / H;
  constexpr bool kOnline = C::kOnline;
  __shared__ __align__(16) float sp[kMaxRow];
  __shared__ __align__(16) float recs[kWarps][3][kWin * H];
  // each warp's share of g_proj, HA heads of S floats (dynamic, sized by
  // launch()); a lane's element (a, j) is T slot (a * NV + j) * 32 + lane,
  // so head a's column c is float a * S + c
  extern __shared__ __align__(16) float gps[];
  stage_proj<H, kShared>(proj, sp, width, nh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ne = width / kF;
  // the lane's head in the records and its replica among the 32 / H lanes
  // of that head
  const int hl = (lane & 15) / R2;
  const int rep = lane % R2 + (lane < 16 ? 0 : R2);
  int hd[NV];
  lane_heads<NV>(hd, kF, kShared ? width : width / nh, lane);
  const Proj<H, NV, kShared, C::kBwdReg, T> q(sp, width, ne, lane);
  const Recs rec{recs[warp][0], recs[warp][1], recs[warp][2]};
  const bool multi = fanout > kWin;

  T* gp = reinterpret_cast<T*>(gps + warp * HA * S) + lane;
#pragma unroll
  for (int a = 0; a < HA; ++a)
#pragma unroll
    for (int j = 0; j < NV; ++j) gp[(a * NV + j) * 32] = zero<T>();
  // the online form's share: in registers until the end where it is small
  T gpr[C::kGpReg ? NV : 1];
#pragma unroll
  for (int j = 0; j < (C::kGpReg ? NV : 1); ++j) gpr[j] = zero<T>();

  for (int64_t b = (int64_t)blockIdx.x * kWarps + warp; b < num_dst;
       b += (int64_t)gridDim.x * kWarps) {
    const bool hlive = hl < nh;
    const float el = hlive ? __ldg(el_dst + b * nh + hl) : 0.f;
    const float mx = hlive ? __ldg(m_in + b * nh + hl) : 0.f;
    const float rden = hlive ? 1.f / fmaxf(__ldg(s_in + b * nh + hl), 1e-9f)
                             : 1.f;
    const int32_t* nrow = neigh + b * fanout;
    int32_t id = 0;
    unsigned mask = 0;
    float dt = 0.f, as = 0.f, sa = 0.f, sb = 0.f;
    T gpa[NV], gpb[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) gpa[j] = gpb[j] = zero<T>();
    for (int w0 = 0; w0 < fanout; w0 += kWin) {
      mask = window(nrow, w0, fanout, num_rows, lane, &id);
      dt += bwd_records<H, NV, kShared, kOnline, kPass2 || !kOnline, T>(
          table, g_out, q, rec, mask, id, b, el, mx, rden, slope, width, ne,
          nh, hd, lane, gpa, gpb, &as, &sa, &sb);
    }
    dt = as > 0.f ? dt / as : 0.f;

    float gel = 0.f;
    if constexpr (kOnline) {
      gel = sa - dt * sb;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float dj = H == 1 ? dt : __shfl_sync(kFull, dt, hd[j] * R2);
        T t = gpa[j];
        axpy(t, -dj, gpb[j]);
        if constexpr (C::kGpReg) {
          add(gpr[j], t);
        } else {
          add(gp[j * 32], t);
        }
      }
    }
    for (int w0 = 0; w0 < fanout && (kPass2 || !kOnline); w0 += kWin) {
      if (multi) {  // this window's records again (pass 1 kept the last)
        __syncwarp();
        mask = window(nrow, w0, fanout, num_rows, lane, &id);
        bwd_records<H, NV, kShared, false, true, T>(
            table, g_out, q, rec, mask, id, b, el, mx, rden, slope, width,
            ne, nh, hd, lane, gpa, gpb, &as, &sa, &sb);
      }
      bwd_gpre<H>(rec, mask, dt, hl, rep);
      if constexpr (!kOnline) {
        for (unsigned mm = mask; mm; mm &= mm - 1)
          gel += rec.g[(__ffs(mm) - 1) * H + hl];
        // pass 2, a lane's chunk j at a time: g_proj's share, gpc[h] =
        // sum_p g_pre[p][h] row_p, added once per window
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          const int e = lane + 32 * j;
          const bool live = e < ne;
          T gpc[H];
#pragma unroll
          for (int h = 0; h < H; ++h) gpc[h] = zero<T>();
          unsigned mm = mask;
          int32_t pid = 0;
          int p = next_pick(&mm, id, &pid);
          T cur = zero<T>();
          if (p >= 0 && live)
            cur = ldt<T>(table + (int64_t)pid * width + e * kF);
          while (p >= 0) {
            int32_t nid = 0;
            const int pn = next_pick(&mm, id, &nid);
            T nxt = zero<T>();
            if (pn >= 0 && live)
              nxt = ldt<T>(table + (int64_t)nid * width + e * kF);
            const float* gw = rec.g + p * H;
#pragma unroll
            for (int h = 0; h < H; ++h) axpy(gpc[h], gw[h], cur);
            p = pn;
            cur = nxt;
          }
#pragma unroll
          for (int h = 0; h < H; ++h) add(gp[(h * NV + j) * 32], gpc[h]);
        }
      }
      if constexpr (kTable == kRows)
        bwd_picks<H, NV, kShared, T>(g_out, q, rec, mask, b, w0, per_pick,
                                     fanout, width, ne, nh, hd, lane);
      if constexpr (kTable == kScalars) {
        // lane p: pick w0 + p's a and g_pre (bwd_gpre formed them), one
        // coalesced store each
        const int k = w0 + lane;
        if (k < fanout) {
          const bool ok = (mask >> lane) & 1u;
          a_pick[b * fanout + k] = ok ? rec.a[lane] : 0.f;
          gpre_pick[b * fanout + k] = ok ? rec.g[lane] : 0.f;
        }
      }
    }
    if (lane < 16 && lane % R2 == 0 && hl < nh) g_el[b * nh + hl] = gel;
    __syncwarp();  // the next row's pass 1 writes the records
  }

  // the block's partial of g_proj, its warps added in warp order, laid out
  // as g_proj: (W, H) in shared mode, (H, d) = W floats per-head
  if constexpr (C::kGpReg) {
#pragma unroll
    for (int j = 0; j < NV; ++j) gp[j * 32] = gpr[j];
  }
  __syncthreads();
  const int pn = kShared ? width * nh : width;
  for (int t = threadIdx.x; t < pn; t += blockDim.x) {
    const int c = kShared ? t / nh : t, a = kShared ? t - c * nh : 0;
    float tot = gps[a * S + c];
    for (int w = 1; w < kWarps; ++w) tot += gps[(w * HA + a) * S + c];
    partials[(int64_t)blockIdx.x * pn + t] = tot;
  }
}

// g_proj[i] = sum over the blocks q, in order of q mod 32 and then of the
// 32 warps' sums, of partials[q][i]; 32 outputs per block
__global__ void __launch_bounds__(kRedThreads)
proj_reduce_kernel(const float* __restrict__ partials, int blocks, int pn,
                   float* __restrict__ g_proj) {
  __shared__ float part[kRedThreads / 32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float t = 0.f;
  if (i < pn)
    for (int q = warp; q < blocks; q += kRedThreads / 32)
      t += __ldg(partials + (int64_t)q * pn + i);
  part[warp][lane] = t;
  __syncthreads();
  if (warp == 0 && i < pn) {
    float tot = 0.f;
    for (int w = 0; w < kRedThreads / 32; ++w) tot += part[w][lane];
    g_proj[i] = tot;
  }
}

struct Args {
  const Elem* table;
  const int32_t* neigh;
  const float* el_dst;
  const float* proj;
  float* out;  // forward: out
  float* m;
  float* s;
  const float* g_out;
  float* g_el;
  float* partials;
  float* per_pick;
  float* a_pick;
  float* gpre_pick;
  long long num_rows, num_dst;
  int fanout, width, nh, blocks;
  float slope;
  cudaStream_t stream;
};

template <int H, int NV, bool kVec, bool kShared>
void launch(const Args& a, bool backward) {
  if (backward) {
    // the warps' g_proj shares: at most 8 warps x 2048 floats, 64 KiB
    const int smem = kWarps * (kShared ? H : 1) *
                     bwd_head_floats<NV, kVec>() * (int)sizeof(float);
    // the static part: the staged proj and the warps' records
    constexpr int kStatic = (kMaxRow + kWarps * 3 * kWin * H) * sizeof(float);
    constexpr TableGrad kTable = H == 1 ? kScalars : kRows;
    // a 2-byte table's libraries build only the backward that writes no
    // table gradient (the entry point refuses the others)
    auto kernel = attend_bwd_kernel<H, NV, kVec, kShared, kNone>;
    if constexpr (kWide)
      if (a.per_pick != nullptr || a.a_pick != nullptr)
        kernel = attend_bwd_kernel<H, NV, kVec, kShared, kTable>;
    if (smem + kStatic > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    kernel<<<a.blocks, kThreads, smem, a.stream>>>(
        a.table, a.neigh, a.el_dst, a.proj, a.m, a.s, a.g_out, a.g_el,
        a.partials, a.per_pick, a.a_pick, a.gpre_pick, a.num_rows,
        a.num_dst, a.fanout, a.width, a.nh, a.slope);
  } else {
    attend_fwd_kernel<H, NV, kVec, kShared>
        <<<a.blocks, kThreads, 0, a.stream>>>(
            a.table, a.neigh, a.el_dst, a.proj, a.out, a.m, a.s, a.num_rows,
            a.num_dst, a.fanout, a.width, a.nh, a.slope);
  }
}

// The lane's elements NV: float4 lanes for W <= 128, 256, 512; float lanes
// for W <= 64, 256, 512.  Every shape fits() admits has a branch: in shared
// mode H * W <= kMaxRow leaves H <= 4 past W = 256.  (if constexpr: each
// (H, kVec, kShared) instantiates only the kernels it can launch.)
template <int H, bool kVec, bool kShared>
bool by_width(const Args& a, bool backward) {
  if constexpr (kVec) {
    const int ne = a.width / 4;
    if (ne <= 32) return launch<H, 1, kVec, kShared>(a, backward), true;
    if (ne <= 64) return launch<H, 2, kVec, kShared>(a, backward), true;
    if constexpr (H <= 4)
      if (ne <= 128) return launch<H, 4, kVec, kShared>(a, backward), true;
  } else {
    const int ne = a.width;
    if (ne <= 64) return launch<H, 2, kVec, kShared>(a, backward), true;
    if (ne <= 256) return launch<H, 8, kVec, kShared>(a, backward), true;
    if constexpr (H <= 4 || !kShared)
      if (ne <= 512) return launch<H, 16, kVec, kShared>(a, backward), true;
  }
  return false;
}

// shared mode: the heads rounded up to a power of two size the records and
// the transpose-reduce
template <bool kVec>
bool by_heads(const Args& a, bool backward) {
  if (a.nh <= 1) return by_width<1, kVec, true>(a, backward);
  if (a.nh <= 2) return by_width<2, kVec, true>(a, backward);
  if (a.nh <= 4) return by_width<4, kVec, true>(a, backward);
  if (a.nh <= 8) return by_width<8, kVec, true>(a, backward);
  return false;
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

bool aligned16(const void* p) { return aligned(p, 16); }

// float4 lanes: shared mode, W % 4 == 0, every row-sized buffer aligned
// (the table to its 4 elements: 16 bytes of float32, 8 of a 2-byte type).
// Per-head mode has one accumulator of W/32 floats a lane whatever the
// heads, so the head count is a run-time value there: one head (the
// logits) has its own kernels, more heads share kernels whose records are
// sized kMaxHeads.
bool dispatch(const Args& a, bool shared, bool backward) {
  const bool vec = shared && a.width % 4 == 0 &&
                   aligned(a.table, 4 * (int)sizeof(Elem)) &&
                   aligned16(a.out) && aligned16(a.g_out) &&
                   aligned16(a.per_pick);
  if (!shared)
    return a.nh == 1 ? by_width<1, false, false>(a, backward)
                     : by_width<kMaxHeads, false, false>(a, backward);
  return vec ? by_heads<true>(a, backward) : by_heads<false>(a, backward);
}

// The kernels' limits, and the source of ops/attend.py's _check, which
// mirrors them so that the CPU path refuses the same shapes: at most
// kMaxHeads heads, a table at most kMaxWidth wide and in shared mode at
// most kMaxRow floats of an output row with the heads rounded up to a
// power of two (the staged proj and the backward's g_proj shares).
bool fits(long long num_rows, long long num_dst, int fanout, int width,
          int nh, int shared) {
  if (num_rows < 0 || num_rows >= INT32_MAX || num_dst < 0 || fanout < 0 ||
      num_dst * (long long)fanout >= INT32_MAX || width <= 0 || nh < 1 ||
      nh > kMaxHeads || width > kMaxWidth)
    return false;
  int hp = 1;
  while (hp < nh) hp <<= 1;
  if (shared) return (long long)hp * width <= kMaxRow;
  return width % nh == 0;
}

}  // namespace

// table: (num_rows, width) of Elem; neigh: (num_dst, fanout) int32; el_dst:
// (num_dst, nh) f32; proj: (width, nh) f32 (shared) or (nh, width / nh)
// (per-head); out: (num_dst, nh, width) or (num_dst, width) f32; m, s:
// (num_dst, nh) f32.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue, launching nothing, for shapes past the limits).
extern "C" int xg_attend_fwd(const void* table, const void* neigh,
                             const void* el_dst, const void* proj, void* out,
                             void* m, void* s, long long num_rows,
                             long long num_dst, int fanout, int width, int nh,
                             int shared, float slope, void* stream) {
  if (!fits(num_rows, num_dst, fanout, width, nh, shared))
    return (int)cudaErrorInvalidValue;
  if (num_dst == 0) return (int)cudaGetLastError();
  Args a{};
  a.table = static_cast<const Elem*>(table);
  a.neigh = static_cast<const int32_t*>(neigh);
  a.el_dst = static_cast<const float*>(el_dst);
  a.proj = static_cast<const float*>(proj);
  a.out = static_cast<float*>(out);
  a.m = static_cast<float*>(m);
  a.s = static_cast<float*>(s);
  a.num_rows = num_rows;
  a.num_dst = num_dst;
  a.fanout = fanout;
  a.width = width;
  a.nh = nh;
  a.slope = slope;
  a.stream = reinterpret_cast<cudaStream_t>(stream);
  const long long want = (num_dst + kWarps - 1) / kWarps;
  a.blocks = (int)(want < kFwdMaxBlocks ? want : kFwdMaxBlocks);
  if (!dispatch(a, shared != 0, false)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// The backward's row pass and the sum of its g_proj partials.  m, s: the
// forward's; g_out as the forward's out; g_el as el_dst; g_proj as proj;
// partials: (blocks, proj's size) f32 scratch.  For the table's gradient,
// at more than one head per_pick: (num_dst * fanout, width) f32, one row
// per pick (the rows of invalid picks are not written); at one head a_pick
// and gpre_pick: (num_dst, fanout) f32 each, a and g_pre a pick (0 for an
// invalid pick).  All null: the table needs no gradient (always so for a
// 2-byte table).
extern "C" int xg_attend_bwd(const void* table, const void* neigh,
                             const void* el_dst, const void* proj,
                             const void* m, const void* s, const void* g_out,
                             void* g_el, void* g_proj, void* partials,
                             void* per_pick, void* a_pick, void* gpre_pick,
                             int blocks, long long num_rows,
                             long long num_dst, int fanout, int width, int nh,
                             int shared, float slope, void* stream) {
  if (!fits(num_rows, num_dst, fanout, width, nh, shared) || blocks < 1 ||
      (a_pick != nullptr) != (gpre_pick != nullptr) ||
      (nh == 1 ? per_pick != nullptr : a_pick != nullptr) ||
      (!kWide && (per_pick != nullptr || a_pick != nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.table = static_cast<const Elem*>(table);
  a.neigh = static_cast<const int32_t*>(neigh);
  a.el_dst = static_cast<const float*>(el_dst);
  a.proj = static_cast<const float*>(proj);
  a.m = const_cast<float*>(static_cast<const float*>(m));
  a.s = const_cast<float*>(static_cast<const float*>(s));
  a.g_out = static_cast<const float*>(g_out);
  a.g_el = static_cast<float*>(g_el);
  a.partials = static_cast<float*>(partials);
  a.per_pick = static_cast<float*>(per_pick);
  a.a_pick = static_cast<float*>(a_pick);
  a.gpre_pick = static_cast<float*>(gpre_pick);
  a.num_rows = num_rows;
  a.num_dst = num_dst;
  a.fanout = fanout;
  a.width = width;
  a.nh = nh;
  a.blocks = blocks;
  a.slope = slope;
  a.stream = reinterpret_cast<cudaStream_t>(stream);
  if (!dispatch(a, shared != 0, true)) return (int)cudaErrorInvalidValue;
  const int pn = shared ? width * nh : width;
  proj_reduce_kernel<<<(pn + 31) / 32, kRedThreads, 0, a.stream>>>(
      a.partials, blocks, pn, static_cast<float*>(g_proj));
  return (int)cudaGetLastError();
}
