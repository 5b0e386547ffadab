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
// Backward, with a_k = exp(e_k - m) / max(s, 1e-9) and dot_h = g_out[b,h] .
// out[b,h]:
//   g_pre_k = a_k (g_out[b,h] . payload_h(row_k) - dot_h) * leaky'(pre_k)
//   g_el[b,h] = sum_k g_pre_k;  g_proj = sum over every pick of g_pre_k row_k
//   (per head, or per head's slice); and, when the table needs a gradient,
//   one row per pick, v_k = sum_h a_k g_out[b,h] (on the payload) + g_pre_k
//   proj_h (through the score), which the caller sums by src row with K4's
//   segmented backward (csrc/fanout.cu).
//
// Replaces: xgnn_tpu/models/gnn.py, GATConv._online_attend (a K-pass XLA
// loop with a (dst, H, W) accumulator in HBM) with the score and payload of
// its aggregate-first and transform-first paths, and its autodiff.  On the
// TPU it was XLA ops, not a Pallas kernel.
//
// What bounds it on an H100: bytes.  The forward reads each valid pick's
// row once and writes each output row once (the main path's layer 0 at one
// head: 5.04M rows of 512 B and a 515 MB output, about 0.9 ms at 3.35
// TB/s); per pick element it does 2H multiply-adds, far below the card's
// float32 rate up to 8 heads.  The backward reads the rows again, g_out and
// out, and writes the per-pick rows, which the segmented sum reads back.
//
// Design, forward: one warp per dst row (persistent warps walk the rows),
// lanes across the width (a float4 per lane where the row is 16-byte
// aligned, else a float).  Each pick's
// row is loaded once into registers, the next valid pick's row is loaded
// while the current one is used, the score of each head is a warp-shuffle
// reduction, and the running max, sum and the (H, W') accumulator stay in
// registers, rescaled only when the max grows (flash attention's online
// softmax).  The projection is staged in shared memory.  The output row is
// written once; the (dst, H, W) accumulator never round-trips device
// memory as it did in the K-pass XLA loop.
// Design, backward row pass: the same warp per dst row, persistent over
// rows (a fixed grid for a given D), with g_out's row in registers.  It
// recomputes each pick's score and a_k from the saved m and s, writes
// g_el, and adds the lane's share of g_proj into lane-private slots of
// shared memory (registers would spill at 8 heads); each block adds its
// warps' shares in warp order and writes one partial, and a second launch
// sums the partials in block order.  No float atomics anywhere, so the
// result is the same from run to run.
// Registers: the shared mode's accumulator (or g_out's row) is H*W/32
// floats per lane, with H rounded up to a power of two: at most 64 (8
// heads of 256, 4 of 512).  fits() below holds these limits; the wrapper
// refuses more (ROADMAP K5 wide rows).  Per-head mode accumulates W/32
// floats and takes its head count (at most kMaxHeads) at run time past
// one head.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRow = 2048;  // floats of proj staged in shared memory
constexpr int kMaxHeads = 8;
constexpr int kMaxWidth = 512;
constexpr int kRedThreads = 1024;
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
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <typename T>
__device__ __forceinline__ T ldg(const float* p);
template <>
__device__ __forceinline__ float ldg<float>(const float* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float4 ldg<float4>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
template <typename T>
__device__ __forceinline__ T lds(const float* p) {
  return *reinterpret_cast<const T*>(p);
}
template <typename T>
__device__ __forceinline__ void st(float* p, T v) {
  *reinterpret_cast<T*>(p) = v;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float leaky(float x, float slope) {
  return x >= 0.f ? x : slope * x;
}

// the first valid pick at or after k (fanout if none), its id in *id
__device__ __forceinline__ int next_valid(const int32_t* nrow, int k,
                                          int fanout, int64_t num_rows,
                                          int32_t* id) {
  for (; k < fanout; ++k) {
    const int32_t v = __ldg(nrow + k);
    if (v >= 0 && (int64_t)v < num_rows) {
      *id = v;
      return k;
    }
  }
  return fanout;
}

// the lane's NV elements of a table row (zero past the row's ne elements)
template <typename T, int NV>
__device__ __forceinline__ void load_row(T (&r)[NV], const float* table,
                                         int32_t id, int width, int ne,
                                         int lane) {
  constexpr int kF = sizeof(T) / sizeof(float);
  const float* p = table + (int64_t)id * width;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    r[j] = e < ne ? ldg<T>(p + e * kF) : zero<T>();
  }
}

// proj into shared memory: shared mode as sp[h * W + c] (wr transposed),
// per-head mode as given (sp[h * d + i] = attn_r[h, i])
template <bool kShared>
__device__ __forceinline__ void stage_proj(const float* proj, float* sp,
                                           int width, int nh) {
  const int n = kShared ? width * nh : width;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    if (kShared) {
      const int h = t / width, c = t - h * width;
      sp[t] = __ldg(proj + (int64_t)c * nh + h);
    } else {
      sp[t] = __ldg(proj + t);
    }
  }
  __syncthreads();
}

// per head, the lane's share of row . q_h, summed over the warp; q_h is
// sp's head h (shared) or the head's slice (per-head: element e is column
// e * kF of head hd[j])
template <int H, int NV, bool kShared, typename T>
__device__ __forceinline__ void head_dots(float (&out)[H], const T (&r)[NV],
                                          const float* sp, const int (&hd)[NV],
                                          int width, int ne, int nh,
                                          int lane) {
  constexpr int kF = sizeof(T) / sizeof(float);
#pragma unroll
  for (int h = 0; h < H; ++h) out[h] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    if (e >= ne) continue;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (kShared) {
        if (h < nh) out[h] += dot(r[j], lds<T>(sp + h * width + e * kF));
      } else if (hd[j] == h) {
        out[h] += dot(r[j], lds<T>(sp + e * kF));
      }
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (h < nh) out[h] = warp_sum(out[h]);
}

// the same with a per-lane vector in place of sp (g_out's row)
template <int H, int NV, bool kShared, typename T>
__device__ __forceinline__ void head_dots_reg(
    float (&out)[H], const T (&r)[NV], const T (&g)[kShared ? H : 1][NV],
    const int (&hd)[NV], int ne, int nh, int lane) {
#pragma unroll
  for (int h = 0; h < H; ++h) out[h] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    if (e >= ne) continue;
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (kShared) {
        if (h < nh) out[h] += dot(r[j], g[h][j]);
      } else if (hd[j] == h) {
        out[h] += dot(r[j], g[0][j]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (h < nh) out[h] = warp_sum(out[h]);
}

template <int NV>
__device__ __forceinline__ void lane_heads(int (&hd)[NV], int kF, int d,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < NV; ++j) hd[j] = ((lane + 32 * j) * kF) / d;
}

// the forward of dst row b, by one warp
template <int H, int NV, bool kShared, typename T>
__device__ __forceinline__ void attend_row(
    const float* __restrict__ table, const int32_t* __restrict__ neigh,
    const float* __restrict__ el_dst, const float* sp, float* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ s_out, int64_t num_rows,
    int64_t b, int fanout, int width, int ne, int nh, float slope,
    const int (&hd)[NV], int lane) {
  constexpr int kF = sizeof(T) / sizeof(float);
  constexpr int HA = kShared ? H : 1;
  float el[H], mx[H], sm[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    el[h] = h < nh ? __ldg(el_dst + b * nh + h) : 0.f;
    mx[h] = -INFINITY;
    sm[h] = 0.f;
  }
  T acc[HA][NV];
#pragma unroll
  for (int a = 0; a < HA; ++a)
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[a][j] = zero<T>();

  const int32_t* nrow = neigh + b * fanout;
  int32_t id = 0;
  int k = next_valid(nrow, 0, fanout, num_rows, &id);
  T cur[NV];
  if (k < fanout) load_row<T, NV>(cur, table, id, width, ne, lane);
  while (k < fanout) {
    // the next valid pick's row is in flight while this one is used
    int32_t id_next = 0;
    const int k_next = next_valid(nrow, k + 1, fanout, num_rows, &id_next);
    T nxt[NV];
    if (k_next < fanout)
      load_row<T, NV>(nxt, table, id_next, width, ne, lane);

    float sc[H];
    head_dots<H, NV, kShared, T>(sc, cur, sp, hd, width, ne, nh, lane);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (h >= nh) continue;
      const float e = leaky(el[h] + sc[h], slope);
      if (e > mx[h]) {  // the max grows: rescale the sum and the payload
        const float scale = expf(mx[h] - e);
        sm[h] *= scale;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          if (kShared) {
            scal(acc[h][j], scale);
          } else if (hd[j] == h) {
            scal(acc[0][j], scale);
          }
        }
        mx[h] = e;
      }
      const float w = expf(e - mx[h]);
      sm[h] += w;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (kShared) {
          axpy(acc[h][j], w, cur[j]);
        } else if (hd[j] == h) {
          axpy(acc[0][j], w, cur[j]);
        }
      }
    }
    k = k_next;
    id = id_next;
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }

  float den[H];
#pragma unroll
  for (int h = 0; h < H; ++h) den[h] = fmaxf(sm[h], 1e-9f);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int e = lane + 32 * j;
    if (e >= ne) continue;
    if (kShared) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (h >= nh) continue;
        T v = acc[h][j];
        divide(v, den[h]);
        st<T>(out + (b * nh + h) * width + e * kF, v);
      }
    } else {
      T v = acc[0][j];
#pragma unroll
      for (int h = 0; h < H; ++h)
        if (hd[j] == h) divide(v, den[h]);
      st<T>(out + b * width + e * kF, v);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      if (h >= nh) continue;
      m_out[b * nh + h] = isfinite(mx[h]) ? mx[h] : 0.f;
      s_out[b * nh + h] = sm[h];
    }
  }
}

// floats of one head's g_proj share per warp in the backward: the lanes'
// NV elements of kF floats
template <int NV, bool kVec>
__host__ __device__ constexpr int bwd_head_floats() {
  return NV * 32 * Lane<kVec>::kF;
}

// a warp per dst row, persistent over rows
template <int H, int NV, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
attend_fwd_kernel(const float* __restrict__ table,
                  const int32_t* __restrict__ neigh,
                  const float* __restrict__ el_dst,
                  const float* __restrict__ proj, float* __restrict__ out,
                  float* __restrict__ m_out, float* __restrict__ s_out,
                  int64_t num_rows, int64_t num_dst, int fanout, int width,
                  int nh, float slope) {
  using T = typename Lane<kVec>::T;
  constexpr int kF = Lane<kVec>::kF;
  __shared__ __align__(16) float sp[kMaxRow];
  stage_proj<kShared>(proj, sp, width, nh);
  const int lane = threadIdx.x & 31;
  const int ne = width / kF;
  int hd[NV];
  lane_heads<NV>(hd, kF, kShared ? width : width / nh, lane);
  for (int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       b < num_dst; b += (int64_t)gridDim.x * kWarps)
    attend_row<H, NV, kShared, T>(table, neigh, el_dst, sp, out, m_out, s_out,
                                  num_rows, b, fanout, width, ne, nh, slope,
                                  hd, lane);
}

template <int H, int NV, bool kVec, bool kShared>
__global__ void __launch_bounds__(kThreads)
attend_bwd_kernel(const float* __restrict__ table,
                  const int32_t* __restrict__ neigh,
                  const float* __restrict__ el_dst,
                  const float* __restrict__ proj,
                  const float* __restrict__ out,
                  const float* __restrict__ m_in,
                  const float* __restrict__ s_in,
                  const float* __restrict__ g_out, float* __restrict__ g_el,
                  float* __restrict__ partials, float* __restrict__ per_pick,
                  int64_t num_rows, int64_t num_dst, int fanout, int width,
                  int nh, float slope) {
  using T = typename Lane<kVec>::T;
  constexpr int kF = Lane<kVec>::kF;
  constexpr int HA = kShared ? H : 1;
  constexpr int S = bwd_head_floats<NV, kVec>();
  __shared__ __align__(16) float sp[kMaxRow];
  // each warp's share of g_proj, HA heads of S floats (dynamic, sized by
  // launch()); a lane's element (a, j) is T slot (a * NV + j) * 32 + lane,
  // so head a's column c is float a * S + c
  extern __shared__ __align__(16) float gps[];
  stage_proj<kShared>(proj, sp, width, nh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ne = width / kF;
  int hd[NV];
  lane_heads<NV>(hd, kF, kShared ? width : width / nh, lane);
  // row stride of g_out and out: H rows of W (shared) or one of H*d
  const int64_t orow = kShared ? (int64_t)nh * width : width;

  T* gp = reinterpret_cast<T*>(gps + warp * HA * S) + lane;
#pragma unroll
  for (int a = 0; a < HA; ++a)
#pragma unroll
    for (int j = 0; j < NV; ++j) gp[(a * NV + j) * 32] = zero<T>();

  for (int64_t b = (int64_t)blockIdx.x * kWarps + warp; b < num_dst;
       b += (int64_t)gridDim.x * kWarps) {
    T go[HA][NV];
    float dt[H];
#pragma unroll
    for (int h = 0; h < H; ++h) dt[h] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int e = lane + 32 * j;
#pragma unroll
      for (int a = 0; a < HA; ++a) {
        const bool live = e < ne && (a < nh || !kShared);
        const int64_t at = b * orow + (int64_t)a * width + e * kF;
        go[a][j] = live ? ldg<T>(g_out + at) : zero<T>();
        if (live) {
          const float x = dot(go[a][j], ldg<T>(out + at));
          if (kShared) {
            dt[a] += x;
          } else {
#pragma unroll
            for (int h = 0; h < H; ++h)
              if (hd[j] == h) dt[h] += x;
          }
        }
      }
    }
    float el[H], mx[H], rden[H], gel[H];  // rden: 1 / max(s, 1e-9)
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const bool live = h < nh;
      if (live) dt[h] = warp_sum(dt[h]);
      el[h] = live ? __ldg(el_dst + b * nh + h) : 0.f;
      mx[h] = live ? __ldg(m_in + b * nh + h) : 0.f;
      rden[h] = live ? 1.f / fmaxf(__ldg(s_in + b * nh + h), 1e-9f) : 1.f;
      gel[h] = 0.f;
    }

    const int32_t* nrow = neigh + b * fanout;
    int32_t id = 0;
    int k = next_valid(nrow, 0, fanout, num_rows, &id);
    T cur[NV];
    if (k < fanout) load_row<T, NV>(cur, table, id, width, ne, lane);
    while (k < fanout) {
      int32_t id_next = 0;
      const int k_next = next_valid(nrow, k + 1, fanout, num_rows, &id_next);
      T nxt[NV];
      if (k_next < fanout)
        load_row<T, NV>(nxt, table, id_next, width, ne, lane);

      float sc[H], ga[H], a[H], gpre[H];
      head_dots<H, NV, kShared, T>(sc, cur, sp, hd, width, ne, nh, lane);
      head_dots_reg<H, NV, kShared, T>(ga, cur, go, hd, ne, nh, lane);
#pragma unroll
      for (int h = 0; h < H; ++h) {
        if (h >= nh) {
          a[h] = gpre[h] = 0.f;
          continue;
        }
        const float pre = el[h] + sc[h];
        a[h] = expf(leaky(pre, slope) - mx[h]) * rden[h];
        const float ge = a[h] * (ga[h] - dt[h]);
        gpre[h] = pre >= 0.f ? ge : slope * ge;
        gel[h] += gpre[h];
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int e = lane + 32 * j;
        if (e >= ne) continue;
        T v = zero<T>();
        if (kShared) {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            if (h >= nh) continue;
            axpy(gp[(h * NV + j) * 32], gpre[h], cur[j]);
            axpy(v, a[h], go[h][j]);
            axpy(v, gpre[h], lds<T>(sp + h * width + e * kF));
          }
        } else {
#pragma unroll
          for (int h = 0; h < H; ++h) {
            if (hd[j] != h) continue;
            axpy(gp[j * 32], gpre[h], cur[j]);
            axpy(v, a[h], go[0][j]);
            axpy(v, gpre[h], lds<T>(sp + e * kF));
          }
        }
        if (per_pick != nullptr)
          st<T>(per_pick + (b * fanout + k) * (int64_t)width + e * kF, v);
      }
      k = k_next;
      id = id_next;
#pragma unroll
      for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
    }
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < H; ++h)
        if (h < nh) g_el[b * nh + h] = gel[h];
    }
  }

  // the block's partial of g_proj, its warps added in warp order, laid out
  // as g_proj: (W, H) in shared mode, (H, d) = W floats per-head
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
  const float* table;
  const int32_t* neigh;
  const float* el_dst;
  const float* proj;
  const float* out_in;  // backward: the forward's out
  float* out;           // forward: out
  float* m;
  float* s;
  const float* g_out;
  float* g_el;
  float* partials;
  float* per_pick;
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
    auto kernel = attend_bwd_kernel<H, NV, kVec, kShared>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
    kernel<<<a.blocks, kThreads, smem, a.stream>>>(
        a.table, a.neigh, a.el_dst, a.proj, a.out_in, a.m, a.s, a.g_out,
        a.g_el, a.partials, a.per_pick, a.num_rows, a.num_dst, a.fanout,
        a.width, a.nh, a.slope);
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

// shared mode: the heads rounded up to a power of two size the accumulator
template <bool kVec>
bool by_heads(const Args& a, bool backward) {
  if (a.nh <= 1) return by_width<1, kVec, true>(a, backward);
  if (a.nh <= 2) return by_width<2, kVec, true>(a, backward);
  if (a.nh <= 4) return by_width<4, kVec, true>(a, backward);
  if (a.nh <= 8) return by_width<8, kVec, true>(a, backward);
  return false;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// float4 lanes: shared mode, W % 4 == 0, every row-sized buffer aligned.
// Per-head mode has one accumulator of W/32 floats a lane whatever the
// heads, so the head count is a run-time value there: one head (the
// logits) has its own kernels, more heads share kernels whose per-head
// scalars are sized kMaxHeads.
bool dispatch(const Args& a, bool shared, bool backward) {
  const bool vec = shared && a.width % 4 == 0 && aligned16(a.table) &&
                   aligned16(a.out) && aligned16(a.out_in) &&
                   aligned16(a.g_out) && aligned16(a.per_pick);
  if (!shared)
    return a.nh == 1 ? by_width<1, false, false>(a, backward)
                     : by_width<kMaxHeads, false, false>(a, backward);
  return vec ? by_heads<true>(a, backward) : by_heads<false>(a, backward);
}

// The kernels' limits, and the source of ops/attend.py's _check, which
// mirrors them so that the CPU path refuses the same shapes: at most
// kMaxHeads heads, a table at most kMaxWidth wide, and in shared mode at
// most kMaxRow floats of an output row with the heads rounded up to a
// power of two (the registers of the accumulator and g_out's row, and the
// staged proj).
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

// table: (num_rows, width) f32; neigh: (num_dst, fanout) int32; el_dst:
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
  a.table = static_cast<const float*>(table);
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

// The backward's row pass and the sum of its g_proj partials.  out, m, s:
// the forward's; g_out as out; g_el as el_dst; g_proj as proj; partials:
// (blocks, proj's size) f32 scratch; per_pick: null, or (num_dst * fanout,
// width) f32, one row per pick (the rows of invalid picks are not written).
extern "C" int xg_attend_bwd(const void* table, const void* neigh,
                             const void* el_dst, const void* proj,
                             const void* out, const void* m, const void* s,
                             const void* g_out, void* g_el, void* g_proj,
                             void* partials, void* per_pick, int blocks,
                             long long num_rows, long long num_dst, int fanout,
                             int width, int nh, int shared, float slope,
                             void* stream) {
  if (!fits(num_rows, num_dst, fanout, width, nh, shared) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.table = static_cast<const float*>(table);
  a.neigh = static_cast<const int32_t*>(neigh);
  a.el_dst = static_cast<const float*>(el_dst);
  a.proj = static_cast<const float*>(proj);
  a.out_in = static_cast<const float*>(out);
  a.m = const_cast<float*>(static_cast<const float*>(m));
  a.s = const_cast<float*>(static_cast<const float*>(s));
  a.g_out = static_cast<const float*>(g_out);
  a.g_el = static_cast<float*>(g_el);
  a.partials = static_cast<float*>(partials);
  a.per_pick = static_cast<float*>(per_pick);
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
