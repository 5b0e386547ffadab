// K4: fanout gather-reduce, forward (a sum or a masked mean) and backward.
//
// Forward:  sum[i, :] = sum_k m[i,k] * h_src[neigh[i,k], :]
//           denom[i]  = sum_k m[i,k]
//           mean[i, :] = sum[i, :] / max(denom[i], 1e-9)   (the mean form)
// where m[i,k] = valid(neigh[i,k]) (times weights[i,k] when given) and a
// pick is valid when it lies in [0, num_rows): EMPTY (int32 max) is not.
// The sum form serves GCN; the mean form is the JAX package's
// masked_mean_stream (SAGE and PinSAGE), its division in the epilogue, so
// the (D, F) sum never reaches device memory.
// Backward, for every src row r < num_rows:
//   grad_h[r, :] = sum over the valid picks (i,k) with neigh[i,k] = r of
//                  m[i,k] * g[i, :]
//                  (+ (sum over the same picks of c[i,k]) * u[:])
//                  (+ grad_dst[r, :] if r < P)
// where g = grad_sum, or grad_sum[i, :] / max(denom[i], 1e-9) when denom is
// given (the gradient of the mean form), summed from 0 in ascending k, then
// ascending i; then the rank-1 term, its scalar summed from 0 in the same
// order; grad_dst last.  grad_dst is the gradient of a prefix h_src[:P]:
// a local-id block's dst rows (P = num_dst, or K5's dst rows when its
// picks come as num_dst = D * K rows of one pick); it may be absent.  The
// rank-1 term (c (D, K) per pick, u one row) may be absent: K5 at one head
// sums its table's gradient with it, w = a and c = g_pre (csrc/attend.cu).
// A row that no pick lands on gets zeros (or grad_dst[r]).  denom carries
// no gradient.
//
// Replaces: xgnn_tpu/models/gnn.py, fanout_reduce (the "loop" contract,
// K unrolled gather + FMA passes that XLA fuses) and masked_mean_stream's
// division, and their autodiff scatter-add, together with the gradient of
// _take_dst's prefix slice.  On the TPU it was XLA ops, not a Pallas
// kernel; the port writes it by hand because it is the heaviest traffic of
// the step.
//
// The table may be bfloat16 (feat_dtype or compute_dtype "bfloat16": layer
// 0 reads the bfloat16 feature table or extracted rows) or float16 (an F16
// feature file under compute_dtype "float32", whose table stays float16 as
// JAX keeps it).  The forward then loads the 2-byte elements and widens
// each to float32 in registers, exactly, and sums as above: the
// accumulator, the output and denom stay float32, and the result equals
// the plain version's (which upcasts the rows and sums in the same order)
// bit for bit.  Such a table never needs a gradient here (it is layer 0's
// input), so there is no 2-byte backward.
//
// What bounds it on an H100: bytes.  The forward reads every valid pick's
// row once (layer 0 of the main path: about 5M rows of 512 B from the
// 2.45M-row feature table) and writes each output row once; one FMA per
// element read (and one division per element written) is far below the
// card's arithmetic rate.  The backward reads grad_sum, grad_dst and neigh
// once and writes every grad_h row once (layer 1 of the main path: 137 +
// 137 + 5 MB in, 1,031 MB out, about 0.39 ms at 3.35 TB/s); one add per pick
// element.  The design adds a counting sort of a few MB of int32 and reads
// the grad_sum rows of a src row's second and later picks out of order.
//
// Design, forward: one warp per dst row, templated on the fanout (5, 10
// and 15, the main path's; any other K in chunks of 32 picks).  Lanes
// j < K load the row's ids (and weights) once, in one coalesced read, and
// hand them round by shuffles.  Lanes hold a 16-byte column slice (float4)
// when F % 4 == 0 and the tables are aligned, else one float (from a
// 2-byte table: 8 bytes of 4 elements, or one element), and two
// slices past 128 floats (a 1 KB row at width 256 is one warp-wide pair of
// loads; the 47-wide table one pass over the picks).  The row loads of
// kGroup picks are issued before the adds consume them, so each warp keeps
// several rows in flight.  The K picks
// are summed in registers in pick order, the mean form divides in
// registers, and the row is written once with an evict-first store, so the
// output does not push table rows out of L2.  An invalid pick reads
// nothing and adds +0.  Sums run in the order k = 0..K-1 from 0 with the
// product rounded before the add (__fmul_rn) and the division is IEEE
// (__fdiv_rn), as the plain PyTorch version computes them, so the two agree
// bit for bit.
//
// Design, backward: the picks are grouped by src row with a counting sort,
// then each src row is summed by one warp (or, for a long row, one block)
// and written once.  No float atomics, no zero fill of grad_h, and the order
// of every sum is fixed, so the result is the same from run to run.  Eight
// launches and one memset on the caller's stream, no host sync:
//   1. count: cnt[r] += 1 for every valid pick (integer atomics).
//   2. segment sums: a warp sums cnt over each kSeg consecutive rows.
//   3. scan: one block turns the segment sums into exclusive offsets (the
//      pattern of unique.cu).
//   4. offsets: a warp per segment writes off[r], the exclusive prefix of
//      cnt; a row with more than kShort picks goes on the long list.
//   5. fill: each valid pick stores its key q = k * D + i at
//      off[r] + atomicSub(&cnt[r], 1) - 1.  Each segment then holds its
//      row's keys in an order that varies from run to run.
//   6. rows of 1..kShort picks (nearly all): a warp takes kPicksPerWarp
//      (kPicksPerWarpLarge from kLargeDst dst rows on) picks of one dst
//      row i.  A row whose only pick is one of them is m * grad_sum[i]:
//      the warp reads grad_sum[i] once for all such rows.  Else a pick
//      whose key is its row's smallest owns the row, and the warp sums
//      each row it owns: lane j loads the row's key j, and since the keys
//      are distinct a key's rank among them (shuffles) is its place in
//      ascending (k, i) order.  Lanes hold float4
//      column slices (float when F % 4 != 0 or a table is unaligned) and
//      add the picks' grad_sum rows in that order in registers, grad_dst
//      last.  The warps run roughly in dst-row order, and most src rows have
//      one pick, so grad_sum is read nearly in order and nearly once.  A
//      warp per src row, in src-row order, reads a grad_sum row per pick out
//      of order, mostly from DRAM, and was slower at layer 1.
//   7. rows no pick lands on: a warp per 32 rows writes zeros (grad_dst in
//      the prefix).
//   8. rows of more than kShort picks (the main path's hubs, at most a few
//      hundred picks): one block of kLongThreads per listed row.  It sorts
//      the keys with a bitonic network in shared memory (in place in device
//      memory past kSortCap keys), gives each warp one contiguous part of
//      the sorted segment to sum in order, and adds the parts in warp
//      order, then grad_dst.  The partition depends only on the row's
//      length, so the result is deterministic, though its rounding is not
//      the single chain of a short row.
// With denom, each grad_sum element is divided (__fdiv_rn) as it is
// loaded, before the weight's product: once a task for the rows of one
// pick, and once a pick, with the divisor read once a row, for the rest.
// A zero element keeps its value without the division's slow path, and
// from kLargeDst dst rows on the rows kernel is held to 32 registers (8
// blocks an SM).  On an H100 the division then adds 3-4% to the sum
// form's time at layer 1 and 2-3% at layer 2 (tools/time_fanout.py).
// Weighted products
// are __fmul_rn, never fused into the add, and each sum starts from 0, so
// a row of at most kShort picks equals the plain version's index_add_
// passes on the CPU bit for bit.
//

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kShort = 32;     // picks one warp sorts and sums alone
// The rows kernel's tasks: kPicksPerWarp picks of one dst row a warp, and
// from kLargeDst dst rows on kPicksPerWarpLarge, with kRowsBlocks blocks an
// SM (at most 32 registers a thread, no spill).  With many dst rows the
// card is full either way, and longer tasks divide g[i] once for more
// rows; with few (layer 2 of the main path) the warps are latency-bound
// and more tasks and registers a warp win (tools/time_fanout.py).
constexpr int kPicksPerWarp = 4;
constexpr int kPicksPerWarpLarge = 5;
constexpr long long kLargeDst = 32768;
constexpr int kRowsBlocks = 8;
constexpr int kSeg = 1024;     // rows per warp in the scan
constexpr int kScanThreads = 1024;
constexpr int kLongThreads = 512;
constexpr int kLongWarps = kLongThreads / 32;
constexpr int kSortCap = 8192;  // keys a long row sorts in shared memory
constexpr int kLongBlocks = 132;

__device__ __forceinline__ bool pick_valid(int32_t id, int64_t num_rows) {
  return id >= 0 && (int64_t)id < num_rows;
}

__device__ __forceinline__ float4 axpy4(float4 acc, float m, float4 v,
                                        bool weighted) {
  if (weighted) {
    acc.x += __fmul_rn(m, v.x);
    acc.y += __fmul_rn(m, v.y);
    acc.z += __fmul_rn(m, v.z);
    acc.w += __fmul_rn(m, v.w);
  } else {
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  return acc;
}

__device__ __forceinline__ float axpy4(float acc, float m, float v,
                                       bool weighted) {
  return acc + (weighted ? __fmul_rn(m, v) : v);
}

template <typename V>
__device__ __forceinline__ V zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.f; }
template <>
__device__ __forceinline__ float4 zero_value<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// x / q for a divisor q > 0 (or NaN), as __fdiv_rn gives it: a zero x
// returns itself without the division, whose slow path it would take (half
// a step's gradient entries can be zeros)
__device__ __forceinline__ float div_rn(float x, float q) {
  return x == 0.f && q > 0.f ? x : __fdiv_rn(x, q);
}

__device__ __forceinline__ float4 div_rn(float4 a, float q) {
  return make_float4(div_rn(a.x, q), div_rn(a.y, q), div_rn(a.z, q),
                     div_rn(a.w, q));
}

// max(d, 1e-9) as torch.clamp(d, min=1e-9) computes it (a NaN stays NaN)
__device__ __forceinline__ float mean_divisor(float d) {
  return d < 1e-9f ? 1e-9f : d;
}

// ---- forward ------------------------------------------------------------

// the table's element: float32, bfloat16 or float16
enum Elem { kF32 = 0, kBf16 = 1, kF16 = 2 };

// 4 and 1 float16 of a table row (bfloat16 takes uint2 and uint16_t)
struct Half4 {
  uint2 bits;
};
struct Half1 {
  uint16_t bits;
};

// A slice V (float4 or float) of a table row: S is the table's storage of
// one slice (float4 or float, 4 or 1 bfloat16: uint2 or uint16_t, 4 or 1
// float16: Half4 or Half1)
template <typename V, int kE>
struct Slice;
template <>
struct Slice<float4, kF32> {
  using S = float4;
};
template <>
struct Slice<float, kF32> {
  using S = float;
};
template <>
struct Slice<float4, kBf16> {
  using S = uint2;
};
template <>
struct Slice<float, kBf16> {
  using S = uint16_t;
};
template <>
struct Slice<float4, kF16> {
  using S = Half4;
};
template <>
struct Slice<float, kF16> {
  using S = Half1;
};

// a bfloat16's bits widened to the float32 of the same value (exact)
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// a table row's slice, through the read-only data path, as float32.  Reads
// with an L2 evict-last policy, or without allocating in L1, were no faster
// at layers 0 and 1, where the bytes are (tools/time_fanout.py builds both).
__device__ __forceinline__ float4 ld_table(const float4* p) { return __ldg(p); }

__device__ __forceinline__ float ld_table(const float* p) { return __ldg(p); }

__device__ __forceinline__ float4 ld_table(const uint2* p) {
  const uint2 v = __ldg(p);  // 4 bfloat16, low half first
  return make_float4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y));
}

__device__ __forceinline__ float ld_table(const uint16_t* p) {
  return bf16_lo(__ldg(p));
}

// a float16's bits widened to the float32 of the same value (exact)
__device__ __forceinline__ float f16_bits(uint32_t b) {
  return __half2float(__ushort_as_half((unsigned short)(b & 0xffffu)));
}

__device__ __forceinline__ float4 ld_table(const Half4* p) {
  const uint2 v = __ldg(&p->bits);  // 4 float16, low half first
  return make_float4(f16_bits(v.x), f16_bits(v.x >> 16), f16_bits(v.y),
                     f16_bits(v.y >> 16));
}

__device__ __forceinline__ float ld_table(const Half1* p) {
  return f16_bits(__ldg(&p->bits));
}

// One warp per dst row.  V is float4 or float, kV the slices a lane holds
// per pass over the picks (columns c0 + lane + 32 u), K the fanout (0: any,
// read in chunks of 32 picks), kE the table's element.  wv is the row
// width in V units.
template <typename V, int kV, int K, bool kW, bool kMean, int kE>
__global__ void __launch_bounds__(kThreads)
fanout_fwd_kernel(const typename Slice<V, kE>::S* __restrict__ h,
                  const int32_t* __restrict__ neigh,
                  const float* __restrict__ w, V* __restrict__ out,
                  float* __restrict__ denom, int64_t num_rows,
                  int64_t num_dst, int fanout, int64_t wv) {
  constexpr int kGroup = K > 0 ? 5 : 4;  // picks whose loads fly together
  constexpr int kSpan = K > 0 ? K : 32;  // picks held by the warp at once
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_dst) return;
  const int kn = K > 0 ? K : fanout;
  const int32_t* nrow = neigh + row * kn;
  const float* wrow = kW ? w + row * kn : nullptr;
  V* orow = out + row * wv;
  float d = 0.f;
  int64_t c0 = 0;
  do {  // at least once: denom is written at width 0 too
    V acc[kV];
#pragma unroll
    for (int u = 0; u < kV; ++u) acc[u] = zero_value<V>();
    for (int k0 = 0; k0 < kn; k0 += 32) {
      // lane j holds pick k0 + j: its row id (-1 if invalid) and m
      int32_t id = -1;
      float m = 0.f;
      if (k0 + lane < kn) {
        const int32_t r = __ldg(nrow + k0 + lane);
        if (pick_valid(r, num_rows)) {
          id = r;
          m = kW ? __ldg(wrow + k0 + lane) : 1.f;
        }
      }
      const int nk = K > 0 ? K : min(32, kn - k0);
#pragma unroll
      for (int g0 = 0; g0 < kSpan; g0 += kGroup) {
        if (K == 0 && g0 >= nk) break;
        V v[kGroup][kV];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const int32_t r = __shfl_sync(kFull, id, (g0 + j) & 31);
          const bool live = r >= 0 && g0 + j < nk;
#pragma unroll
          for (int u = 0; u < kV; ++u) {
            const int64_t c = c0 + lane + 32 * u;
            v[j][u] = zero_value<V>();
            if (live && c < wv) v[j][u] = ld_table(h + (int64_t)r * wv + c);
          }
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float mj = __shfl_sync(kFull, m, (g0 + j) & 31);
          if (g0 + j < nk) {
#pragma unroll
            for (int u = 0; u < kV; ++u)
              acc[u] = axpy4(acc[u], mj, v[j][u], kW);
            if (c0 == 0) d += mj;
          }
        }
      }
    }
    const float q = mean_divisor(d);
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int64_t c = c0 + lane + 32 * u;
      if (c < wv) __stcs(orow + c, kMean ? div_rn(acc[u], q) : acc[u]);
    }
    c0 += 32 * kV;
  } while (c0 < wv);
  if (lane == 0) denom[row] = d;
}

template <typename V, int kV, int K, int kE>
void launch_fwd(const void* h, const int32_t* neigh, const float* w,
                float* out, float* denom, long long num_rows,
                long long num_dst, int fanout, long long wv, bool mean,
                cudaStream_t s) {
  const unsigned blocks =
      (unsigned)((num_dst + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* hv = static_cast<const typename Slice<V, kE>::S*>(h);
  V* ov = reinterpret_cast<V*>(out);
#define XG_FWD(W, M)                                                   \
  fanout_fwd_kernel<V, kV, K, W, M, kE><<<blocks, kThreads, 0, s>>>(    \
      hv, neigh, w, ov, denom, num_rows, num_dst, fanout, wv)
  if (w) {
    if (mean) XG_FWD(true, true); else XG_FWD(true, false);
  } else {
    if (mean) XG_FWD(false, true); else XG_FWD(false, false);
  }
#undef XG_FWD
}

template <typename V, int kV, int kE>
void launch_fwd_fanout(const void* h, const int32_t* neigh, const float* w,
                       float* out, float* denom, long long num_rows,
                       long long num_dst, int fanout, long long wv, bool mean,
                       cudaStream_t s) {
  switch (fanout) {
    case 5:
      launch_fwd<V, kV, 5, kE>(h, neigh, w, out, denom, num_rows, num_dst,
                                  fanout, wv, mean, s);
      break;
    case 10:
      launch_fwd<V, kV, 10, kE>(h, neigh, w, out, denom, num_rows,
                                   num_dst, fanout, wv, mean, s);
      break;
    case 15:
      launch_fwd<V, kV, 15, kE>(h, neigh, w, out, denom, num_rows,
                                   num_dst, fanout, wv, mean, s);
      break;
    default:
      launch_fwd<V, kV, 0, kE>(h, neigh, w, out, denom, num_rows, num_dst,
                                  fanout, wv, mean, s);
  }
}

// the forward over a table of kE elements
template <int kE>
void launch_fwd_table(const void* h, const int32_t* neigh, const float* w,
                      float* out, float* denom, long long num_rows,
                      long long num_dst, int fanout, long long width,
                      bool mean, cudaStream_t s) {
  // a float4 slice is 16 bytes of a float32 table, 8 of a 2-byte one
  const uintptr_t slice_bytes = kE == kF32 ? 16 : 8;
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(h) % slice_bytes == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && width <= 128)
    launch_fwd_fanout<float4, 1, kE>(h, neigh, w, out, denom, num_rows,
                                        num_dst, fanout, width / 4, mean, s);
  else if (vec)
    launch_fwd_fanout<float4, 2, kE>(h, neigh, w, out, denom, num_rows,
                                        num_dst, fanout, width / 4, mean, s);
  else
    launch_fwd_fanout<float, 2, kE>(h, neigh, w, out, denom, num_rows,
                                       num_dst, fanout, width, mean, s);
}


// ---- backward: counting sort of the picks by src row --------------------

__device__ __forceinline__ int64_t global_thread() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_threads() {
  return (int64_t)gridDim.x * blockDim.x;
}

__global__ void bwd_count_kernel(const int32_t* __restrict__ neigh,
                                 int64_t num_picks, int64_t num_rows,
                                 int32_t* __restrict__ cnt) {
  for (int64_t p = global_thread(); p < num_picks; p += grid_threads()) {
    const int32_t r = __ldg(neigh + p);
    if (pick_valid(r, num_rows)) atomicAdd(cnt + r, 1);
  }
}

__global__ void bwd_seg_sum_kernel(const int32_t* __restrict__ cnt,
                                   int64_t num_rows, int64_t num_seg,
                                   int32_t* __restrict__ seg) {
  const int64_t s = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= num_seg) return;
  int total = 0;
  for (int c = lane; c < kSeg; c += 32) {
    const int64_t r = s * kSeg + c;
    if (r < num_rows) total += cnt[r];
  }
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(kFull, total, o);
  if (lane == 0) seg[s] = total;
}

// inclusive sum over the block; every thread gets the block's total
__device__ int block_inclusive_sum(int x, int* total) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  const int out = x + (warp ? warp_sum[warp - 1] : 0);
  *total = warp_sum[kScanThreads / 32 - 1];
  __syncthreads();  // warp_sum is reused by the next call
  return out;
}

// one block of kScanThreads: seg becomes the exclusive prefix of itself,
// and *total the sum of all picks
__global__ void bwd_scan_kernel(int32_t* __restrict__ seg, int64_t num_seg,
                                int32_t* __restrict__ total) {
  int run = 0;
  for (int64_t base = 0; base < num_seg; base += kScanThreads) {
    const int64_t s = base + threadIdx.x;
    const int x = s < num_seg ? seg[s] : 0;
    int tot;
    const int incl = block_inclusive_sum(x, &tot);
    if (s < num_seg) seg[s] = run + incl - x;
    run += tot;
  }
  if (threadIdx.x == 0) *total = run;
}

__global__ void bwd_offsets_kernel(const int32_t* __restrict__ cnt,
                                   int64_t num_rows, int64_t num_seg,
                                   const int32_t* __restrict__ seg,
                                   int32_t* __restrict__ off,
                                   int32_t* __restrict__ long_rows,
                                   int32_t* __restrict__ num_long) {
  const int64_t s = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= num_seg) return;
  int base = seg[s];
  for (int c = 0; c < kSeg; c += 32) {
    const int64_t r = s * kSeg + c + lane;
    const int x = r < num_rows ? cnt[r] : 0;
    int incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    if (r < num_rows) {
      off[r] = base + incl - x;
      if (x > kShort) long_rows[atomicAdd(num_long, 1)] = (int32_t)r;
    }
    base += __shfl_sync(kFull, incl, 31);
  }
}

__global__ void bwd_fill_kernel(const int32_t* __restrict__ neigh,
                                int32_t num_dst, int fanout, int64_t num_rows,
                                const int32_t* __restrict__ off,
                                int32_t* __restrict__ cnt,
                                int32_t* __restrict__ keys) {
  const int64_t num_picks = (int64_t)num_dst * fanout;
  for (int64_t p = global_thread(); p < num_picks; p += grid_threads()) {
    const int32_t r = __ldg(neigh + p);
    if (!pick_valid(r, num_rows)) continue;
    const int32_t i = (int32_t)p / fanout;
    const int32_t k = (int32_t)p - i * fanout;
    const int32_t slot = atomicSub(cnt + r, 1) - 1;
    keys[off[r] + slot] = k * num_dst + i;
  }
}

// ---- backward: the segmented reduce -------------------------------------

// rows of 1..kShort picks, a warp per task (dst row i, picks k0 ..
// k0 + ppw - 1, ppw <= 32 picks): lane l takes pick (i, k0 + l) and its
// src row r.
// The pick whose key is the smallest of r's segment owns r; the warp sums
// and writes each row it owns.  Warps run roughly in dst-row order and most
// src rows have one pick, so grad_sum is read about in order and about
// once.  A row whose only pick is (i, k) is m * g[i] plus the rank-1 term
// and grad_dst and needs no key read: the warp reads (and with kDiv
// divides) g[i] once for all such rows of its task.  kDiv: grad_sum[i] is
// divided by max(denom[i], 1e-9) as it is loaded.  kRank1: the rank-1
// term, c summed over the row's picks in the sum's order, times u.
template <typename V, bool kDiv, int kMinBlocks, bool kRank1>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bwd_rows_kernel(const int32_t* __restrict__ neigh,
                const int32_t* __restrict__ off,
                const int32_t* __restrict__ keys,
                const V* __restrict__ grad_sum,
                const V* __restrict__ grad_dst,
                const float* __restrict__ w,
                const float* __restrict__ denom,
                const float* __restrict__ cw, const V* __restrict__ u,
                V* __restrict__ grad_h, int64_t num_rows,
                int32_t num_dst, int64_t num_prefix, int fanout, int ppw,
                int64_t wv) {
  __shared__ int32_t sorted[kWarpsPerBlock][kShort];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (fanout + ppw - 1) / ppw;
  const int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (task >= (int64_t)num_dst * chunks) return;
  const int32_t i = (int32_t)(task / chunks);
  const int k = (int)(task - (int64_t)i * chunks) * ppw + lane;
  const bool weighted = w != nullptr;

  int32_t r = 0, start = 0;
  int n = 0;
  float m = 1.f, cp = 0.f;
  bool own = false;
  if (lane < ppw && k < fanout) {
    r = __ldg(neigh + (int64_t)i * fanout + k);
    if (pick_valid(r, num_rows)) {
      start = __ldg(off + r);
      n = __ldg(off + r + 1) - start;
      if (weighted) m = __ldg(w + (int64_t)i * fanout + k);
      if (kRank1) cp = __ldg(cw + (int64_t)i * fanout + k);
      const int32_t q = k * num_dst + i;
      own = n <= kShort;
      for (int t = 0; own && n > 1 && t < n; ++t)
        own = __ldg(keys + start + t) >= q;
    }
  }
  // the rows of one pick, all m * g[i]: g[i] read and divided once a slice
  const unsigned single = __ballot_sync(kFull, own && n == 1);
  if (single) {
    const float q = kDiv ? mean_divisor(__ldg(denom + i)) : 1.f;
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      const bool live = c < wv;
      V g = zero_value<V>(), uc = zero_value<V>();
      if (live) {
        g = __ldg(grad_sum + (int64_t)i * wv + c);
        if (kDiv) g = div_rn(g, q);
        if (kRank1) uc = __ldg(u + c);
      }
      for (unsigned todo = single; todo; todo &= todo - 1) {
        const int l = __ffs(todo) - 1;
        const int64_t row = __shfl_sync(kFull, r, l);
        const float ml = __shfl_sync(kFull, m, l);
        const float cl = kRank1 ? 0.f + __shfl_sync(kFull, cp, l) : 0.f;
        if (!live) continue;
        V acc = axpy4(zero_value<V>(), ml, g, weighted);
        if (kRank1) acc = axpy4(acc, cl, uc, true);
        if (grad_dst != nullptr && row < num_prefix)
          acc = axpy4(acc, 1.f, __ldg(grad_dst + row * wv + c), false);
        grad_h[row * wv + c] = acc;
      }
    }
  }
  for (unsigned todo = __ballot_sync(kFull, own && n > 1); todo;
       todo &= todo - 1) {
    const int l = __ffs(todo) - 1;
    const int64_t row = __shfl_sync(kFull, r, l);
    const int nn = __shfl_sync(kFull, n, l);
    const int32_t s = __shfl_sync(kFull, start, l);
    // the row's keys in ascending (k, i) order: they are distinct, so a
    // key's rank among them is its place
    const int32_t key = lane < nn ? __ldg(keys + s + lane) : 0;
    int rank = 0;
    for (int t = 0; t < nn; ++t) rank += __shfl_sync(kFull, key, t) < key;
    __syncwarp();  // the previous row's reads of sorted[] are done
    if (lane < nn) sorted[warp][rank] = key;
    __syncwarp();
    // lane j < nn: pick j's dst row, weight and divisor
    int32_t src = 0;
    float mj = 1.f, qj = 1.f, cj = 0.f;
    if (lane < nn) {
      const int32_t qk = sorted[warp][lane];
      const int32_t kj = qk / num_dst;
      src = qk - kj * num_dst;
      if (weighted) mj = __ldg(w + (int64_t)src * fanout + kj);
      if (kDiv) qj = mean_divisor(__ldg(denom + src));
      if (kRank1) cj = __ldg(cw + (int64_t)src * fanout + kj);
    }
    // the rank-1 term's scalar, summed from 0 in the picks' order
    float cs = 0.f;
    if (kRank1)
      for (int j = 0; j < nn; ++j) cs += __shfl_sync(kFull, cj, j);
    const bool has_dst = grad_dst != nullptr && row < num_prefix;
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      const bool live = c < wv;
      V acc = zero_value<V>();
#pragma unroll 4
      for (int j = 0; j < nn; ++j) {
        const int32_t ij = __shfl_sync(kFull, src, j);
        const float m_j = __shfl_sync(kFull, mj, j);
        const float q_j = kDiv ? __shfl_sync(kFull, qj, j) : 1.f;
        if (live) {
          V g = __ldg(grad_sum + (int64_t)ij * wv + c);
          if (kDiv) g = div_rn(g, q_j);
          acc = axpy4(acc, m_j, g, weighted);
        }
      }
      if (!live) continue;
      if (kRank1) acc = axpy4(acc, cs, __ldg(u + c), true);
      if (has_dst) acc = axpy4(acc, 1.f, __ldg(grad_dst + row * wv + c), false);
      grad_h[row * wv + c] = acc;
    }
  }
}

// rows no pick lands on: zeros, plus grad_dst in the prefix (the rank-1
// term's scalar is a sum of no picks, 0); a warp per 32 consecutive rows
template <typename V>
__global__ void bwd_empty_kernel(const int32_t* __restrict__ off,
                                 const V* __restrict__ grad_dst,
                                 V* __restrict__ grad_h, int64_t num_rows,
                                 int64_t num_prefix, int64_t wv) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32;
  if (r0 >= num_rows) return;
  const int64_t mine = r0 + lane;
  const bool empty =
      mine < num_rows && __ldg(off + mine + 1) == __ldg(off + mine);
  for (unsigned todo = __ballot_sync(kFull, empty); todo; todo &= todo - 1) {
    const int64_t r = r0 + __ffs(todo) - 1;
    const bool has_dst = grad_dst != nullptr && r < num_prefix;
    for (int64_t c = lane; c < wv; c += 32) {
      V v = zero_value<V>();
      if (has_dst) v = axpy4(v, 1.f, __ldg(grad_dst + r * wv + c), false);
      grad_h[r * wv + c] = v;
    }
  }
}

// ascending sort of a[0..n) by the block: a bitonic network in which every
// comparator puts the smaller key first (the first merge step of each stage
// compares mirrored positions), over n rounded up to a power of two; the
// positions past n act as +inf, so a comparator that reaches them is a no-op
__device__ void block_sort(int32_t* a, int n) {
  int size = 1;
  while (size < n) size <<= 1;
  for (int k = 2; k <= size; k <<= 1) {
    for (int h = k >> 1; h > 0; h >>= 1) {
      for (int t = threadIdx.x; t < size / 2; t += blockDim.x) {
        const int pos = t & (h - 1);
        const int i = ((t - pos) << 1) + pos;
        const int j = h == (k >> 1) ? i - pos + k - 1 - pos : i + h;
        if (j < n) {
          const int32_t x = a[i], y = a[j];
          if (x > y) {
            a[i] = y;
            a[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
}

// rows with more than kShort picks, from the list; a block per row.  With
// kRank1 each warp also sums c over its part (lanes in stride, then a
// butterfly), and every thread adds the warps' sums in warp order.
template <typename V, bool kDiv, bool kRank1>
__global__ void __launch_bounds__(kLongThreads)
bwd_long_kernel(const int32_t* __restrict__ off, int32_t* keys,
                const int32_t* __restrict__ long_rows,
                const int32_t* __restrict__ num_long,
                const V* __restrict__ grad_sum, const V* __restrict__ grad_dst,
                const float* __restrict__ w, const float* __restrict__ denom,
                const float* __restrict__ cw, const V* __restrict__ u,
                V* __restrict__ grad_h, int32_t num_dst, int64_t num_prefix,
                int fanout, int64_t wv) {
  __shared__ int32_t skeys[kSortCap];
  __shared__ V part[kLongWarps][32];
  __shared__ float cpart[kLongWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool weighted = w != nullptr;
  const int count = *num_long;
  for (int idx = blockIdx.x; idx < count; idx += gridDim.x) {
    const int64_t r = long_rows[idx];
    const int32_t start = off[r];
    const int n = off[r + 1] - start;
    int32_t* a = n <= kSortCap ? skeys : keys + start;
    if (n <= kSortCap)
      for (int t = threadIdx.x; t < n; t += kLongThreads)
        skeys[t] = keys[start + t];
    __syncthreads();
    block_sort(a, n);
    const int per = (n + kLongWarps - 1) / kLongWarps;
    const int j0 = min(n, warp * per), j1 = min(n, j0 + per);
    float cs = 0.f;
    if (kRank1) {
      float t = 0.f;
      for (int j = j0 + lane; j < j1; j += 32) {
        const int32_t q = a[j];
        const int32_t k = q / num_dst;
        t += __ldg(cw + (int64_t)(q - k * num_dst) * fanout + k);
      }
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
      if (lane == 0) cpart[warp] = t;
      __syncthreads();
      for (int p = 0; p < kLongWarps; ++p) cs += cpart[p];
    }
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      V acc = zero_value<V>();
      if (c < wv) {
        for (int j = j0; j < j1; ++j) {
          const int32_t q = a[j];
          const int32_t k = q / num_dst;
          const int32_t i = q - k * num_dst;
          const float m =
              weighted ? __ldg(w + (int64_t)i * fanout + k) : 1.f;
          V g = __ldg(grad_sum + (int64_t)i * wv + c);
          if (kDiv) g = div_rn(g, mean_divisor(__ldg(denom + i)));
          acc = axpy4(acc, m, g, weighted);
        }
      }
      part[warp][lane] = acc;
      __syncthreads();
      if (warp == 0 && c < wv) {
        V tot = zero_value<V>();
        for (int p = 0; p < kLongWarps; ++p)
          tot = axpy4(tot, 1.f, part[p][lane], false);
        if (kRank1) tot = axpy4(tot, cs, __ldg(u + c), true);
        if (grad_dst != nullptr && r < num_prefix)
          tot = axpy4(tot, 1.f, __ldg(grad_dst + r * wv + c), false);
        grad_h[r * wv + c] = tot;
      }
      __syncthreads();
    }
  }
}

template <typename V, bool kDiv, bool kRank1>
void launch_reduce(const int32_t* neigh, const int32_t* off, int32_t* keys,
                   const int32_t* long_rows, const int32_t* num_long,
                   const void* grad_sum, const void* grad_dst, const float* w,
                   const float* denom, const float* cw, const void* u,
                   void* grad_h, long long num_rows, int32_t num_dst,
                   long long num_prefix, int fanout, long long wv,
                   cudaStream_t s) {
  const V* g = static_cast<const V*>(grad_sum);
  const V* gd = static_cast<const V*>(grad_dst);
  const V* uv = static_cast<const V*>(u);
  V* gh = static_cast<V*>(grad_h);
  const bool large = num_dst >= kLargeDst;
  const int ppw = large ? kPicksPerWarpLarge : kPicksPerWarp;
  const long long tasks = (long long)num_dst * ((fanout + ppw - 1) / ppw);
  const unsigned blocks =
      (unsigned)((tasks + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (tasks > 0 && large)
    bwd_rows_kernel<V, kDiv, kRowsBlocks, kRank1><<<blocks, kThreads, 0, s>>>(
        neigh, off, keys, g, gd, w, denom, cw, uv, gh, num_rows, num_dst,
        num_prefix, fanout, ppw, wv);
  else if (tasks > 0)
    bwd_rows_kernel<V, kDiv, 1, kRank1><<<blocks, kThreads, 0, s>>>(
        neigh, off, keys, g, gd, w, denom, cw, uv, gh, num_rows, num_dst,
        num_prefix, fanout, ppw, wv);
  const long long row_warps = (num_rows + 31) / 32;
  bwd_empty_kernel<V><<<(unsigned)((row_warps + kWarpsPerBlock - 1) /
                                   kWarpsPerBlock),
                        kThreads, 0, s>>>(off, gd, gh, num_rows, num_prefix,
                                          wv);
  bwd_long_kernel<V, kDiv, kRank1><<<kLongBlocks, kLongThreads, 0, s>>>(
      off, keys, long_rows, num_long, g, gd, w, denom, cw, uv, gh, num_dst,
      num_prefix, fanout, wv);
}

unsigned grid_for(long long work) {
  // grid-stride kernels: enough blocks to fill the card, no more
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// h: (num_rows, width) of elem (0: float32, 1: bfloat16, 2: float16);
// neigh: (num_dst, fanout) int32; w: null or (num_dst, fanout) f32; out:
// (num_dst, width) f32, the sum, or with mean the masked mean; denom:
// (num_dst,) f32.
extern "C" int xg_fanout_fwd(const void* h, const void* neigh, const void* w,
                             void* out, void* denom, long long num_rows,
                             long long num_dst, int fanout, long long width,
                             int mean, int elem, void* stream) {
  if (num_dst <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* n = static_cast<const int32_t*>(neigh);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  float* df = static_cast<float*>(denom);
  if (elem == kBf16)
    launch_fwd_table<kBf16>(h, n, wf, of, df, num_rows, num_dst, fanout,
                            width, mean != 0, s);
  else if (elem == kF16)
    launch_fwd_table<kF16>(h, n, wf, of, df, num_rows, num_dst, fanout,
                           width, mean != 0, s);
  else if (elem == kF32)
    launch_fwd_table<kF32>(h, n, wf, of, df, num_rows, num_dst, fanout,
                           width, mean != 0, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// grad_sum: (num_dst, width) f32; grad_dst: null or (num_prefix, width)
// f32 with num_prefix <= num_rows; denom: null (the gradient of the sum
// form) or (num_dst,) f32, the forward's (of the mean form); c: null or
// (num_dst, fanout) f32 with u (width,) f32, the rank-1 term (not with
// denom); grad_h: (num_rows, width) f32, every row written; neigh and w as
// in the forward.  scratch: int32, at least
// 2 * num_rows + 2 + ceil(num_rows / 1024) + P + P / 33 + 1 entries, where
// P = num_dst * fanout < 2^31.  Returns cudaGetLastError() after the last
// launch (cudaErrorInvalidValue, launching nothing, for a scratch too small,
// sizes past int32, or c without u or with denom).
extern "C" int xg_fanout_bwd(const void* grad_sum, const void* neigh,
                             const void* w, const void* grad_dst,
                             const void* denom, const void* c, const void* u,
                             void* grad_h, void* scratch,
                             long long scratch_len, long long num_rows,
                             long long num_dst, int fanout, long long width,
                             long long num_prefix, void* stream) {
  const long long num_picks = num_dst * fanout;
  const long long num_seg = (num_rows + kSeg - 1) / kSeg;
  if (num_rows >= INT32_MAX || num_picks >= INT32_MAX ||
      (grad_dst && (num_prefix < 0 || num_prefix > num_rows)) ||
      (c != nullptr) != (u != nullptr) || (c && denom) ||
      scratch_len < 2 * num_rows + 2 + num_seg + num_picks +
                        num_picks / (kShort + 1) + 1)
    return (int)cudaErrorInvalidValue;
  if (num_rows <= 0 || width <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int32_t* cnt = static_cast<int32_t*>(scratch);
  int32_t* num_long = cnt + num_rows;  // zeroed with cnt
  int32_t* off = num_long + 1;         // num_rows + 1 entries
  int32_t* seg = off + num_rows + 1;
  int32_t* keys = seg + num_seg;
  int32_t* long_rows = keys + num_picks;
  const int32_t* n = static_cast<const int32_t*>(neigh);

  cudaMemsetAsync(cnt, 0, (size_t)(num_rows + 1) * sizeof(int32_t), s);
  if (num_picks > 0)
    bwd_count_kernel<<<grid_for(num_picks), kThreads, 0, s>>>(n, num_picks,
                                                              num_rows, cnt);
  const unsigned seg_blocks = (unsigned)((num_seg + kWarpsPerBlock - 1) /
                                         kWarpsPerBlock);
  bwd_seg_sum_kernel<<<seg_blocks, kThreads, 0, s>>>(cnt, num_rows, num_seg,
                                                     seg);
  bwd_scan_kernel<<<1, kScanThreads, 0, s>>>(seg, num_seg, off + num_rows);
  bwd_offsets_kernel<<<seg_blocks, kThreads, 0, s>>>(
      cnt, num_rows, num_seg, seg, off, long_rows, num_long);
  if (num_picks > 0) {
    bwd_fill_kernel<<<grid_for(num_picks), kThreads, 0, s>>>(
        n, (int32_t)num_dst, fanout, num_rows, off, cnt, keys);
  }

  const float* wf = static_cast<const float*>(w);
  const float* df = static_cast<const float*>(denom);
  const float* cf = static_cast<const float*>(c);
  const long long np = grad_dst ? num_prefix : 0;
  const bool vec = width % 4 == 0 && aligned16(grad_sum) &&
                   aligned16(grad_h) && (!grad_dst || aligned16(grad_dst)) &&
                   (!u || aligned16(u));
#define XG_REDUCE(V, DIV, RANK1, WV)                                       \
  launch_reduce<V, DIV, RANK1>(n, off, keys, long_rows, num_long,          \
                               grad_sum, grad_dst, wf, df, cf, u, grad_h,  \
                               num_rows, (int32_t)num_dst, np, fanout, WV, s)
  if (vec) {
    if (df) XG_REDUCE(float4, true, false, width >> 2);
    else if (cf) XG_REDUCE(float4, false, true, width >> 2);
    else XG_REDUCE(float4, false, false, width >> 2);
  } else {
    if (df) XG_REDUCE(float, true, false, width);
    else if (cf) XG_REDUCE(float, false, true, width);
    else XG_REDUCE(float, false, false, width);
  }
#undef XG_REDUCE
  return (int)cudaGetLastError();
}
