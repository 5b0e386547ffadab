// K4: fanout gather-reduce, forward and backward.
//
// Forward:  sum[i, :] = sum_k m[i,k] * h_src[neigh[i,k], :]
//           denom[i]  = sum_k m[i,k]
// where m[i,k] = valid(neigh[i,k]) (times weights[i,k] when given) and a
// pick is valid when it lies in [0, num_rows): EMPTY (int32 max) is not.
// Backward, for every src row r < num_rows:
//   grad_h[r, :] = sum over the valid picks (i,k) with neigh[i,k] = r of
//                  m[i,k] * grad_sum[i, :]   (+ grad_dst[r, :] if r < D)
// summed from 0 in ascending k, then ascending i, with grad_dst added last.
// grad_dst is the gradient of a local-id block's dst rows, which are the
// prefix h_src[:D] (D = num_dst); it may be absent.  A row that no pick
// lands on gets zeros (or grad_dst[r]).  denom carries no gradient.
//
// Replaces: xgnn_tpu/models/gnn.py, fanout_reduce (the "loop" contract,
// K unrolled gather + FMA passes that XLA fuses) and its autodiff
// scatter-add, together with the gradient of _take_dst's prefix slice.  On
// the TPU it was XLA ops, not a Pallas kernel; the port writes it by hand
// because it is the heaviest traffic of the step.
//
// What bounds it on an H100: bytes.  The forward reads every valid pick's
// row once (layer 0 of the main path: about 5M rows of 512 B from the
// 2.45M-row feature table) and writes each sum row once; one FMA per element
// read is far below the card's arithmetic rate.  The backward reads
// grad_sum, grad_dst and neigh once and writes every grad_h row once (layer
// 1 of the main path: 137 + 137 + 5 MB in, 1,031 MB out, about 0.39 ms at
// 3.35 TB/s); one add per pick element.  The design adds a counting sort of
// a few MB of int32 and reads the grad_sum rows of a src row's second and
// later picks out of order.
//
// Design, forward: one warp per dst row.  Lanes hold a 16-byte column slice
// (float4) when F % 4 == 0 and the tables are aligned, else one float; the
// K picks are summed in registers in pick order and the row is written
// once, so the (dst, F) accumulator never round-trips device memory as it
// did in the K-pass XLA loop.  All lanes read the same pick id (a broadcast
// load).  An invalid pick reads nothing.  Sums run in the order k = 0..K-1
// with the product rounded before the add, as the plain PyTorch version
// does, so the two agree bit for bit.
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
//      picks of one dst row i.  A pick whose key is its row's smallest owns
//      the row, and the warp sums each row it owns: lane j loads the row's
//      key j, and since the keys are distinct a key's rank among them
//      (shuffles) is its place in ascending (k, i) order.  Lanes hold float4
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
// Weighted products are __fmul_rn, never fused into the add, and each sum
// starts from 0, so a row of at most kShort picks equals the plain
// version's index_add_ passes on the CPU bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kShort = 32;     // picks one warp sorts and sums alone
constexpr int kPicksPerWarp = 4;  // picks of one dst row per warp
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

template <bool kVec>
__global__ void fanout_fwd_kernel(const float* __restrict__ h,
                                  const int32_t* __restrict__ neigh,
                                  const float* __restrict__ w,
                                  float* __restrict__ sum,
                                  float* __restrict__ denom,
                                  int64_t num_rows, int64_t num_dst, int fanout,
                                  int64_t width) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_dst) return;
  const int32_t* nrow = neigh + row * fanout;
  const float* wrow = w ? w + row * fanout : nullptr;
  const bool weighted = w != nullptr;

  if (lane == 0) {
    float d = 0.f;
    for (int k = 0; k < fanout; ++k) {
      if (pick_valid(__ldg(nrow + k), num_rows)) d += weighted ? __ldg(wrow + k) : 1.f;
    }
    denom[row] = d;
  }

  if (kVec) {
    const int64_t w4 = width >> 2;
    float4* out = reinterpret_cast<float4*>(sum + row * width);
    for (int64_t c = lane; c < w4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < fanout; ++k) {
        const int32_t id = __ldg(nrow + k);
        if (!pick_valid(id, num_rows)) continue;
        const float m = weighted ? __ldg(wrow + k) : 1.f;
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(h + (int64_t)id * width) + c);
        acc = axpy4(acc, m, v, weighted);
      }
      out[c] = acc;
    }
  } else {
    float* out = sum + row * width;
    for (int64_t c = lane; c < width; c += 32) {
      float acc = 0.f;
      for (int k = 0; k < fanout; ++k) {
        const int32_t id = __ldg(nrow + k);
        if (!pick_valid(id, num_rows)) continue;
        const float v = __ldg(h + (int64_t)id * width + c);
        acc += weighted ? __fmul_rn(__ldg(wrow + k), v) : v;
      }
      out[c] = acc;
    }
  }
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
// k0 + kPicksPerWarp - 1): lane l takes pick (i, k0 + l) and its src row r.
// The pick whose key is the smallest of r's segment owns r; the warp sums
// and writes each row it owns, one after the other.  Warps run roughly in
// dst-row order and most src rows have one pick, so grad_sum is read about
// in order and about once: a row whose only pick is (i, k) is
// m * grad_sum[i] plus grad_dst, and needs no key read.
template <typename V>
__global__ void bwd_rows_kernel(const int32_t* __restrict__ neigh,
                                const int32_t* __restrict__ off,
                                const int32_t* __restrict__ keys,
                                const V* __restrict__ grad_sum,
                                const V* __restrict__ grad_dst,
                                const float* __restrict__ w,
                                V* __restrict__ grad_h, int64_t num_rows,
                                int32_t num_dst, int fanout, int64_t wv) {
  __shared__ int32_t sorted[kWarpsPerBlock][kShort];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (fanout + kPicksPerWarp - 1) / kPicksPerWarp;
  const int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (task >= (int64_t)num_dst * chunks) return;
  const int32_t i = (int32_t)(task / chunks);
  const int k = (int)(task - (int64_t)i * chunks) * kPicksPerWarp + lane;
  const bool weighted = w != nullptr;

  int32_t r = 0, start = 0;
  int n = 0;
  float m = 1.f;
  bool own = false;
  if (lane < kPicksPerWarp && k < fanout) {
    r = __ldg(neigh + (int64_t)i * fanout + k);
    if (pick_valid(r, num_rows)) {
      start = __ldg(off + r);
      n = __ldg(off + r + 1) - start;
      if (weighted) m = __ldg(w + (int64_t)i * fanout + k);
      const int32_t q = k * num_dst + i;
      own = n <= kShort;
      for (int t = 0; own && n > 1 && t < n; ++t)
        own = __ldg(keys + start + t) >= q;
    }
  }
  for (unsigned todo = __ballot_sync(kFull, own); todo; todo &= todo - 1) {
    const int l = __ffs(todo) - 1;
    const int64_t row = __shfl_sync(kFull, r, l);
    const int nn = __shfl_sync(kFull, n, l);
    // lane j < nn: the row's j-th pick in ascending (k, i) order; the keys
    // are distinct, so a key's rank among them is its place
    int32_t src = i;
    float mj = __shfl_sync(kFull, m, l);
    if (nn > 1) {
      const int32_t s = __shfl_sync(kFull, start, l);
      const int32_t key = lane < nn ? __ldg(keys + s + lane) : 0;
      int rank = 0;
      for (int t = 0; t < nn; ++t) rank += __shfl_sync(kFull, key, t) < key;
      __syncwarp();  // the previous row's reads of sorted[] are done
      if (lane < nn) sorted[warp][rank] = key;
      __syncwarp();
      if (lane < nn) {
        const int32_t qj = sorted[warp][lane];
        const int32_t kj = qj / num_dst;
        src = qj - kj * num_dst;
        if (weighted) mj = __ldg(w + (int64_t)src * fanout + kj);
      }
    }
    const bool has_dst = grad_dst != nullptr && row < num_dst;
    for (int64_t c0 = 0; c0 < wv; c0 += 32) {
      const int64_t c = c0 + lane;
      const bool live = c < wv;
      V acc = zero_value<V>();
#pragma unroll 4
      for (int j = 0; j < nn; ++j) {
        const int32_t ij = __shfl_sync(kFull, src, j);
        const float m_j = __shfl_sync(kFull, mj, j);
        if (live)
          acc = axpy4(acc, m_j, __ldg(grad_sum + (int64_t)ij * wv + c),
                      weighted);
      }
      if (!live) continue;
      if (has_dst) acc = axpy4(acc, 1.f, __ldg(grad_dst + row * wv + c), false);
      grad_h[row * wv + c] = acc;
    }
  }
}

// rows no pick lands on: zeros, plus grad_dst in the prefix; a warp per 32
// consecutive rows
template <typename V>
__global__ void bwd_empty_kernel(const int32_t* __restrict__ off,
                                 const V* __restrict__ grad_dst,
                                 V* __restrict__ grad_h, int64_t num_rows,
                                 int32_t num_dst, int64_t wv) {
  const int lane = threadIdx.x & 31;
  const int64_t r0 =
      ((int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * 32;
  if (r0 >= num_rows) return;
  const int64_t mine = r0 + lane;
  const bool empty =
      mine < num_rows && __ldg(off + mine + 1) == __ldg(off + mine);
  for (unsigned todo = __ballot_sync(kFull, empty); todo; todo &= todo - 1) {
    const int64_t r = r0 + __ffs(todo) - 1;
    const bool has_dst = grad_dst != nullptr && r < num_dst;
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

// rows with more than kShort picks, from the list; a block per row
template <typename V>
__global__ void __launch_bounds__(kLongThreads)
bwd_long_kernel(const int32_t* __restrict__ off, int32_t* keys,
                const int32_t* __restrict__ long_rows,
                const int32_t* __restrict__ num_long,
                const V* __restrict__ grad_sum, const V* __restrict__ grad_dst,
                const float* __restrict__ w, V* __restrict__ grad_h,
                int32_t num_dst, int fanout, int64_t wv) {
  __shared__ int32_t skeys[kSortCap];
  __shared__ V part[kLongWarps][32];
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
          acc = axpy4(acc, m, __ldg(grad_sum + (int64_t)i * wv + c),
                      weighted);
        }
      }
      part[warp][lane] = acc;
      __syncthreads();
      if (warp == 0 && c < wv) {
        V tot = zero_value<V>();
        for (int p = 0; p < kLongWarps; ++p)
          tot = axpy4(tot, 1.f, part[p][lane], false);
        if (grad_dst != nullptr && r < num_dst)
          tot = axpy4(tot, 1.f, __ldg(grad_dst + r * wv + c), false);
        grad_h[r * wv + c] = tot;
      }
      __syncthreads();
    }
  }
}

template <typename V>
void launch_reduce(const int32_t* neigh, const int32_t* off, int32_t* keys,
                   const int32_t* long_rows, const int32_t* num_long,
                   const void* grad_sum, const void* grad_dst, const float* w,
                   void* grad_h, long long num_rows, int32_t num_dst,
                   int fanout, long long wv, cudaStream_t s) {
  const V* g = static_cast<const V*>(grad_sum);
  const V* gd = static_cast<const V*>(grad_dst);
  V* gh = static_cast<V*>(grad_h);
  const long long tasks =
      (long long)num_dst * ((fanout + kPicksPerWarp - 1) / kPicksPerWarp);
  if (tasks > 0)
    bwd_rows_kernel<V><<<(unsigned)((tasks + kWarpsPerBlock - 1) /
                                    kWarpsPerBlock),
                         kThreads, 0, s>>>(neigh, off, keys, g, gd, w, gh,
                                           num_rows, num_dst, fanout, wv);
  const long long row_warps = (num_rows + 31) / 32;
  bwd_empty_kernel<V><<<(unsigned)((row_warps + kWarpsPerBlock - 1) /
                                   kWarpsPerBlock),
                        kThreads, 0, s>>>(off, gd, gh, num_rows, num_dst, wv);
  bwd_long_kernel<V><<<kLongBlocks, kLongThreads, 0, s>>>(
      off, keys, long_rows, num_long, g, gd, w, gh, num_dst, fanout, wv);
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

// h: (num_rows, width) f32; neigh: (num_dst, fanout) int32; w: null or
// (num_dst, fanout) f32; sum: (num_dst, width) f32; denom: (num_dst,) f32.
extern "C" int xg_fanout_fwd(const void* h, const void* neigh, const void* w,
                             void* sum, void* denom, long long num_rows,
                             long long num_dst, int fanout, long long width,
                             void* stream) {
  if (num_dst <= 0) return (int)cudaGetLastError();
  const long long blocks = (num_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = width % 4 == 0 && aligned16(h) && aligned16(sum);
  const float* hf = static_cast<const float*>(h);
  const int32_t* n = static_cast<const int32_t*>(neigh);
  const float* wf = static_cast<const float*>(w);
  float* sf = static_cast<float*>(sum);
  float* df = static_cast<float*>(denom);
  if (vec) {
    fanout_fwd_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        hf, n, wf, sf, df, num_rows, num_dst, fanout, width);
  } else {
    fanout_fwd_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        hf, n, wf, sf, df, num_rows, num_dst, fanout, width);
  }
  return (int)cudaGetLastError();
}

// grad_sum: (num_dst, width) f32; grad_dst: null or (num_dst, width) f32
// with num_dst <= num_rows; grad_h: (num_rows, width) f32, every row written;
// neigh and w as in the forward.  scratch: int32, at least
// 2 * num_rows + 2 + ceil(num_rows / 1024) + P + P / 33 + 1 entries, where
// P = num_dst * fanout < 2^31.  Returns cudaGetLastError() after the last
// launch (cudaErrorInvalidValue, launching nothing, for a scratch too small
// or sizes past int32).
extern "C" int xg_fanout_bwd(const void* grad_sum, const void* neigh,
                             const void* w, const void* grad_dst, void* grad_h,
                             void* scratch, long long scratch_len,
                             long long num_rows, long long num_dst, int fanout,
                             long long width, void* stream) {
  const long long num_picks = num_dst * fanout;
  const long long num_seg = (num_rows + kSeg - 1) / kSeg;
  if (num_rows >= INT32_MAX || num_picks >= INT32_MAX ||
      (grad_dst && num_dst > num_rows) ||
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
  const bool vec = width % 4 == 0 && aligned16(grad_sum) &&
                   aligned16(grad_h) && (!grad_dst || aligned16(grad_dst));
  if (vec) {
    launch_reduce<float4>(n, off, keys, long_rows, num_long, grad_sum,
                          grad_dst, wf, grad_h, num_rows, (int32_t)num_dst,
                          fanout, width >> 2, s);
  } else {
    launch_reduce<float>(n, off, keys, long_rows, num_long, grad_sum,
                         grad_dst, wf, grad_h, num_rows, (int32_t)num_dst,
                         fanout, width, s);
  }
  return (int)cudaGetLastError();
}
