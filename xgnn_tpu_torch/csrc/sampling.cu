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
// The tiered topology (K2 and K8a alike; tier.cuh): a cold row is read in
// place from the whole graph's CSR in mapped host memory, in the same
// launch.  Its draws are the hot rows' arithmetic on the same u, so a
// tiered call picks what the untiered call over the whole CSR picks.  A
// row's two host reads (indptr, then indices) depend on each other, each
// a PCIe round trip of about a microsecond: a thread with a cold row
// stalls its warp on them.  Each kernel is built twice, kTiered false (the
// untiered launch, no cold branch) and true.
//
// Replaces, for the cold rows: xgnn_tpu/parallel/ggms.py,
// HostColdSampler (lines 264-453) driven by cold_sample_callback
// (456-487) and xgnn_tpu/sampler.py:282-310: a host callback over the
// compacted cold ids of each layer, merged into the device's picks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tier.cuh"

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kMaxFanout = 64;

// A frontier row: its first edge, its degree (0 for EMPTY and any id
// outside the graph), and whether it lies in host memory
struct Row {
  int64_t start;
  int32_t deg;
  bool cold;
};

template <bool kTiered>
__device__ __forceinline__ Row row_meta(const int32_t* __restrict__ indptr,
                                        const int32_t* __restrict__ frontier,
                                        int64_t row, int64_t num_node,
                                        const Cold& cold) {
  const int32_t v = __ldg(frontier + row);
  Row r{0, 0, false};
  if (v >= 0 && (int64_t)v < num_node) {
    const int32_t start = __ldg(indptr + v);
    r.start = start;
    r.deg = __ldg(indptr + v + 1) - start;
  } else if (kTiered && v >= 0 && cold_id(cold, v, num_node)) {
    cold_row(cold, v, &r.start, &r.deg);
    r.cold = true;
  }
  return r;
}

// index off of a row, from the card's indices or the host's
template <bool kTiered>
__device__ __forceinline__ int32_t edge(const int32_t* __restrict__ indices,
                                        const Cold& cold, const Row& r,
                                        int32_t off) {
  return rd<kTiered>((kTiered && r.cold ? cold.indices : indices) +
                         (r.start + off),
                     r.cold);
}

// the draw of step j: t in [j, deg)
__device__ __forceinline__ int32_t draw(float u, int32_t deg, int j) {
  const int32_t span = deg - j;
  const float x = __fmul_rn(u, __int2float_rn(span));
  const int32_t d = __float2int_rz(floorf(x));
  return j + (d < span - 1 ? d : span - 1);
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
  Row r{0, 0, false};
  if (row < num_rows)
    r = row_meta<kTiered>(indptr, frontier, row, num_node, cold);
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
      pick[j] = j < live ? edge<kTiered>(indices, cold, r, pick[j]) : kEmpty;
#pragma unroll
    for (int j = 0; j < kK; ++j) trow[j] = (uint32_t)pick[j];
  }
  __syncthreads();
  copy_tile(reinterpret_cast<uint32_t*>(out) + row0 * kK, tile, words, vec);
}

// any fanout up to kMaxFanout: one thread per row, unstaged, records in
// local memory
template <bool kTiered>
__global__ void sample_khop_kernel(const int32_t* __restrict__ indptr,
                                   const int32_t* __restrict__ indices,
                                   const int32_t* __restrict__ frontier,
                                   const float* __restrict__ u,
                                   int32_t* __restrict__ out,
                                   int64_t num_node, int64_t num_rows,
                                   int fanout, Cold cold) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= num_rows) return;
  const Row r = row_meta<kTiered>(indptr, frontier, row, num_node, cold);
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
    orow[j] = edge<kTiered>(indices, cold, r, pick);
  }
  for (int j = live; j < fanout; ++j) orow[j] = kEmpty;
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
  Row r{0, 0, false};
  if (row < num_rows)
    r = row_meta<kTiered>(indptr, frontier, row, num_node, cold);
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
        pick[j] = edge<kTiered>(indices, cold, r, pick[j]);
      if (kDedup) sort_dedup<kK>(pick);
    } else {
#pragma unroll
      for (int j = 0; j < kK; ++j) pick[j] = kEmpty;
    }
#pragma unroll
    for (int j = 0; j < kK; ++j) trow[j] = (uint32_t)pick[j];
  }
  __syncthreads();
  copy_tile(reinterpret_cast<uint32_t*>(out) + row0 * kK, tile, words, vec);
}

// any fanout up to kMaxFanout: one thread per row, unstaged, the row in
// local memory
template <bool kTiered>
__global__ void sample_wr_kernel(const int32_t* __restrict__ indptr,
                                 const int32_t* __restrict__ indices,
                                 const int32_t* __restrict__ frontier,
                                 const float* __restrict__ u,
                                 int32_t* __restrict__ out, int64_t num_node,
                                 int64_t num_rows, int fanout, bool dedup,
                                 Cold cold) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= num_rows) return;
  const Row r = row_meta<kTiered>(indptr, frontier, row, num_node, cold);
  const int32_t deg = r.deg;
  const float* urow = u + row * fanout;
  int32_t* orow = out + row * fanout;
  if (deg <= 0) {
    for (int j = 0; j < fanout; ++j) orow[j] = kEmpty;
    return;
  }
  int32_t v[kMaxFanout];
  for (int j = 0; j < fanout; ++j)
    v[j] = edge<kTiered>(indices, cold, r, draw_wr(__ldg(urow + j), deg));
  if (dedup) {
    for (int i = 1; i < fanout; ++i) {  // insertion sort
      const int32_t x = v[i];
      int j = i - 1;
      for (; j >= 0 && v[j] > x; --j) v[j + 1] = v[j];
      v[j + 1] = x;
    }
    for (int j = fanout - 1; j > 0; --j)
      if (v[j] == v[j - 1]) orow[j] = kEmpty; else orow[j] = v[j];
    orow[0] = v[0];
  } else {
    for (int j = 0; j < fanout; ++j) orow[j] = v[j];
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
// num_node when the topology is not tiered.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a fanout or a tier it does
// not take).
extern "C" int xg_sample_khop(const void* indptr, const void* indices,
                              const void* frontier, const void* u, void* out,
                              long long num_node, long long num_rows,
                              int fanout, const void* cold_indptr,
                              const void* cold_indices, long long num_total,
                              void* stream) {
  Cold cold;
  if (fanout < 1 || fanout > kMaxFanout ||
      !make_cold(cold_indptr, cold_indices, nullptr, nullptr, nullptr,
                 num_node, num_total, kNoTables, &cold))
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

// K8a.  indptr, indices, frontier, u, out and the tier as for
// xg_sample_khop; dedup != 0 is khop1 (each row sorted, EMPTY over
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
                 num_node, num_total, kNoTables, &cold))
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
