// K2: uniform K-subset neighbour sampler (khop0 / khop2 / khop3).
//
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kMaxFanout = 64;

__device__ __forceinline__ void row_meta(const int32_t* __restrict__ indptr,
                                         const int32_t* __restrict__ frontier,
                                         int64_t row, int64_t num_node,
                                         int32_t* start, int32_t* deg) {
  const int32_t v = __ldg(frontier + row);
  *start = 0;
  *deg = 0;
  if (v >= 0 && (int64_t)v < num_node) {
    *start = __ldg(indptr + v);
    *deg = __ldg(indptr + v + 1) - *start;
  }
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

template <int kK>
__global__ void __launch_bounds__(kThreads)
sample_khop_staged_kernel(const int32_t* __restrict__ indptr,
                          const int32_t* __restrict__ indices,
                          const int32_t* __restrict__ frontier,
                          const float* __restrict__ u,
                          int32_t* __restrict__ out, int64_t num_node,
                          int64_t num_rows, bool vec) {
  __shared__ __align__(16) uint32_t tile[kThreads * kK];
  const int64_t row0 = (int64_t)blockIdx.x * kThreads;
  const int64_t row = row0 + threadIdx.x;
  const int64_t rows = num_rows - row0 < kThreads ? num_rows - row0 : kThreads;
  const int words = (int)rows * kK;
  int32_t start = 0, deg = 0;
  if (row < num_rows) row_meta(indptr, frontier, row, num_node, &start, &deg);
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
      pick[j] = j < live ? __ldg(indices + ((int64_t)start + pick[j])) : kEmpty;
#pragma unroll
    for (int j = 0; j < kK; ++j) trow[j] = (uint32_t)pick[j];
  }
  __syncthreads();
  copy_tile(reinterpret_cast<uint32_t*>(out) + row0 * kK, tile, words, vec);
}

// any fanout up to kMaxFanout: one thread per row, unstaged, records in
// local memory
__global__ void sample_khop_kernel(const int32_t* __restrict__ indptr,
                                   const int32_t* __restrict__ indices,
                                   const int32_t* __restrict__ frontier,
                                   const float* __restrict__ u,
                                   int32_t* __restrict__ out,
                                   int64_t num_node, int64_t num_rows,
                                   int fanout) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= num_rows) return;
  int32_t start, deg;
  row_meta(indptr, frontier, row, num_node, &start, &deg);
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
    orow[j] = __ldg(indices + ((int64_t)start + pick));
  }
  for (int j = live; j < fanout; ++j) orow[j] = kEmpty;
}

template <int kK>
void launch_staged(const int32_t* indptr, const int32_t* indices,
                   const int32_t* frontier, const float* u, int32_t* out,
                   long long num_node, long long num_rows, bool vec,
                   cudaStream_t s) {
  const long long blocks = (num_rows + kThreads - 1) / kThreads;
  sample_khop_staged_kernel<kK><<<(unsigned)blocks, kThreads, 0, s>>>(
      indptr, indices, frontier, u, out, num_node, num_rows, vec);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// indptr: (num_node + 1,) int32; indices: (E,) int32; frontier: (num_rows,)
// int32, EMPTY padded; u: (num_rows, fanout) float32; out: (num_rows,
// fanout) int32.  1 <= fanout <= 64.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a fanout it does not take).
extern "C" int xg_sample_khop(const void* indptr, const void* indices,
                              const void* frontier, const void* u, void* out,
                              long long num_node, long long num_rows,
                              int fanout, void* stream) {
  if (fanout < 1 || fanout > kMaxFanout) return (int)cudaErrorInvalidValue;
  if (num_rows <= 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  const int32_t* fr = static_cast<const int32_t*>(frontier);
  const float* uf = static_cast<const float*>(u);
  int32_t* o = static_cast<int32_t*>(out);
  const bool vec = aligned16(u) && aligned16(out);
  switch (fanout) {
    case 5:
      launch_staged<5>(ip, ix, fr, uf, o, num_node, num_rows, vec, s);
      break;
    case 10:
      launch_staged<10>(ip, ix, fr, uf, o, num_node, num_rows, vec, s);
      break;
    case 15:
      launch_staged<15>(ip, ix, fr, uf, o, num_node, num_rows, vec, s);
      break;
    default: {
      const long long blocks = (num_rows + kThreads - 1) / kThreads;
      sample_khop_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
          ip, ix, fr, uf, o, num_node, num_rows, fanout);
    }
  }
  return (int)cudaGetLastError();
}
