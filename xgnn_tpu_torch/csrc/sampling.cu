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
// so only the at most K displaced entries (position, value) are kept, in
// registers when K is a compile-time constant (the fanouts the repo uses:
// 5, 10, 15), and in local memory for any other K up to kMaxFanout.  A
// lookup scans the records in step order and the last match wins, as the
// reference's chain of selects does.  The loop stops at min(K, deg), so an
// EMPTY or low-degree row reads no uniform and no index past its degree,
// and an EMPTY row never reads indptr at all.  Offsets into indices are
// 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kMaxFanout = 64;

template <int kCap, bool kFixed>
__global__ void sample_khop_kernel(const int32_t* __restrict__ indptr,
                                   const int32_t* __restrict__ indices,
                                   const int32_t* __restrict__ frontier,
                                   const float* __restrict__ u,
                                   int32_t* __restrict__ out,
                                   int64_t num_node, int64_t num_rows,
                                   int fanout) {
  const int k = kFixed ? kCap : fanout;
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= num_rows) return;
  const int32_t v = __ldg(frontier + row);
  int32_t start = 0, deg = 0;
  if (v >= 0 && (int64_t)v < num_node) {
    start = __ldg(indptr + v);
    deg = __ldg(indptr + v + 1) - start;
  }
  const int live = deg <= 0 ? 0 : (deg < k ? deg : k);
  const float* urow = u + row * k;
  int32_t* orow = out + row * k;

  // With a fixed K both loops run to compile-time bounds and unroll fully,
  // so every record index is a constant and the records stay in registers
  // (an early exit from the unrolled loop would put them on the stack); the
  // guards then fold away or skip whole steps.  Otherwise the bounds are
  // the live ones and the guards always hold.
  int32_t pos[kCap], val[kCap];
  const int j_end = kFixed ? kCap : live;
#pragma unroll
  for (int j = 0; j < j_end; ++j) {
    if (j < live) {
      const int32_t span = deg - j;
      const float x = __fmul_rn(__ldg(urow + j), __int2float_rn(span));
      const int32_t d = __float2int_rz(floorf(x));
      const int32_t t = j + (d < span - 1 ? d : span - 1);
      int32_t pick = t, a_j = j;
      const int i_end = kFixed ? kCap : j;
#pragma unroll
      for (int i = 0; i < i_end; ++i) {
        if (i < j) {
          if (pos[i] == t) pick = val[i];
          if (pos[i] == j) a_j = val[i];
        }
      }
      pos[j] = t;
      val[j] = a_j;
      orow[j] = __ldg(indices + ((int64_t)start + pick));
    }
  }
  for (int j = live; j < k; ++j) orow[j] = kEmpty;
}

template <int kCap, bool kFixed>
void launch(const int32_t* indptr, const int32_t* indices,
            const int32_t* frontier, const float* u, int32_t* out,
            long long num_node, long long num_rows, int fanout,
            cudaStream_t s) {
  const long long blocks = (num_rows + kThreads - 1) / kThreads;
  sample_khop_kernel<kCap, kFixed><<<(unsigned)blocks, kThreads, 0, s>>>(
      indptr, indices, frontier, u, out, num_node, num_rows, fanout);
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
  switch (fanout) {
    case 5:
      launch<5, true>(ip, ix, fr, uf, o, num_node, num_rows, fanout, s);
      break;
    case 10:
      launch<10, true>(ip, ix, fr, uf, o, num_node, num_rows, fanout, s);
      break;
    case 15:
      launch<15, true>(ip, ix, fr, uf, o, num_node, num_rows, fanout, s);
      break;
    default:
      launch<kMaxFanout, false>(ip, ix, fr, uf, o, num_node, num_rows, fanout,
                                s);
  }
  return (int)cudaGetLastError();
}
