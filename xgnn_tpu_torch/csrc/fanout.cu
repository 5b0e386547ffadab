// K4: fanout gather-reduce, forward and backward.
//
// Forward:  sum[i, :] = sum_k m[i,k] * h_src[neigh[i,k], :]
//           denom[i]  = sum_k m[i,k]
// where m[i,k] = valid(neigh[i,k]) (times weights[i,k] when given) and a
// pick is valid when it lies in [0, num_rows): EMPTY (int32 max) is not.
// Backward: grad_h_src[neigh[i,k], :] += m[i,k] * grad_sum[i, :] for every
// valid pick; denom carries no gradient.
//
// Replaces: xgnn_tpu/models/gnn.py, fanout_reduce (the "loop" contract,
// K unrolled gather + FMA passes that XLA fuses) and its autodiff
// scatter-add.  On the TPU it was XLA ops, not a Pallas kernel; the port
// writes it by hand because it is the heaviest traffic of the step.
//
// What bounds it on an H100: bytes.  The forward reads every valid pick's
// row once (layer 0 of the main path: about 5M rows of 512 B from the
// 2.45M-row feature table) and writes each sum row once; one FMA per element
// read is far below the card's arithmetic rate.  The backward reads
// grad_sum once and does one float atomic per valid pick element.
//
// Design: one warp per dst row.  Forward: lanes hold a 16-byte column slice
// (float4) when F % 4 == 0 and the tables are aligned, else one float; the
// K picks are summed in registers in pick order and the row is written
// once, so the (dst, F) accumulator never round-trips device memory as it
// did in the K-pass XLA loop.  All lanes read the same pick id (a broadcast
// load).  An invalid pick reads nothing.  Sums run in the order k = 0..K-1
// with the product rounded before the add, as the plain PyTorch version
// does, so the two agree bit for bit.  Backward: the same warp-per-row walk
// adds each pick's grad_sum row into the zeroed grad_h_src with atomics,
// which make the order of the sum into one src row vary from run to run.
// When F % 4 == 0 and the tables are aligned each lane issues one 16-byte
// vector atomicAdd (float4, sm_90 and later), so a warp updates 512
// contiguous bytes per instruction; otherwise lane c adds column c, and a
// warp updates 128 contiguous bytes per instruction.  Building with
// -DXG_FANOUT_BWD_VEC4=0 keeps only the scalar form, to time the two
// against each other (python -m xgnn_tpu_torch.ops.time_fanout_bwd).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef XG_FANOUT_BWD_VEC4
#define XG_FANOUT_BWD_VEC4 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

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

template <bool kVec>
__global__ void fanout_bwd_kernel(const float* __restrict__ grad_sum,
                                  const int32_t* __restrict__ neigh,
                                  const float* __restrict__ w,
                                  float* __restrict__ grad_h,
                                  int64_t num_rows, int64_t num_dst, int fanout,
                                  int64_t width) {
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= num_dst) return;
  const int32_t* nrow = neigh + row * fanout;
  const float* g = grad_sum + row * width;
  for (int k = 0; k < fanout; ++k) {
    const int32_t id = __ldg(nrow + k);
    if (!pick_valid(id, num_rows)) continue;
    float* dst = grad_h + (int64_t)id * width;
    if (w) {
      const float m = __ldg(w + row * fanout + k);
      for (int64_t c = lane; c < width; c += 32)
        atomicAdd(dst + c, __fmul_rn(m, __ldg(g + c)));
    } else if (kVec) {
      const int64_t w4 = width >> 2;
      float4* d4 = reinterpret_cast<float4*>(dst);
      for (int64_t c = lane; c < w4; c += 32)
        atomicAdd(d4 + c, __ldg(reinterpret_cast<const float4*>(g) + c));
    } else {
      for (int64_t c = lane; c < width; c += 32) atomicAdd(dst + c, __ldg(g + c));
    }
  }
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

// grad_sum: (num_dst, width) f32; grad_h: (num_rows, width) f32, zeroed by
// the caller; neigh and w as in the forward.
extern "C" int xg_fanout_bwd(const void* grad_sum, const void* neigh,
                             const void* w, void* grad_h, long long num_rows,
                             long long num_dst, int fanout, long long width,
                             void* stream) {
  if (num_dst <= 0) return (int)cudaGetLastError();
  const long long blocks = (num_dst + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec = XG_FANOUT_BWD_VEC4 && width % 4 == 0 &&
                   aligned16(grad_sum) && aligned16(grad_h);
  const float* g = static_cast<const float*>(grad_sum);
  const int32_t* n = static_cast<const int32_t*>(neigh);
  const float* wf = static_cast<const float*>(w);
  float* gh = static_cast<float*>(grad_h);
  if (vec) {
    fanout_bwd_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, n, wf, gh, num_rows, num_dst, fanout, width);
  } else {
    fanout_bwd_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        g, n, wf, gh, num_rows, num_dst, fanout, width);
  }
  return (int)cudaGetLastError();
}
