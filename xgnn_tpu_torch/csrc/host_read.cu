// A probe of the card's rate for scattered reads of pinned, mapped host
// memory: the ceiling that the tiered samplers' cold rows (K2, K8a, K8b and
// K9 on a tiered topology, tier.cuh) read against.  It replaces no TPU
// kernel and runs on no path of the port: xgnn_tpu_torch/tools/
// host_reads.py times it (tools/time_samplers.py --tiered and chip_smoke.py
// phase 12 print its rates beside the tiered samplers).
//
// Each warp reads, in each of `rounds` rounds, kU times 32 / lanes_per_read
// pieces of lanes_per_read * 4 contiguous bytes (32 or 128: one sector or
// one 128-byte line), each at a slot drawn by a hash of (seed, warp, piece,
// round), with plain ld.global.cg loads as the samplers' host reads: the
// round's reads are independent, so kU * 32 / lanes_per_read of them are in
// flight a warp.  What bounds it: the link's and the host's answers to
// scattered reads, not the card's own work (a hash and an add a word).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint64_t mix(uint64_t x) {  // splitmix64
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

template <int kU>
__global__ void __launch_bounds__(kThreads)
host_read_kernel(const uint32_t* __restrict__ buf, long long slots,
                 int lanes_per_read, int rounds, uint32_t seed,
                 uint32_t* __restrict__ sink) {
  const int lane = threadIdx.x & 31;
  const uint64_t warp =
      ((uint64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int piece = lane / lanes_per_read, sub = lane % lanes_per_read;
  const uint64_t pieces = 32 / lanes_per_read;
  uint32_t acc = 0;
  for (int round = 0; round < rounds; ++round) {
    uint32_t got[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      const uint64_t key =
          ((warp * rounds + round) * kU + i) * pieces + piece;
      const long long slot = (long long)(mix(key ^ ((uint64_t)seed << 40)) %
                                         (uint64_t)slots);
      got[i] = __ldcg(buf + slot * lanes_per_read + sub);
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) acc += got[i];
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;  // keeps the reads
}

template <int kU>
void launch(const uint32_t* buf, long long slots, int lanes, int rounds,
            int blocks, uint32_t seed, uint32_t* sink, cudaStream_t s) {
  host_read_kernel<kU><<<blocks, kThreads, 0, s>>>(buf, slots, lanes, rounds,
                                                   seed, sink);
}

}  // namespace

// buf: a device address of `words` uint32 of pinned, mapped host memory;
// lanes_per_read 8 (32-byte reads) or 32 (128-byte reads); unroll 1, 2, 4,
// 8 or 16 (a lane's reads in flight); blocks of 256 threads; sink: one
// uint32 on the card.  Reads blocks * 8 * rounds * unroll * 32 /
// lanes_per_read pieces.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int xg_host_read(const void* buf, long long words,
                            int lanes_per_read, int unroll, int rounds,
                            int blocks, unsigned seed, void* sink,
                            void* stream) {
  if ((lanes_per_read != 8 && lanes_per_read != 32) || rounds < 1 ||
      blocks < 1 || words < lanes_per_read)
    return (int)cudaErrorInvalidValue;
  const uint32_t* b = static_cast<const uint32_t*>(buf);
  uint32_t* k = static_cast<uint32_t*>(sink);
  const long long slots = words / lanes_per_read;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (unroll) {
    case 1: launch<1>(b, slots, lanes_per_read, rounds, blocks, seed, k, s);
      break;
    case 2: launch<2>(b, slots, lanes_per_read, rounds, blocks, seed, k, s);
      break;
    case 4: launch<4>(b, slots, lanes_per_read, rounds, blocks, seed, k, s);
      break;
    case 8: launch<8>(b, slots, lanes_per_read, rounds, blocks, seed, k, s);
      break;
    case 16: launch<16>(b, slots, lanes_per_read, rounds, blocks, seed, k, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
