// K3: seeded dedup and remap.
//
// ids = concat(prev_frontier, picks) of length n; the first prev_cap
// entries are the previous frontier (unique, num_prev of them valid, at
// positions 0..num_prev-1).  An id is valid when it lies in [0, num_node);
// EMPTY (int32 max) and any other id outside that range count as EMPTY.
// Outputs:
//   local[i]    the local id of ids[i]: a previous-frontier id keeps its
//               (first) position; the new ids follow from num_prev on in
//               ascending id order; EMPTY for an invalid id.  It may be
//               >= out_cap.
//   uniq[out_cap]  the id at each local id below out_cap, EMPTY elsewhere.
//   num_unique  the number of distinct valid ids; it may exceed out_cap,
//               which the caller flags as overflow.
//
// Replaces: xgnn_tpu/ops/unique.py, unique_seeded (lines 178-233): three
// multi-operand sorts and a log-doubling forward fill, all TPU workarounds
// for slow scatters.  Ascending id order is what a scan over the id space
// gives, so on this card the dedup is a direct-address table over node ids.
//
// What bounds it on an H100: bytes.  The function itself moves n ids in, n
// local ids and out_cap unique ids out.  The design adds the table's own
// traffic: num_node int32 cleared, read twice by the scan, and one random
// read per id.  At products scale (2.45M nodes, 9.8 MB) that is about 40 MB,
// more than the function's own 16 MB at the main path's layer-1 shape.
//
// Design, six launches on the caller's stream, no host sync:
//   1. clear: table[v] = ABSENT for every node; uniq[] = EMPTY.
//   2. mark: atomicMin(table[id], i) for a valid prefix id at position i,
//      atomicMin(table[id], NEW) for a valid pick.  NEW is above every
//      position, so a prefix id keeps its smallest position whatever the
//      order of the atomics (a repeated prefix id resolves as a stable sort
//      does), and a pick that is not a prefix id reads NEW.  A plain read
//      first skips the atomic when the table already holds a value as small.
//   3. count: one warp per segment of kSeg consecutive node ids counts, by
//      ballots, the NEW entries and the present (not ABSENT) ones.
//   4. scan: one block turns the segments' NEW counts into exclusive
//      offsets and writes num_unique, the sum of the present counts.
//   5. rank: each warp walks its segment again in id order; a NEW entry
//      gets num_prev + its offset + the NEW entries before it (ballot and
//      popc), written into the table and, below out_cap, into uniq.
//   6. remap: local[i] = table[ids[i]]; a prefix position that holds its
//      id's smallest position writes that id into uniq.
// The table and the segment counts are scratch the wrapper allocates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int32_t kAbsent = 0x7fffffff;  // table: id not in ids
constexpr int32_t kNew = 0x7ffffffe;     // table: id only among the picks
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 1024;  // node ids per warp in count and rank
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool valid_id(int32_t id, int64_t num_node) {
  return id >= 0 && (int64_t)id < num_node;
}

__device__ __forceinline__ int64_t global_thread() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_threads() {
  return (int64_t)gridDim.x * blockDim.x;
}

__global__ void clear_kernel(int32_t* __restrict__ table, int64_t num_node,
                             int32_t* __restrict__ uniq, int64_t out_cap) {
  const int64_t stride = grid_threads();
  for (int64_t i = global_thread(); i < num_node; i += stride)
    table[i] = kAbsent;
  for (int64_t i = global_thread(); i < out_cap; i += stride) uniq[i] = kEmpty;
}

__global__ void mark_kernel(const int32_t* __restrict__ ids, int64_t n,
                            int64_t prev_cap, int32_t* __restrict__ table,
                            int64_t num_node) {
  const int64_t stride = grid_threads();
  for (int64_t i = global_thread(); i < n; i += stride) {
    const int32_t id = __ldg(ids + i);
    if (!valid_id(id, num_node)) continue;
    const int32_t mark = i < prev_cap ? (int32_t)i : kNew;
    if (*(volatile int32_t*)(table + id) > mark) atomicMin(table + id, mark);
  }
}

__global__ void count_kernel(const int32_t* __restrict__ table,
                             int64_t num_node, int64_t num_seg,
                             int32_t* __restrict__ seg_new,
                             int32_t* __restrict__ seg_present) {
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= num_seg) return;
  int n_new = 0, n_present = 0;
  for (int c = 0; c < kSeg; c += 32) {
    const int64_t v = seg * kSeg + c + lane;
    const int32_t t = v < num_node ? table[v] : kAbsent;
    n_new += __popc(__ballot_sync(kFull, t == kNew));
    n_present += __popc(__ballot_sync(kFull, t != kAbsent));
  }
  if (lane == 0) {
    seg_new[seg] = n_new;
    seg_present[seg] = n_present;
  }
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

// one block of kScanThreads: seg_new becomes the exclusive prefix of itself
__global__ void scan_kernel(int32_t* __restrict__ seg_new,
                            const int32_t* __restrict__ seg_present,
                            int64_t num_seg, int32_t* __restrict__ num_unique) {
  int run_new = 0, run_present = 0;
  for (int64_t base = 0; base < num_seg; base += kScanThreads) {
    const int64_t s = base + threadIdx.x;
    const int x = s < num_seg ? seg_new[s] : 0;
    const int p = s < num_seg ? seg_present[s] : 0;
    int tot_new, tot_present;
    const int incl = block_inclusive_sum(x, &tot_new);
    block_inclusive_sum(p, &tot_present);
    if (s < num_seg) seg_new[s] = run_new + incl - x;
    run_new += tot_new;
    run_present += tot_present;
  }
  if (threadIdx.x == 0) *num_unique = run_present;
}

__global__ void rank_kernel(int32_t* __restrict__ table, int64_t num_node,
                            int64_t num_seg,
                            const int32_t* __restrict__ seg_base,
                            const int32_t* __restrict__ num_prev,
                            int32_t* __restrict__ uniq, int64_t out_cap) {
  const int64_t seg = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (seg >= num_seg) return;
  const unsigned below = (1u << lane) - 1u;
  int64_t next = (int64_t)*num_prev + seg_base[seg];
  for (int c = 0; c < kSeg; c += 32) {
    const int64_t v = seg * kSeg + c + lane;
    const bool is_new = v < num_node && table[v] == kNew;
    const unsigned mask = __ballot_sync(kFull, is_new);
    if (is_new) {
      const int64_t local = next + __popc(mask & below);
      table[v] = (int32_t)local;
      if (local < out_cap) uniq[local] = (int32_t)v;
    }
    next += __popc(mask);
  }
}

__global__ void remap_kernel(const int32_t* __restrict__ ids, int64_t n,
                             int64_t prev_cap,
                             const int32_t* __restrict__ table,
                             int64_t num_node, int32_t* __restrict__ local,
                             int32_t* __restrict__ uniq, int64_t out_cap) {
  const int64_t stride = grid_threads();
  for (int64_t i = global_thread(); i < n; i += stride) {
    const int32_t id = __ldg(ids + i);
    if (!valid_id(id, num_node)) {
      local[i] = kEmpty;
      continue;
    }
    const int32_t l = table[id];
    local[i] = l;
    if (i < prev_cap && l == (int32_t)i && i < out_cap) uniq[i] = id;
  }
}

unsigned grid_for(long long work) {
  // grid-stride kernels: enough blocks to fill the card, no more
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// ids: (n,) int32; num_prev: device int32 scalar; scratch: (scratch_len,)
// int32, at least num_node + 2 * ceil(num_node / 1024) entries (the table,
// then two counts per segment); uniq: (out_cap,) int32; num_unique: device
// int32 scalar; local: (n,) int32.  Returns cudaGetLastError() after the
// last launch (cudaErrorInvalidValue, launching nothing, for a scratch too
// small).
extern "C" int xg_unique_seeded(const void* ids, long long n,
                                long long prev_cap, const void* num_prev,
                                long long num_node, long long out_cap,
                                void* scratch, long long scratch_len,
                                void* uniq, void* num_unique, void* local,
                                void* stream) {
  const long long num_seg = (num_node + kSeg - 1) / kSeg;
  if (scratch_len < num_node + 2 * num_seg) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* id = static_cast<const int32_t*>(ids);
  int32_t* table = static_cast<int32_t*>(scratch);
  int32_t* seg_new = table + num_node;
  int32_t* seg_present = seg_new + num_seg;
  int32_t* u = static_cast<int32_t*>(uniq);
  int32_t* l = static_cast<int32_t*>(local);
  const int32_t* np = static_cast<const int32_t*>(num_prev);

  clear_kernel<<<grid_for(num_node > out_cap ? num_node : out_cap), kThreads,
                 0, s>>>(table, num_node, u, out_cap);
  if (n > 0)
    mark_kernel<<<grid_for(n), kThreads, 0, s>>>(id, n, prev_cap, table,
                                                 num_node);
  const unsigned seg_blocks = (unsigned)((num_seg + kWarps - 1) / kWarps);
  if (num_seg > 0)
    count_kernel<<<seg_blocks, kThreads, 0, s>>>(table, num_node, num_seg,
                                                 seg_new, seg_present);
  scan_kernel<<<1, kScanThreads, 0, s>>>(seg_new, seg_present, num_seg,
                                         static_cast<int32_t*>(num_unique));
  if (num_seg > 0)
    rank_kernel<<<seg_blocks, kThreads, 0, s>>>(table, num_node, num_seg,
                                                seg_new, np, u, out_cap);
  if (n > 0)
    remap_kernel<<<grid_for(n), kThreads, 0, s>>>(id, n, prev_cap, table,
                                                  num_node, l, u, out_cap);
  return (int)cudaGetLastError();
}
