// K3: seeded dedup and remap.
//
// The ids come in two arrays: the prefix (the previous frontier, prev_cap
// entries, unique, num_prev of them valid at positions 0..num_prev-1) and
// the picks (m entries).  An id is valid when it lies in [0, num_node);
// EMPTY (int32 max) and any other id outside that range count as EMPTY.
// Outputs:
//   local_prefix[i], local_picks[j]  the local id of each id: a prefix id
//               keeps its (first) prefix position; the new ids follow from
//               num_prev on in ascending id order; EMPTY for an invalid id.
//               It may be >= out_cap.  local_prefix may be null.
//   uniq[out_cap]  the id at each local id below out_cap, EMPTY elsewhere.
//   num_unique  the number of distinct valid ids; it may exceed out_cap,
//               which the caller flags as overflow.
//
// Replaces: xgnn_tpu/ops/unique.py, unique_seeded (lines 178-233): three
// multi-operand sorts and a log-doubling forward fill, all TPU workarounds
// for slow scatters.  Ascending id order is what a scan over the id space
// gives, so on this card the dedup is a direct-address table over node ids
// with a bitmap of the ids present.
//
// What bounds it on an H100: not bytes (the function moves the ids in, the
// local ids and out_cap unique ids out) but random L2 accesses, two per
// pick: an atomic in mark and a read in remap, each at L2's rate for
// scattered 4- and 8-byte accesses, whether atomic or not.  At small shapes
// the three launches and the scan's dependent round trips set the time.
// No pass touches num_node words: the caller's state (below) is kept valid
// across calls without a clear, and the scan reads only the bitmaps, one
// bit per node (num_node / 8 bytes each, 306 KB at products scale).  A
// pick's local id comes from a per-word record of the scan (612 KB, in
// L2); only prefix ids touch the table.
//
// State, one per (device, stream, num_node), owned by the wrapper, int64
// words:
//   table[num_node]  (~gen << 32) | prefix position.  Every write of a call
//                    carries its generation's stamp ~gen, below every older
//                    stamp, so an atomicMin of this call beats what older
//                    calls left, and a read of an id marked in this call
//                    sees this call's value.
//   status[tiles]    the scan's tile words, (gen << 32) | flag | count: a
//                    word of an older generation reads as not yet published.
//   rank[words]      per bitmap word (words = ceil(num_node / 32)): the new
//                    ids before the word << 32 | the word's new-id bits;
//                    written by the scan for every word a pick marked.
//   bitmaps          the picks' bits, then the prefix's bits, words uint32
//                    each; all zero between calls (the scan zeroes the
//                    words it reads).
//   misc             the scan's ticket counter (0 between calls) and the
//                    number of new ids of the call.
//   generations      two uint32: last_gen, the generation of the state's
//                    last call (0 for a new state), and cur_gen, the
//                    current call's.  Mark and rank take last_gen + 1; the
//                    scan's last tile stores it in cur_gen, and remap, which
//                    reads only cur_gen, stores it in last_gen.  So the
//                    generation needs no host value, and a call captured in
//                    a CUDA graph gets a new one on every replay.  A call of
//                    generation 2^32 - 1, the last a stamp holds, ends with
//                    the last block of remap to finish clearing the table
//                    and the tile words and storing last_gen 0: the next
//                    call starts again at 1.
//
// Three launches on the caller's stream, no host sync, no allocation:
//   1. mark: a valid prefix id at position i does atomicMin(table[id],
//      stamp | i) (a repeated prefix id keeps its smallest position, as a
//      stable sort does) and sets its prefix bit; a valid pick sets its pick
//      bit.  Each is one random L2 atomic, the kernel's whole cost (a read
//      to skip bits already set costs more than it saves).
//   2. rank: a single-pass scan over the bitmaps with decoupled look-back
//      (Merrill and Garland, 2016).  A tile of 256 bitmap words (8,192 ids)
//      takes its index from an atomic ticket, counts its new ids (pick bit
//      and no prefix bit), publishes the count, looks back for its exclusive
//      prefix with a warp, writes each word's rank record, then each warp
//      walks its 32 words in id order (popc ranks) and writes, below
//      out_cap, uniq[local] = id.  The last tile writes the number of new
//      ids and starts num_unique with it.
//   3. remap: a new pick's local id is num_prev + its word's count + the
//      new-id bits below its own; a prefix id's (prefix position or pick)
//      is the table's value; EMPTY for an invalid id.  A prefix position
//      that holds its id's smallest position writes the id into uniq and
//      counts one distinct prefix id (a block sum, one integer atomic into
//      num_unique per block); every uniq slot no id lands on gets EMPTY.
//      A grid-stride over max(prev_cap + m, out_cap).  Its first thread
//      stores the call's generation in last_gen.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int32_t kEmpty = 0x7fffffff;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileWords = kThreads;  // bitmap words per rank tile
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kInclusive = 0x80000000u;  // status: prefix, not count

__device__ __forceinline__ bool valid_id(int32_t id, int64_t num_node) {
  return id >= 0 && (int64_t)id < num_node;
}

__device__ __forceinline__ int64_t global_thread() {
  return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_threads() {
  return (int64_t)gridDim.x * blockDim.x;
}

__device__ __forceinline__ u64 status_word(uint32_t gen, unsigned flag,
                                           uint32_t count) {
  return ((u64)gen << 32) | flag | count;
}

__device__ __forceinline__ uint32_t call_generation(const uint32_t* last_gen) {
  return *last_gen + 1u;
}

constexpr uint32_t kLastGen = 0xffffffffu;  // the last generation a stamp holds

__global__ void mark_kernel(const int32_t* __restrict__ prefix,
                            int64_t prev_cap,
                            const int32_t* __restrict__ picks, int64_t m,
                            int64_t num_node,
                            const uint32_t* __restrict__ last_gen,
                            u64* __restrict__ table,
                            uint32_t* __restrict__ pick_bits,
                            uint32_t* __restrict__ prefix_bits) {
  const int64_t n = prev_cap + m, stride = grid_threads();
  const u64 stamp = (u64)(~call_generation(last_gen)) << 32;
  for (int64_t i = global_thread(); i < n; i += stride) {
    if (i < prev_cap) {
      const int32_t id = __ldg(prefix + i);
      if (!valid_id(id, num_node)) continue;
      atomicMin(table + id, stamp | (uint32_t)i);
      atomicOr(prefix_bits + (id >> 5), 1u << (id & 31));
    } else {
      const int32_t id = __ldg(picks + (i - prev_cap));
      if (!valid_id(id, num_node)) continue;
      atomicOr(pick_bits + (id >> 5), 1u << (id & 31));
    }
  }
}

__global__ void rank_kernel(uint32_t* __restrict__ pick_bits,
                            uint32_t* __restrict__ prefix_bits, int64_t words,
                            u64* __restrict__ rank, u64* __restrict__ status,
                            int32_t tiles,
                            const uint32_t* __restrict__ last_gen,
                            uint32_t* __restrict__ cur_gen,
                            int32_t* __restrict__ ticket,
                            int32_t* __restrict__ num_new,
                            const int32_t* __restrict__ num_prev,
                            int32_t* __restrict__ uniq, int64_t out_cap,
                            int32_t* __restrict__ num_unique) {
  __shared__ int32_t s_tile;
  __shared__ uint32_t s_warp[kWarps];  // warp counts, then warp offsets
  __shared__ uint32_t s_excl;          // the tile's exclusive prefix
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t gen = call_generation(last_gen);
  if (threadIdx.x == 0) {
    // tiles draw their index in the order they start, so every tile a
    // tile looks back at has started and will publish
    const int32_t t = atomicAdd(ticket, 1);
    if (t == tiles - 1) *ticket = 0;  // the launch's last ticket is drawn
    s_tile = t;
  }
  __syncthreads();
  const int32_t tile = s_tile;

  // this lane's bitmap word: its new ids, and both words zeroed
  const int64_t w = (int64_t)tile * kTileWords + threadIdx.x;
  uint32_t fresh = 0, picked = 0;
  if (w < words) {
    const uint32_t q = prefix_bits[w];
    picked = pick_bits[w];
    fresh = picked & ~q;
    if (picked) pick_bits[w] = 0;
    if (q) prefix_bits[w] = 0;
  }
  const uint32_t count = __popc(fresh);
  uint32_t incl = count;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();

  if (warp == 0) {
    const uint32_t wc = lane < kWarps ? s_warp[lane] : 0;
    uint32_t wi = wc;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, wi, o);
      if (lane >= o) wi += y;
    }
    const uint32_t agg = __shfl_sync(kFull, wi, 31);
    if (lane < kWarps) s_warp[lane] = wi - wc;
    uint32_t excl = 0;
    if (tile == 0) {
      if (lane == 0) atomicExch(status, status_word(gen, kInclusive, agg));
    } else {
      if (lane == 0) atomicExch(status + tile, status_word(gen, 0, agg));
      // look back 32 tiles at a time, lane l at tile top - l, until a tile
      // with its inclusive prefix
      for (int64_t top = tile - 1;; top -= 32) {
        const int64_t j = top - lane;
        u64 s;
        do {
          s = j >= 0 ? *(volatile const u64*)(status + j)
                     : status_word(gen, kInclusive, 0);
        } while (!__all_sync(kFull, (uint32_t)(s >> 32) == gen));
        const unsigned done = __ballot_sync(kFull, (uint32_t)s & kInclusive);
        const int last = done ? __ffs(done) - 1 : 31;
        excl += __reduce_add_sync(
            kFull, lane <= last ? (uint32_t)s & ~kInclusive : 0u);
        if (done) break;
      }
      if (lane == 0)
        atomicExch(status + tile, status_word(gen, kInclusive, excl + agg));
    }
    if (lane == 0) {
      s_excl = excl;
      if (tile == tiles - 1) {
        *num_new = (int32_t)(excl + agg);
        *num_unique = (int32_t)(excl + agg);
        *cur_gen = gen;
      }
    }
  }
  __syncthreads();

  // the new ids before this lane's word, for the remap's picks
  const uint32_t before = s_excl + s_warp[warp] + (incl - count);
  if (picked) rank[w] = ((u64)before << 32) | fresh;
  // each warp writes the new ids of its 32 words into uniq, word by word in
  // id order: lane b takes bit b, so a word's writes are contiguous
  const int64_t base = (int64_t)*num_prev + before;
  const unsigned below = (1u << lane) - 1u;
  const int64_t w0 = (int64_t)tile * kTileWords + warp * 32;
  for (int k = 0; k < 32; ++k) {
    const uint32_t word = __shfl_sync(kFull, fresh, k);
    const int64_t at = __shfl_sync(kFull, base, k);
    if (!word) continue;
    if ((word >> lane) & 1u) {
      const int64_t local = at + __popc(word & below);
      if (local < out_cap) uniq[local] = (int32_t)((w0 + k) * 32 + lane);
    }
  }
}

__global__ void remap_kernel(const int32_t* __restrict__ prefix,
                             int64_t prev_cap,
                             const int32_t* __restrict__ picks, int64_t m,
                             int64_t num_node, u64* table,
                             const u64* __restrict__ rank,
                             const int32_t* __restrict__ num_prev,
                             const int32_t* __restrict__ num_new,
                             int32_t* __restrict__ local_prefix,
                             int32_t* __restrict__ local_picks,
                             int32_t* __restrict__ uniq, int64_t out_cap,
                             int32_t* __restrict__ num_unique,
                             u64* __restrict__ status, int32_t tiles,
                             const uint32_t* __restrict__ cur_gen,
                             uint32_t* __restrict__ last_gen,
                             int32_t* __restrict__ ticket) {
  __shared__ int s_heads[kWarps];
  __shared__ bool s_last;
  const uint32_t gen = *cur_gen;
  if (blockIdx.x == 0 && threadIdx.x == 0 && gen != kLastGen) *last_gen = gen;
  const int64_t n = prev_cap + m, work = n > out_cap ? n : out_cap;
  const int64_t stride = grid_threads();
  // the new ids' slots, written by the rank
  const int64_t new_lo = *num_prev, new_hi = new_lo + *num_new;
  int heads = 0;
  for (int64_t i = global_thread(); i < work; i += stride) {
    bool fill = i < out_cap && (i < new_lo || i >= new_hi);
    if (i < prev_cap) {
      const int32_t id = __ldg(prefix + i);
      int32_t l = kEmpty;
      if (valid_id(id, num_node)) {
        l = (int32_t)(uint32_t)table[id];
        if ((int64_t)l == i) {
          ++heads;
          if (i < out_cap) {
            uniq[i] = id;
            fill = false;
          }
        }
      }
      if (local_prefix) local_prefix[i] = l;
    } else if (i < n) {
      const int32_t id = __ldg(picks + (i - prev_cap));
      int32_t l = kEmpty;
      if (valid_id(id, num_node)) {
        const u64 r = __ldg(rank + (id >> 5));
        const uint32_t fresh = (uint32_t)r, bit = 1u << (id & 31);
        l = fresh & bit ? (int32_t)(new_lo + (uint32_t)(r >> 32) +
                                    __popc(fresh & (bit - 1u)))
                        : (int32_t)(uint32_t)table[id];
      }
      local_picks[i - prev_cap] = l;
    }
    if (fill) uniq[i] = kEmpty;
  }
  heads = __reduce_add_sync(kFull, heads);
  if ((threadIdx.x & 31) == 0) s_heads[threadIdx.x >> 5] = heads;
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kWarps; ++w) sum += s_heads[w];
    if (sum) atomicAdd(num_unique, sum);
  }
  if (gen != kLastGen) return;
  // the stamp's last generation: once every block's reads of the table are
  // done (a ticket each), the last block makes every table entry older
  // than any stamp, every tile word unpublished, and the next call's
  // generation 1
  if (threadIdx.x == 0) {
    __threadfence();
    const int32_t t = atomicAdd(ticket, 1);
    s_last = t == (int32_t)gridDim.x - 1;
    if (s_last) *ticket = 0;
  }
  __syncthreads();
  if (!s_last) return;
  for (int64_t i = threadIdx.x; i < num_node; i += blockDim.x)
    table[i] = ~0ull;
  for (int64_t i = threadIdx.x; i < tiles; i += blockDim.x) status[i] = 0;
  if (threadIdx.x == 0) *last_gen = 0;
}

unsigned grid_for(long long work) {
  // grid-stride kernels: enough blocks to fill the card, no more
  const long long want = (work + kThreads - 1) / kThreads;
  const long long cap = 132LL * 16;
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace

// prefix: (prev_cap,) int32; picks: (m,) int32; num_prev: device int32
// scalar; state: (state_len,) int64, laid out as above, at least num_node
// + tiles + 2 * words + 2 entries for words = ceil(num_node / 32) and tiles =
// max(1, ceil(words / 256)), all as a new state holds them (table -1, the
// rest 0) or as the last call left them; uniq: (out_cap,) int32;
// num_unique: device int32 scalar; local_prefix: (prev_cap,) int32 or null;
// local_picks: (m,) int32.  Returns cudaGetLastError() after the last
// launch (cudaErrorInvalidValue, launching nothing, for a state too
// small).
extern "C" int xg_unique_seeded(const void* prefix, long long prev_cap,
                                const void* picks, long long m,
                                const void* num_prev, long long num_node,
                                long long out_cap, void* state,
                                long long state_len, void* uniq,
                                void* num_unique, void* local_prefix,
                                void* local_picks, void* stream) {
  const long long words = (num_node + 31) / 32;
  const long long tiles_ll = (words + kTileWords - 1) / kTileWords;
  const int32_t tiles = (int32_t)(tiles_ll < 1 ? 1 : tiles_ll);
  if (state_len < num_node + tiles + 2 * words + 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  u64* table = static_cast<u64*>(state);
  u64* status = table + num_node;
  u64* rank = status + tiles;
  uint32_t* pick_bits = reinterpret_cast<uint32_t*>(rank + words);
  uint32_t* prefix_bits = pick_bits + words;
  int32_t* misc = reinterpret_cast<int32_t*>(rank + 2 * words);
  int32_t* ticket = misc;
  int32_t* num_new = misc + 1;
  uint32_t* last_gen = reinterpret_cast<uint32_t*>(rank + 2 * words + 1);
  uint32_t* cur_gen = last_gen + 1;
  const int32_t* pre = static_cast<const int32_t*>(prefix);
  const int32_t* pk = static_cast<const int32_t*>(picks);
  const int32_t* np = static_cast<const int32_t*>(num_prev);
  int32_t* u = static_cast<int32_t*>(uniq);
  int32_t* nu = static_cast<int32_t*>(num_unique);
  const long long n = prev_cap + m;

  if (n > 0)
    mark_kernel<<<grid_for(n), kThreads, 0, s>>>(pre, prev_cap, pk, m,
                                                 num_node, last_gen, table,
                                                 pick_bits, prefix_bits);
  rank_kernel<<<tiles, kThreads, 0, s>>>(pick_bits, prefix_bits, words, rank,
                                         status, tiles, last_gen, cur_gen,
                                         ticket, num_new, np, u, out_cap, nu);
  // launched even with nothing to remap: it advances last_gen
  const long long work = n > out_cap ? n : out_cap;
  remap_kernel<<<grid_for(work), kThreads, 0, s>>>(
      pre, prev_cap, pk, m, num_node, table, rank, np, num_new,
      static_cast<int32_t*>(local_prefix), static_cast<int32_t*>(local_picks),
      u, out_cap, nu, status, tiles, cur_gen, last_gen, ticket);
  return (int)cudaGetLastError();
}
