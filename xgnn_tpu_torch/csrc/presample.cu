// K12 and K12b: the presample counts of the cache rankings.
//
// K12, accumulate_freq: freq[ids[i]] += 1 for every i < num_input whose id
// lies in [0, num_node) (EMPTY and other ids are dropped).  Exact int32.
//
// Replaces: xgnn_tpu/store/presample.py, _accumulate (a jitted
// scatter-add over a batch's input nodes; XLA ops on the TPU, not a Pallas
// kernel).  It counts presample_ranking's batches and the dynamic cache's
// steps.
//
// What bounds K12 on an H100: bytes.  It reads each id once and reads and
// writes one freq word per valid id (the main path's last frontier, about
// 2M valid ids of 2,449,152: about 26 MB, under 0.01 ms at 3.35 TB/s).
// Design: a thread per id, grid-stride, an integer atomicAdd per valid id.
// A batch's input nodes are distinct (the last layer's dedup), so the
// atomics never contend; integer adds are exact in any order.
//
// K12b, closure_expand: one batch of static_exact_ranking.  The seeds'
// mask, then num_layer times every CSR neighbour of a marked row marked
// (from the mask of the layer before: a row marked in this layer does not
// expand until the next), then counts[v] += mask[v] for every node.
//
// Replaces: xgnn_tpu/store/presample.py, expand inside static_exact_ranking
// (an edge-parallel bitmask closure: a gather of the mask along each edge's
// source row and a scatter-max into the destinations; XLA ops).
//
// What bounds K12b: bytes, and one visited-set probe an edge.  Marks are
// monotone, so a row's neighbours are all marked once the row has been
// expanded: each row within L-1 hops has to be expanded once, at the layer
// after the one that marked it.  The least the card reads is those rows'
// indptr pairs and indices once (at products scale a batch of 8,000 seeds
// marks 2,447,294 of 2,449,029 rows within 2 hops: about 500 MB, 0.16 ms
// at 3.35 TB/s), the seeds, and the counts read and written once.  Each of
// those edges also asks whether its target is marked: a random probe, an
// L2 access of its own wherever it leaves the SM (an H100 80GB HBM3 serves
// about 80-110G of those a second, tools/time_degree.py), so the design
// keeps the probes in L1 or shared memory where it can.
// Design: a BFS by levels, L + 3 launches a batch and no host round trip.
//   level: a byte a node, 0 unmarked, 1 a seed, l + 2 first marked by
//   layer l.  Layer l expands the rows whose level is l + 1, so each row
//   once; the frontier is read from the level bytes in row order, so its
//   indptr pairs and indices stream in order (a row not in the frontier
//   costs one byte of a coalesced read).  The index reads are evict-first
//   (__ldcs), ahead of the level bytes and the visited bits.
//   start: the seeds' levels and visited bits (after one memset of the
//   scratch) and the hub plan: each row of more than kHub edges is cut into
//   chunks of kHub edges, a work unit each, so no warp waits on a hub (the
//   products graph's longest row has 18,969 edges).
//   expand: a warp takes 32 consecutive rows (a tile) or a hub chunk.  A
//   tile's frontier rows of at most kHub edges are flattened into one run
//   of edges (a scan of their degrees; each lane finds its edge's row with
//   two warp votes), so the warp streams kUnroll coalesced 128-byte reads
//   at a time however short its rows.  A closed tile (no row unmarked or
//   marked by this launch, no hub) whose frontier holds at least half its
//   edges streams its whole index run in 16-byte reads instead: its other
//   rows were expanded by earlier layers, so their targets are marked.
//   A layer below the last tests a target's bit in the visited bitmap (a
//   bit a node, 306 KB at products scale, read through L1) before it marks
//   it: an atomicOr of the bit and its level l + 2.  A stale L1 word only
//   misses a mark of this launch, and the repeated mark is the same.
//   The last layer marks nothing that expands, so counts += mask comes
//   first (one coalesced pass, which also writes a summary: a bit for
//   each group of G nodes with any node still unmarked, G the least power
//   of two that keeps it within kSummaryBits), and the last layer then
//   only claims: a target whose group's bit is clear (in shared memory) is
//   already counted; else, if its level is 0, an atomicOr of 0x80 into its
//   byte tells one thread that it claimed the node first, and that thread
//   adds its 1.  At products scale 1,735 nodes are unmarked when the last
//   layer starts, so its probes stay on the SM, and its tiles are closed.
// Measured on that card (tools/time_presample.py, one batch): 0.51 ms,
// layer 1 (about 25M edges, most of them probing the bitmap) 0.27 and the
// last layer (124M edges streamed) 0.19; the variants the tool builds give
// what each choice above is worth.
//
// K12b's partitioned form, closure_parts: the exact closure of P batches at
// once (a lane a rank's batch) over the interleave-partitioned CSR, where a
// rank's local row r is global node r * P + part and holds that node's
// edges with their global destinations.  The rank keeps each lane's level
// over its own rows ((P lanes, rows) bytes: 0 unmarked, t first marked by
// layer t - 1's reduce, 1 the seeds) and a known set: a bit for each
// (node, lane) this rank knows is marked, node-major (node v's lanes at
// bits v * Q .. v * Q + P - 1, Q the least power of two >= P, so a probe
// reads every lane of a node in one word; 306 KB at P = 1 at products
// scale).  The caller zeroes both once a batch; calls with tags 1, 2, ...
// in order carry them.  A layer is one call and one reduce by owner:
//   update: every (lane, row) unmarked whose reduced mark recv is set is
//   marked tag (recv: the seeds' marks before the first layer), and its
//   node's lane bit set in the known set;
//   expand: every destination v of a (lane, row) at level tag (reached by
//   the last reduce, so each row expands once a lane) that the known set
//   does not hold for that lane is added to it and marked in out,
//   owner-major (P owners, P lanes, rows) at [v % P, lane, v / P]: the
//   reduce-scatter's input, which returns each owner its rows' marks.  A
//   mark the rank knows of (its own rows' marks after the update, and what
//   it sent at an earlier layer or earlier in this one) changes nothing at
//   the owner, so it is not sent again; a destination that two edges of a
//   layer reach is marked once.  The owners' levels, and the counts, are
//   those of JAX's edge-parallel closure, which sends every edge.
// After the last layer, the count call updates once more and adds to
// counts[r] the lanes that reached row r.  The plain version is the
// edge-parallel form with the same known set.
//
// Replaces: xgnn_tpu/parallel/collocated.py, make_presample_static_exact_step
// (lines 741-884), its partitioned closure (the per-layer take, scatter-max
// and psum_scatter); its replicated form is the single-store kernel above
// for one lane, then one reduce by owner.
//
// What bounds it: bytes, and one known-set probe an edge.  The least a
// layer reads is the reached rows' indptr pairs and indices once (not once
// a lane), the level and recv bytes, the known set and out's bytes once;
// each reached edge asks, for its row's lanes at once, which the rank
// knows of (one word: a random probe, in L1 or L2).  At P = 1 a products
// batch's three layers expand 8,000 / 360,240 / 2,079,022 rows (404,075 /
// 24,558,626 / 98,991,135 edges): about 0.16 ms of bytes, and 124M probes.
// Design: two launches a layer (update, expand) and one memset of out.
//   update (a warp a tile of 32 rows): the new marks of each row's lanes;
//   their known bits (at P = 1 a ballot and one store a word); the hub
//   plan (a frontier row of more than kHub edges is cut into chunks of
//   kHub, a work unit each, with the row's lane mask); and a summary of the
//   known set, a bit for each group of 2^s words with any (node, lane) of
//   [0, num_node) unknown (s the least that keeps it within kSummaryBits).
//   The summary is read while the update sets bits: a group it calls known
//   is known either way, so it never hides a mark the rank must send.
//   expand (the summary in shared memory; a warp a tile or a hub chunk,
//   as many blocks as the card holds at once; a tile with no frontier row,
//   a bit the update wrote, is passed over without reading its levels):
//   a tile's rows with a lane at level tag give each row its lane mask (at
//   most 32 lanes: a bit each); their edges are flattened into one run of
//   coalesced, evict-first index reads, as the single store's tiles are,
//   each edge probed once for its row's lanes.  A closed tile (every row
//   expanded by an earlier layer or now, for every lane of the tile's
//   mask; no hub) whose frontier holds at least half its edges streams its
//   whole index run in 16-byte reads: the other rows' targets are all in
//   the known set already.  A probe: the summary bit (shared memory), then
//   the known word (through L1: a stale word only misses a mark of this
//   launch, and the repeated mark is the same); for the lanes it lacks, one
//   atomicOr that returns nothing and a byte of out each.  At P = 1, layer
//   3 finds almost every target known (2,447,294 of 2,449,029 nodes are
//   marked within 2 hops), so its probes stay in shared memory and its
//   tiles stream, as the single store's last layer does.
// Measured on that card (tools/time_presample.py, a products batch at
// P = 1, each call's launches by the profiler): 0.045 / 0.326 / 0.283 ms
// by layer and 0.009 the count, 0.66 a batch (the single store's K12b:
// 0.52); layer 1 is latency (its fixed passes over every row), the others
// the expand.
//
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

int grid_cap(int device) {
  int sms = 132;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms * (2048 / kThreads);
}

unsigned grid_for(long long items, int device) {
  const long long want = (items + kThreads - 1) / kThreads;
  const long long cap = grid_cap(device);
  return (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
}

__global__ void accumulate_kernel(int32_t* __restrict__ freq, int64_t num_node,
                                  const int32_t* __restrict__ ids, int64_t n,
                                  const int32_t* __restrict__ num_input) {
  const int64_t live = min(n, (int64_t)max(*num_input, 0));
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < live;
       i += stride) {
    const int32_t id = __ldg(ids + i);
    if (id >= 0 && (int64_t)id < num_node) atomicAdd(freq + id, 1);
  }
}

constexpr int kHub = 512;       // rows longer than this: chunks of it
constexpr int kUnroll = 4;      // a lane's index reads in flight
constexpr int kVecUnroll = 2;   // a lane's 16-byte reads in flight
constexpr int kSummaryBits = 1 << 18;  // 32 KB of shared memory
constexpr unsigned kClaim = 0x80u;     // a node claimed by the last layer

struct ClosureScratch {
  int64_t level_bytes, summary_words, hub_cap;
  int log2_group;
  int64_t visited_off, summary_off, count_off, hubs_off, zero_bytes, total;
};

int64_t pad16(int64_t b) { return (b + 15) / 16 * 16; }

ClosureScratch closure_layout(int64_t num_node, int64_t num_edge) {
  ClosureScratch c;
  c.level_bytes = pad16(num_node);
  c.log2_group = 2;
  while (((num_node + (1LL << c.log2_group) - 1) >> c.log2_group) >
         kSummaryBits)
    ++c.log2_group;
  const int64_t groups = (num_node + (1LL << c.log2_group) - 1) >>
                         c.log2_group;
  c.summary_words = (groups + 31) / 32;
  c.hub_cap = 2 * num_edge / kHub + 1;
  c.visited_off = c.level_bytes;
  c.summary_off = c.visited_off + pad16((num_node + 31) / 32 * 4);
  c.count_off = c.summary_off + pad16(c.summary_words * 4);
  c.hubs_off = c.count_off + 16;
  c.zero_bytes = c.hubs_off;
  c.total = c.hubs_off + c.hub_cap * 16;
  return c;
}

// The seeds' levels, and (plan) the hub chunks: (row, first, end) a chunk.
__global__ void closure_start_kernel(const int32_t* __restrict__ indptr,
                                     int64_t num_node,
                                     const int32_t* __restrict__ seeds,
                                     int64_t n, uint8_t* __restrict__ level,
                                     uint32_t* __restrict__ visited,
                                     bool plan, int4* __restrict__ hubs,
                                     int32_t* __restrict__ hub_count) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t items = plan && num_node > n ? num_node : n;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += stride) {
    if (i < n) {
      const int32_t id = __ldg(seeds + i);
      if (id >= 0 && (int64_t)id < num_node) {
        level[id] = 1;
        atomicOr(visited + (id >> 5), 1u << (id & 31));
      }
    }
    if (plan && i < num_node) {
      const int32_t lo = __ldg(indptr + i), hi = __ldg(indptr + i + 1);
      if (hi - lo > kHub) {
        const int parts = (hi - lo + kHub - 1) / kHub;
        const int32_t at = atomicAdd(hub_count, parts);
        for (int k = 0; k < parts; ++k)
          hubs[at + k] = make_int4((int32_t)i, lo + k * kHub,
                                   min(hi, lo + (k + 1) * kHub), 0);
      }
    }
  }
}

// An index read: evict-first (streamed once), ahead of the level bytes
// and the visited bits that the probes keep reading.
__device__ __forceinline__ int32_t index_at(const int32_t* p) {
  return __ldcs(p);
}

// Layer l's test of a target: below the last layer, mark it l + 2 where
// it is unmarked; at the last, claim it where its group is not known to be
// all marked and it is unmarked, and count it for the thread that claimed
// it first.
template <bool kLast>
__device__ __forceinline__ void visit(int32_t v, int64_t num_node,
                                      uint8_t* level, uint32_t* visited,
                                      uint8_t mark, const uint32_t* summary,
                                      int log2_group, int32_t* counts) {
  if (v < 0 || (int64_t)v >= num_node) return;
  if (kLast) {
    const uint32_t g = (uint32_t)v >> log2_group;
    if (!((summary[g >> 5] >> (g & 31)) & 1u)) return;
    if (level[v] != 0) return;
    const unsigned shift = ((unsigned)v & 3u) * 8u;
    const unsigned old = atomicOr(
        reinterpret_cast<unsigned*>(level) + ((unsigned)v >> 2),
        kClaim << shift);
    if (((old >> shift) & 0xffu) == 0) counts[v] += 1;
  } else {
    // a bit a node: the set fits the SM's L1 far better than the bytes; a
    // stale word only misses a mark of this launch, and the mark is the same
    const uint32_t bit = 1u << (v & 31);
    uint32_t* word = visited + ((uint32_t)v >> 5);
    if (*word & bit) return;
    atomicOr(word, bit);
    level[v] = mark;
  }
}

template <bool kLast>
__global__ void __launch_bounds__(kThreads)
closure_expand_kernel(const int32_t* __restrict__ indptr,
                      const int32_t* __restrict__ indices, int64_t num_node,
                      uint8_t* level, uint32_t* visited, uint8_t tag,
                      const uint32_t* summary_g,
                      int64_t summary_words, int log2_group,
                      const int4* __restrict__ hubs,
                      const int32_t* __restrict__ hub_count, bool aligned,
                      int32_t* __restrict__ counts) {
  extern __shared__ uint32_t summary[];
  __shared__ int32_t delta[kWarps][32];
  if (kLast) {
    for (int64_t i = threadIdx.x; i < summary_words; i += kThreads)
      summary[i] = summary_g[i];
    __syncthreads();
  }
  const uint8_t mark = tag + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = (num_node + 31) / 32;
  const int64_t units = tiles + *hub_count;
  const int64_t num_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t u = (int64_t)blockIdx.x * kWarps + warp; u < units;
       u += num_warps) {
    if (u >= tiles) {  // a hub chunk: [first, end) of one long row
      const int4 h = hubs[u - tiles];
      if (level[h.x] != tag) continue;
      for (int32_t base = h.y; base < h.z; base += 32 * kUnroll) {
        int32_t v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int32_t p = base + 32 * k + lane;
          v[k] = p < h.z ? index_at(indices + p) : -1;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          visit<kLast>(v[k], num_node, level, visited, mark, summary,
                       log2_group, counts);
      }
      continue;
    }
    const int64_t row = u * 32 + lane;
    const bool real = row < num_node;
    const uint8_t lv = real ? level[row] : 1;
    const bool in = real && lv == tag;
    if (__ballot_sync(kFull, in) == 0) continue;
    int32_t lo = 0, hi = 0;
    if (real) {
      lo = __ldg(indptr + row);
      hi = __ldg(indptr + row + 1);
    }
    int32_t deg = in ? hi - lo : 0;
    if (deg > kHub || deg < 0) deg = 0;  // a hub's chunks take it
    // A closed tile (every row in the frontier or expanded by an earlier
    // layer, so their targets are all marked already; no hub) whose
    // frontier holds at least half its edges streams its whole index
    // range.  A level past tag is a mark or a claim of this launch: such a
    // row must not expand, so its tile is not closed.
    if (aligned &&
        __all_sync(kFull, lv != 0 && lv <= tag && hi - lo <= kHub)) {
      const int32_t first = __shfl_sync(kFull, lo, 0);
      const int32_t end = __reduce_max_sync(kFull, real ? hi : 0);
      if (2 * (int32_t)__reduce_add_sync(kFull, (unsigned)deg) >=
          end - first) {
        for (int32_t base = first & ~3; base < end;
             base += 128 * kVecUnroll) {
          int4 x[kVecUnroll];
#pragma unroll
          for (int k = 0; k < kVecUnroll; ++k) {
            const int32_t p = base + 128 * k + 4 * lane;
            if (p + 4 <= end) {
              x[k] = __ldcs(reinterpret_cast<const int4*>(indices + p));
            } else {  // the run's last words: none past its end
              x[k] = make_int4(p < end ? __ldcs(indices + p) : -1,
                               p + 1 < end ? __ldcs(indices + p + 1) : -1,
                               p + 2 < end ? __ldcs(indices + p + 2) : -1,
                               -1);
            }
          }
#pragma unroll
          for (int k = 0; k < kVecUnroll; ++k) {
            const int32_t p = base + 128 * k + 4 * lane;
            const int32_t w[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (p + j >= first && p + j < end)
                visit<kLast>(w[j], num_node, level, visited, mark,
                             summary, log2_group, counts);
          }
        }
        continue;
      }
    }
    int32_t incl = deg;  // the tile's edges as one run: a scan of degrees
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int32_t total = __shfl_sync(kFull, incl, 31);
    const bool has = deg > 0;
    const unsigned nz = __ballot_sync(kFull, has);
    // the k-th row with edges: its index position less its run position
    if (has) delta[warp][__popc(nz & ((1u << lane) - 1))] = lo - (incl - deg);
    __syncwarp();
    for (int32_t base = 0; base < total; base += 32 * kUnroll) {
      int32_t v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int32_t b = base + 32 * k;
        // run position b + lane's row: the rows ending at or before b,
        // plus those ending in (b, b + lane]
        const int below = __popc(__ballot_sync(kFull, has && incl <= b));
        const int32_t d = incl - b - 1;
        const unsigned ends = __reduce_or_sync(
            kFull, has && d >= 0 && d < 31 ? 1u << d : 0u);
        const int32_t e = b + lane;
        v[k] = e < total
                   ? index_at(indices + e +
                              delta[warp][below +
                                          __popc(ends & ((1u << lane) - 1))])
                   : -1;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        visit<kLast>(v[k], num_node, level, visited, mark, summary,
                     log2_group, counts);
    }
    __syncwarp();
  }
}

// counts[v] += (level[v] != 0), four nodes a thread; with summary, also
// the bits of the groups that hold an unmarked node (summary zeroed).
__global__ void __launch_bounds__(kThreads)
closure_count_kernel(int32_t* __restrict__ counts,
                     const uint8_t* __restrict__ level, int64_t num_node,
                     uint32_t* __restrict__ summary, int log2_group) {
  const int lane = threadIdx.x & 31;
  const int64_t quads = (num_node + 3) / 4;
  const int64_t step = (int64_t)gridDim.x * kThreads;
  const uchar4* l4 = reinterpret_cast<const uchar4*>(level);
  int4* c4 = reinterpret_cast<int4*>(counts);
  for (int64_t q0 = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
       q0 < quads; q0 += step) {
    const int64_t q = q0 + lane;
    bool unmarked = false;
    if (q < quads) {
      if (4 * q + 3 < num_node) {
        const uchar4 m = __ldg(l4 + q);
        int4 c = c4[q];
        c.x += m.x != 0;
        c.y += m.y != 0;
        c.z += m.z != 0;
        c.w += m.w != 0;
        c4[q] = c;
        unmarked = !m.x || !m.y || !m.z || !m.w;
      } else {
        for (int64_t v = 4 * q; v < num_node; ++v) {
          counts[v] += level[v] != 0;
          unmarked |= level[v] == 0;
        }
      }
    }
    if (summary != nullptr) {
      // quad q is in group q >> (log2_group - 2); the warp's groups share
      // one summary word
      const int s = log2_group - 2;
      const int64_t g0 = q0 >> s;
      const unsigned bits = __reduce_or_sync(
          kFull, unmarked ? 1u << (int)((q >> s) - g0) : 0u);
      if (lane == 0 && bits)
        atomicOr(summary + (g0 >> 5), bits << (g0 & 31));
    }
  }
}

// K12b's partitioned form.  The known set's geometry and the expand's
// scratch: out (P * P * rows bytes), the hub count, the summary and a bit
// a tile of 32 rows with a frontier row (zeroed by one memset), then the
// hub chunks.
constexpr int kEThreads = 512;  // the expand's blocks: the summary a block
constexpr int kEWarps = kEThreads / 32;

struct PartsLayout {
  int log2_q, shift;
  int64_t known_words, summary_words, out_bytes, count_off, summary_off,
      tiles_off, zero_bytes, hubs_off, hub_cap, total;
};

PartsLayout parts_layout(int64_t rows, int parts, int64_t num_edge) {
  PartsLayout c;
  c.log2_q = 0;
  while ((1 << c.log2_q) < parts) ++c.log2_q;
  c.known_words = ((rows * parts << c.log2_q) + 31) / 32;
  c.shift = 0;
  while (((c.known_words + (1LL << c.shift) - 1) >> c.shift) > kSummaryBits)
    ++c.shift;
  c.summary_words =
      (((c.known_words + (1LL << c.shift) - 1) >> c.shift) + 31) / 32;
  c.out_bytes = pad16((int64_t)parts * parts * rows);
  c.count_off = c.out_bytes;
  c.summary_off = c.count_off + 16;
  c.tiles_off = c.summary_off + pad16(c.summary_words * 4);
  c.zero_bytes = c.tiles_off + pad16((rows + 1023) / 1024 * 4);
  c.hubs_off = c.zero_bytes;
  c.hub_cap = 2 * num_edge / kHub + 1;
  c.total = c.hubs_off + c.hub_cap * 16;
  return c;
}

// The update (and, kCount, the count; else the hub plan and the summary).
template <bool kCount>
__global__ void __launch_bounds__(kThreads)
closure_parts_update_kernel(const int32_t* __restrict__ indptr, int64_t rows,
                            int64_t num_node, int parts, int part,
                            int log2_q, uint8_t* __restrict__ level,
                            const uint8_t* __restrict__ recv, uint8_t tag,
                            uint32_t* known, int64_t known_words,
                            int32_t* __restrict__ counts, uint32_t* summary,
                            int shift, uint32_t* __restrict__ front_tiles,
                            int4* __restrict__ hubs,
                            int32_t* __restrict__ hub_count) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t span = (rows + 31) / 32 * 32;
  for (int64_t base = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
       base < span; base += stride) {
    const int64_t row = base + lane;
    const bool real = row < rows;
    unsigned fresh = 0, front = 0;
    int reached = 0;
    for (int l = 0; l < parts; ++l) {
      const int64_t at = l * rows + row;
      uint8_t lv = real ? level[at] : 0;
      if (real && lv == 0 && recv[at] != 0) {
        lv = tag;
        level[at] = tag;
        fresh |= 1u << l;
      }
      front |= (unsigned)(real && lv == tag) << l;
      reached += lv != 0;
    }
    if (parts == 1) {  // node = row: the warp's rows are one word
      const unsigned bits = __ballot_sync(kFull, fresh != 0);
      if (lane == 0 && bits) known[base >> 5] |= bits;
    } else if (fresh) {
      const int64_t b = (row * parts + part) << log2_q;
      atomicOr(known + (b >> 5), fresh << (b & 31));
    }
    if (kCount) {
      if (reached) counts[row] += reached;
      continue;
    }
    const bool any_front = __ballot_sync(kFull, front != 0) != 0;
    if (lane == 0 && any_front) {
      const int64_t tile = base >> 5;
      atomicOr(front_tiles + (tile >> 5), 1u << (tile & 31));
    }
    if (front) {
      const int32_t lo = __ldg(indptr + row), hi = __ldg(indptr + row + 1);
      if (hi - lo > kHub) {
        const int n = (hi - lo + kHub - 1) / kHub;
        const int32_t at = atomicAdd(hub_count, n);
        for (int k = 0; k < n; ++k)
          hubs[at + k] = make_int4((int32_t)row, lo + k * kHub,
                                   min(hi, lo + (k + 1) * kHub), (int)front);
      }
    }
  }
  if (kCount) return;
  // the summary: a warp reads 32 consecutive known words; a node's slot
  // holds Q bits, of which the first P are its lanes
  const int q = 1 << log2_q;
  const uint32_t lane_bits = parts == 32 ? kFull : (1u << parts) - 1u;
  uint32_t lanes_rep = 0;
  for (int b = 0; b < 32; b += q) lanes_rep |= lane_bits << b;
  const int64_t wspan = (known_words + 31) / 32 * 32;
  const int64_t last = ((num_node << log2_q) - 1) >> 5;  // the last word used
  for (int64_t w0 = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31);
       w0 < wspan; w0 += stride) {
    const int64_t w = w0 + lane;
    bool unknown = false;
    if (w <= last) {
      uint32_t valid = lanes_rep;
      if (w == last) {  // the slots of nodes past num_node do not count
        const int used = (int)((num_node << log2_q) - (last << 5));
        if (used < 32) valid &= (1u << used) - 1u;
      }
      unknown = (~known[w] & valid) != 0;
    }
    const unsigned bits = __ballot_sync(kFull, unknown);
    if (shift >= 5) {  // the warp's words lie in one group
      if (lane == 0 && bits) {
        const int64_t g = w0 >> shift;
        atomicOr(summary + (g >> 5), 1u << (g & 31));
      }
    } else {  // 32 >> shift groups of 2^shift words
      const int per = 1 << shift;
      const unsigned gmask = per == 32 ? kFull : (1u << per) - 1u;
      const bool any =
          lane < (32 >> shift) && ((bits >> (lane << shift)) & gmask) != 0;
      const unsigned groups = __ballot_sync(kFull, any);
      if (lane == 0 && groups) {
        const int64_t g0 = w0 >> shift;
        atomicOr(summary + (g0 >> 5), groups << (g0 & 31));
      }
    }
  }
}

// One probe: the lanes of v that the rank does not know of are added to
// the known set and marked in out.
__device__ __forceinline__ void visit_parts(
    int32_t v, unsigned lanes, int64_t num_node, int parts, int log2_q,
    const uint32_t* summary, int shift, uint32_t* known, int64_t rows,
    uint8_t* out) {
  if (v < 0 || (int64_t)v >= num_node) return;
  const int64_t b = (int64_t)v << log2_q;
  const int64_t w = b >> 5;
  const int64_t g = w >> shift;
  if (!((summary[g >> 5] >> (g & 31)) & 1u)) return;
  const unsigned sh = (unsigned)b & 31u;
  const unsigned send = lanes & ~(known[w] >> sh);
  if (send == 0) return;
  atomicOr(known + w, send << sh);
  if (parts == 1) {
    out[v] = 1;
    return;
  }
  const int64_t r = (uint32_t)v / (uint32_t)parts;
  const int64_t o = v - r * parts;
  for (unsigned m = send; m != 0; m &= m - 1)
    out[(o * parts + (__ffs(m) - 1)) * rows + r] = 1;
}

__global__ void __launch_bounds__(kEThreads)
closure_parts_expand_kernel(const int32_t* __restrict__ indptr,
                            const int32_t* __restrict__ indices,
                            int64_t rows, int64_t num_node, int parts,
                            int log2_q, const uint8_t* __restrict__ level,
                            uint8_t tag, uint32_t* known,
                            const uint32_t* __restrict__ summary_g,
                            int64_t summary_words, int shift,
                            const uint32_t* __restrict__ front_tiles,
                            const int4* __restrict__ hubs,
                            const int32_t* __restrict__ hub_count,
                            bool aligned, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t summary[];
  __shared__ int32_t delta[kEWarps][32];
  __shared__ unsigned lanes_of[kEWarps][32];
  for (int64_t i = threadIdx.x; i < summary_words; i += kEThreads)
    summary[i] = summary_g[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tiles = (rows + 31) / 32;
  const int64_t units = tiles + *hub_count;
  const int64_t num_warps = (int64_t)gridDim.x * kEWarps;
  for (int64_t u = (int64_t)blockIdx.x * kEWarps + warp; u < units;
       u += num_warps) {
    if (u >= tiles) {  // a hub chunk: [first, end) of one long row
      const int4 h = hubs[u - tiles];
      for (int32_t base = h.y; base < h.z; base += 32 * kUnroll) {
        int32_t v[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int32_t p = base + 32 * k + lane;
          v[k] = p < h.z ? index_at(indices + p) : -1;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k)
          visit_parts(v[k], (unsigned)h.w, num_node, parts, log2_q, summary,
                      shift, known, rows, out);
      }
      continue;
    }
    if (!((__ldg(front_tiles + (u >> 5)) >> (u & 31)) & 1u)) continue;
    const int64_t row = u * 32 + lane;
    const bool real = row < rows;
    unsigned front = 0, done = 0;  // lanes at tag; lanes at 1 .. tag
    if (real) {
      for (int l = 0; l < parts; ++l) {
        const uint8_t lv = level[l * rows + row];
        front |= (unsigned)(lv == tag) << l;
        done |= (unsigned)(lv != 0 && lv <= tag) << l;
      }
    }
    if (__ballot_sync(kFull, front != 0) == 0) continue;
    int32_t lo = 0, hi = 0;
    if (real) {
      lo = __ldg(indptr + row);
      hi = __ldg(indptr + row + 1);
    }
    int32_t deg = front ? hi - lo : 0;
    if (deg > kHub || deg < 0) deg = 0;  // a hub's chunks take it
    // A closed tile: every row expanded, now or by an earlier layer, for
    // every lane of the tile's mask, so the targets of the rows not in the
    // frontier are all in the known set; with no hub, and a frontier that
    // holds at least half its edges, it streams its whole index run.
    const unsigned all = __reduce_or_sync(kFull, front);
    if (aligned && __all_sync(kFull, !real || ((done & all) == all &&
                                              hi - lo <= kHub))) {
      const int32_t first = __shfl_sync(kFull, lo, 0);
      const int32_t end = __reduce_max_sync(kFull, real ? hi : 0);
      if (2 * (int32_t)__reduce_add_sync(kFull, (unsigned)deg) >=
          end - first) {
        for (int32_t base = first & ~3; base < end;
             base += 128 * kVecUnroll) {
          int4 x[kVecUnroll];
#pragma unroll
          for (int k = 0; k < kVecUnroll; ++k) {
            const int32_t p = base + 128 * k + 4 * lane;
            if (p + 4 <= end) {
              x[k] = __ldcs(reinterpret_cast<const int4*>(indices + p));
            } else {  // the run's last words: none past its end
              x[k] = make_int4(p < end ? __ldcs(indices + p) : -1,
                               p + 1 < end ? __ldcs(indices + p + 1) : -1,
                               p + 2 < end ? __ldcs(indices + p + 2) : -1,
                               -1);
            }
          }
#pragma unroll
          for (int k = 0; k < kVecUnroll; ++k) {
            const int32_t p = base + 128 * k + 4 * lane;
            const int32_t w[4] = {x[k].x, x[k].y, x[k].z, x[k].w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (p + j >= first && p + j < end)
                visit_parts(w[j], all, num_node, parts, log2_q, summary,
                            shift, known, rows, out);
          }
        }
        continue;
      }
    }
    int32_t incl = deg;  // the tile's edges as one run: a scan of degrees
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int32_t total = __shfl_sync(kFull, incl, 31);
    const bool has = deg > 0;
    const unsigned nz = __ballot_sync(kFull, has);
    // the k-th row with edges: its index position less its run position,
    // and its lanes
    if (has) {
      const int k = __popc(nz & ((1u << lane) - 1));
      delta[warp][k] = lo - (incl - deg);
      lanes_of[warp][k] = front;
    }
    __syncwarp();
    for (int32_t base = 0; base < total; base += 32 * kUnroll) {
      int32_t v[kUnroll];
      unsigned ln[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int32_t b = base + 32 * k;
        // run position b + lane's row: the rows ending at or before b,
        // plus those ending in (b, b + lane]
        const int below = __popc(__ballot_sync(kFull, has && incl <= b));
        const int32_t d = incl - b - 1;
        const unsigned ends = __reduce_or_sync(
            kFull, has && d >= 0 && d < 31 ? 1u << d : 0u);
        const int32_t e = b + lane;
        const int at = below + __popc(ends & ((1u << lane) - 1));
        v[k] = e < total ? index_at(indices + e + delta[warp][at]) : -1;
        ln[k] = e < total ? lanes_of[warp][at] : 0u;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        visit_parts(v[k], ln[k], num_node, parts, log2_q, summary, shift,
                    known, rows, out);
    }
    __syncwarp();
  }
}

// The expand's blocks that the card holds at once with smem bytes of
// summary each (the occupancy asked once a device and size).
int64_t expand_blocks(int device, size_t smem) {
  static int cached_device = -1;
  static size_t cached_smem = 0;
  static int64_t cached = 0;
  if (device != cached_device || smem != cached_smem) {
    int sms = 132, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, closure_parts_expand_kernel, kEThreads, smem);
    cached = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    cached_device = device;
    cached_smem = smem;
  }
  return cached;
}

}  // namespace

// The words of closure_parts' known set for rows local rows of parts
// parts, and the scratch bytes of an expand call over num_edge local edges
// (out, the hub count, the summary, the hub chunks).
extern "C" long long xg_closure_parts_known_words(long long rows,
                                                  int parts) {
  return parts_layout(rows, parts, 0).known_words;
}

extern "C" long long xg_closure_parts_scratch_bytes(long long rows,
                                                    int parts,
                                                    long long num_edge) {
  return parts_layout(rows, parts, num_edge).total;
}

// K12b's partitioned form.  indptr: (rows + 1,) int32 local offsets;
// indices: (num_edge,) their int32 global destinations; level, recv:
// (parts, rows) uint8; tag: this layer's mark (1 to 127); part: this
// rank's part; known: xg_closure_parts_known_words(rows, parts) uint32,
// updated in place.  scratch non-null (expand): 16-byte aligned,
// xg_closure_parts_scratch_bytes(rows, parts, num_edge) bytes, its first
// parts * parts * rows bytes out ((parts, parts, rows) uint8, zeroed here,
// then marked); counts non-null (count, scratch null): (rows,) int32,
// added to.  rows * parts >= num_node.  Returns cudaGetLastError() after
// the last launch.
extern "C" int xg_closure_parts(const void* indptr, const void* indices,
                                long long rows, long long num_node,
                                long long num_edge, int parts, int part,
                                void* level, const void* recv, int tag,
                                void* known, void* scratch,
                                long long scratch_bytes, void* counts,
                                int device, void* stream) {
  if (rows < 0 || num_node < 0 || num_edge < 0 || parts < 1 || parts > 32 ||
      part < 0 || part >= parts || rows * parts < num_node ||
      num_node > INT32_MAX || tag < 1 || tag > 127 ||
      (scratch == nullptr) == (counts == nullptr) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const PartsLayout c = parts_layout(rows, parts, num_edge);
  if (scratch != nullptr && scratch_bytes < c.total)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  uint8_t* lv = static_cast<uint8_t*>(level);
  const uint8_t* rc = static_cast<const uint8_t*>(recv);
  uint32_t* kn = static_cast<uint32_t*>(known);
  const int64_t span = (rows + 31) / 32 * 32;
  if (counts != nullptr) {
    closure_parts_update_kernel<true><<<grid_for(span, device), kThreads, 0,
                                        s>>>(
        ip, rows, num_node, parts, part, c.log2_q, lv, rc, (uint8_t)tag, kn,
        c.known_words, static_cast<int32_t*>(counts), nullptr, 0, nullptr,
        nullptr, nullptr);
    return (int)cudaGetLastError();
  }
  uint8_t* base = static_cast<uint8_t*>(scratch);
  int32_t* hub_count = reinterpret_cast<int32_t*>(base + c.count_off);
  uint32_t* summary = reinterpret_cast<uint32_t*>(base + c.summary_off);
  uint32_t* front_tiles = reinterpret_cast<uint32_t*>(base + c.tiles_off);
  int4* hubs = reinterpret_cast<int4*>(base + c.hubs_off);
  cudaMemsetAsync(base, 0, (size_t)c.zero_bytes, s);
  const int64_t wspan = (c.known_words + 31) / 32 * 32;
  closure_parts_update_kernel<false><<<grid_for(span > wspan ? span : wspan,
                                                device),
                                       kThreads, 0, s>>>(
      ip, rows, num_node, parts, part, c.log2_q, lv, rc, (uint8_t)tag, kn,
      c.known_words, nullptr, summary, c.shift, front_tiles, hubs,
      hub_count);
  // a persistent grid: no more blocks than the card holds at once, or the
  // last ones would run their shares after the others
  const size_t smem = (size_t)c.summary_words * 4;  // at most 32 KB
  const int64_t want = (span + kEThreads - 1) / kEThreads;
  const int64_t cap = expand_blocks(device, smem);
  closure_parts_expand_kernel<<<(unsigned)(want < cap ? want : cap),
                                kEThreads, smem, s>>>(
      ip, static_cast<const int32_t*>(indices), rows, num_node, parts,
      c.log2_q, lv, (uint8_t)tag, kn, summary, c.summary_words, c.shift,
      front_tiles, hubs, hub_count,
      reinterpret_cast<uintptr_t>(indices) % 16 == 0, base);
  return (int)cudaGetLastError();
}

// freq: (num_node,) int32, added to in place; ids: (n,) int32; num_input:
// a device int32 scalar.  Returns cudaGetLastError() after the launch.
extern "C" int xg_accumulate_freq(void* freq, long long num_node,
                                  const void* ids, long long n,
                                  const void* num_input, int device,
                                  void* stream) {
  if (n < 0 || num_node < 0 || num_node > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  accumulate_kernel<<<grid_for(n, device), kThreads, 0, s>>>(
      static_cast<int32_t*>(freq), num_node, static_cast<const int32_t*>(ids),
      n, static_cast<const int32_t*>(num_input));
  return (int)cudaGetLastError();
}

// The scratch bytes xg_closure_expand needs for a graph of num_node nodes
// and num_edge edges (the level bytes, the summary, the hub plan).
extern "C" long long xg_closure_scratch_bytes(long long num_node,
                                              long long num_edge) {
  return (long long)closure_layout(num_node, num_edge).total;
}

// indptr: (num_node + 1,) int32; indices: (num_edge,) int32; seeds: (n,)
// int32 (ids outside [0, num_node) ignored); scratch: at least
// xg_closure_scratch_bytes(num_node, num_edge) bytes, 16-byte aligned;
// counts: (num_node,) int32, 16-byte aligned, added to in place.  Returns
// cudaGetLastError() after the last launch.
extern "C" int xg_closure_expand(const void* indptr, const void* indices,
                                 long long num_node, long long num_edge,
                                 const void* seeds, long long n,
                                 int num_layer, void* scratch,
                                 long long scratch_bytes, void* counts,
                                 int device, void* stream) {
  if (n < 0 || num_node < 0 || num_node > INT32_MAX - 1 || num_edge < 0 ||
      num_edge > INT32_MAX - 256 || num_layer < 0 || num_layer > 126 ||
      reinterpret_cast<uintptr_t>(counts) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const ClosureScratch c = closure_layout(num_node, num_edge);
  if (scratch_bytes < c.total) return (int)cudaErrorInvalidValue;
  if (num_node == 0 || n == 0) return (int)cudaGetLastError();
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  uint8_t* base = static_cast<uint8_t*>(scratch);
  uint8_t* level = base;
  uint32_t* visited = reinterpret_cast<uint32_t*>(base + c.visited_off);
  uint32_t* summary = reinterpret_cast<uint32_t*>(base + c.summary_off);
  int32_t* hub_count = reinterpret_cast<int32_t*>(base + c.count_off);
  int4* hubs = reinterpret_cast<int4*>(base + c.hubs_off);
  const int32_t* ip = static_cast<const int32_t*>(indptr);
  const int32_t* ix = static_cast<const int32_t*>(indices);
  int32_t* cnt = static_cast<int32_t*>(counts);
  cudaMemsetAsync(base, 0, (size_t)c.zero_bytes, s);
  const bool plan = num_layer > 0;
  const bool aligned = reinterpret_cast<uintptr_t>(indices) % 16 == 0;
  closure_start_kernel<<<grid_for(plan && num_node > n ? num_node : n,
                                  device),
                         kThreads, 0, s>>>(
      ip, num_node, static_cast<const int32_t*>(seeds), n, level, visited,
      plan, hubs, hub_count);
  const unsigned warps_grid = grid_for((num_node + 31) / 32 * 32, device);
  for (int l = 0; l + 1 < num_layer; ++l)
    closure_expand_kernel<false><<<warps_grid, kThreads, 0, s>>>(
        ip, ix, num_node, level, visited, (uint8_t)(l + 1), nullptr, 0, 0,
        hubs, hub_count, aligned, cnt);
  closure_count_kernel<<<grid_for((num_node + 3) / 4, device), kThreads, 0,
                         s>>>(cnt, level, num_node, plan ? summary : nullptr,
                              c.log2_group);
  if (plan) {
    const size_t smem = (size_t)c.summary_words * 4;
    cudaFuncSetAttribute(closure_expand_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    closure_expand_kernel<true><<<warps_grid, kThreads, smem, s>>>(
        ip, ix, num_node, level, visited, (uint8_t)num_layer, summary,
        c.summary_words, c.log2_group, hubs, hub_count, aligned, cnt);
  }
  return (int)cudaGetLastError();
}
