#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card: the card's name and power limit, from nvidia-smi.
2. Build: every CUDA source of ``xgnn_tpu_torch/csrc`` with nvcc, in
   parallel, into ``build/xgnn_tpu_torch/``.
3. Main-path set-up: the products-scale synthetic graph on the card
   (2,449,029 nodes, 62M power-law draws symmetrised, 128 features, 47
   classes) and ``Engine.init()`` with ``bench.py``'s default config
   (GraphSAGE 3x256, khop3 fanout (15, 10, 5), batch 8000, direct extract,
   pipelined, capacities (8000, 133376, 1007360, 2449152)).
4. Kernels against their plain PyTorch versions at the shapes of one
   sampled batch: K2 (khop sampler) at the three layers' frontiers and K3
   (seeded dedup, its split form) at the two dedup calls, walked layer by
   layer as the sampler walks them, exact, each dedup followed by two more
   with other picks (K3 keeps state across calls) and its kernel launches
   per call counted by the profiler; the whole batch sampled through K2
   and K3 equal, block by block, to the same batch sampled through their plain
   versions from the same generator seed; K1 (row gather) on the
   direct-extract dst ids, as drawn and with 30% of them EMPTY, and on the
   label column at the seeds, exact; K4's mean form (SAGE's masked mean,
   divided in the kernel) forward at the three layers' shapes, exact, and
   its backward (given the forward's denominator, with the dst prefix's
   gradient) at the layer-1 and layer-2 shapes, rtol 1e-5 / atol 1e-5,
   the backward also equal bit for bit across two launches, with its
   longest segment (the most picks of one src row) printed; K7 (pick
   multiplicity) at the three layers as GCNConv calls it, the counts
   exact and GCN's weights bit-equal to torch.rsqrt, with the weights'
   three elementwise launches timed beside it and the parent build's time
   as tools/time_degree.py read it printed (``K7_PARENT_MS``); K4's sum
   form as GCN runs it,
   with K7's per-pick weights rsqrt(max(cnt, 1)): forward at the three
   layers (layer 2 over the 47-wide transformed table), exact, and
   backward without the prefix gradient at layers 1 and 2, at the same
   tolerances and bit-equal across two launches; K5 (GAT edge
   softmax) forward in shared mode at one head at
   layers 0 and 1 and at 8 heads at layers 0 and 1, and per head on the
   47-wide transformed table at layer 2, rtol/atol 1e-5; K5 backward at
   layer 0 (no table gradient) and layer 1 (1 and 8 heads each) and at
   layer 2,
   g_table and g_el_dst at rtol/atol 1e-4, g_proj by relative norm 1e-5,
   bit-equal across two launches; at one head (layers 1 and 2) the
   table's gradient, K4's sum over g_out weighted by the dst-row pass's a
   with the rank-1 term (sum g_pre) * u, bit-equal to the CPU plain
   version on every src row of at most 32 picks given the kernel's a and
   g_pre, and at layer 1 the dst prefix's gradient folded into that sum
   equal to g_table + g_el @ wl.T.  K8a (with-replacement draws) at the
   three layers' frontiers, uniform_wr and khop1, exact.  Then PinSAGE's
   engine is set up (walk W=4, L=3, restart 0.5, 5 neighbours, 2 layers,
   capacities calibrated from 2 batches): K9 (restart random walk with
   top-K visit counts) at its two layers' frontiers, exact, with its byte
   bound and its 32-byte-sector floor; a whole PinSAGE batch through K9
   and K3 equal to the plain path's; K4's mean form as PinSAGE runs it,
   with the walk's counts as weights: forward at both layers, exact, and
   backward with the prefix gradient at layer 1, at the same tolerances
   and bit-equal across two launches.  TF32 is off throughout.
5. Small reference: on a small graph the kernels' forward logits and loss
   agree with the plain path on the CPU for the same blocks and weights,
   for GraphSAGE, GCN, GAT at 1 and 8 heads, PinSAGE (its own walk
   blocks) and MLP; K6a (sum and mean) and K6b (8 heads of 4) on the card
   agree with their plain versions on the CPU, and the full-graph logits
   of GraphSAGE, GCN, GAT at 1 and 8 heads and PinSAGE with the CPU's.
6. Main path: GraphSAGE, then GCN 3x256 and GAT 3x256 at 1 and at 8 heads
   on the same configuration, then PinSAGE 2x256 on the walk above, MLP
   3x256 on the main configuration and GraphSAGE on khop1 sampling.  Each
   runs one warm-up epoch, then one counted epoch (25 steps) with the
   launch counters set to 0 just before it; every kernel of the path must have launched its expected count per
   step, and every loss must be finite.  Each path prints its edges
   aggregated per second and its peak device memory.  GraphSAGE then runs
   one unpipelined epoch (per-stage device-inclusive times); every path
   runs one profiled pipelined epoch (the device's busy time per step, its
   time by kernel, and the elementwise divisions').
7. Weighted sampling: the weighted products dataset through
   ``make_device_dataset(weighted=True)`` (timed; its prefix table and
   coarse CDF are 496 MB and 1.25 GB), its graph, features, labels and
   split equal to phase 3's, which it then replaces, every prefix row
   nondecreasing, and its tables close to the same functions run again
   (each timed; the coarse CDF exactly, the sums within 1e-6); K8b-prefix at the three layers' frontiers of
   one batch, walked through K3, exact, with the bytes of the rows it reads
   whole and of a coarse row for every live row, and its 32-byte-sector
   floor; the whole batch equal to the plain path's; then GraphSAGE 3x256
   on weighted_khop_prefix (the path ``graphsage_weighted_prefix``:
   warm-up, counted and profiled epochs as in 6), and the prefix tables
   freed.  Then alias tables for the same
   edge weights, built on the card by ``synthetic_device.alias_tables``
   (timed, with their peak memory) and held to the weights (every id's
   probability within 1e-6 of its row's largest): K8b-alias with and
   without dedup at the three frontiers of a batch of 8000, fanout (15,
   10, 5), exact, and one batch through ``Sampler.sample`` for each alias
   form, its launches counted and equal to the plain path's.  The same
   again on a graph of 2^16 nodes at products' mean degree with alias
   tables built on the host by ``synthetic.build_alias_tables`` (timed):
   its 40 MB of tables sit in the card's 50 MB L2, so its times say
   nothing of the products graph.
8. The tiered store: the pinned host-to-device ``copy_`` rate (512
   MiB), then ``Engine.init()`` at graphsage's configuration with
   ``cache_percentage=0.2`` and ``cache_policy="pre_sample"`` (one
   presample epoch through K12, the table pinned and mapped, the cache
   built by K11's all-miss form), after which the dataset's device copy of
   the features is dropped.  K3 at the last layer's dedup (non-direct
   extract, out_cap 2,449,152), exact; K11 on one sampled batch's input
   nodes, as drawn and with 30% EMPTY, and in its all-miss form (the
   cache's rows): its split (the hit and zero rows, the miss positions and
   ids, the counts) and its SMs' reads of the miss rows in place, each
   exact against its plain version, and the whole extract exact with
   equal hit and miss counts, timed with its bound: the larger of its HBM
   bytes and its miss bytes over PCIe gen 5 x16's rated rate (63.0 GB/s a
   direction; the measured copy rate printed beside it).  Their launches
   are those of the path's counted epoch, the cache build's those of the
   engine's init;
   K12 on the batch and K12b (the exact static closure) for one batch's
   three layers, exact; presample_static's ranking (a K12b launch a
   batch), each beside the parent build's time as tools/time_presample.py
   read it (``K12B_PARENT_MS``, ``K12B_PARENT_RANKING``).  Then the path ``graphsage_cached``: warm-up, counted,
   unpipelined and profiled epochs, with the epoch hit rate, misses and
   miss bytes a step, and how much of K11's time other kernels ran beside
   it.  Then two epochs of ``dynamic_cache`` (``graphsage_dynamic``: K12
   every step, a refresh at each epoch's end), its posmap moved and 200,000
   ids extracted after the refresh equal to the host table.
9. Full-graph inference: phase 6's trained graphsage 3x256, gcn, gat1,
   gat8 and pinsage 2x256 over every node of phase 3's graph (123,999,946
   edges; rows past ``HUB_CAP`` counted), each after a warm-up: the
   inference's wall time, device time and edges
   aggregated per second (edges times layers over the wall time), its
   launches (K6a or K6b once a layer, asserted), finite logits of
   (2449029, 47), its peak memory, the valid and test accuracy of
   ``evaluate_full`` and ``Engine.evaluate("valid")`` beside them.  At
   each layer shape, K6a (mean 128 and 256, GCN's sum 256 and 47) and K6b
   ((1, 256), (1, 47), (8, 32)) against their plain versions on the card
   within 1e-5 of the same aggregate of the terms' magnitudes (the bound
   of a sum in another order), bit-equal across two launches, timed with
   both bounds (distinct rows once; ``per_pick_bound_ms`` a row a pick;
   for K6b also ``sector_bound_ms``, each edge's row read as the 32-byte
   sectors it spans), the plain version and the library (cuSPARSE's
   ``torch.sparse.mm`` of a CSR of ones; for K6b a composition of torch
   ops), beside the same
   call over the graph without its hub rows and with every row on the
   rows kernel (no hub kernel).  The inference's device time and each K6
   call's come from CUDA events with the inference queued while the card
   sleeps (the card's time alone).
10. Tooling: ``device_loop`` (each step one replay of a captured CUDA
   graph) on graphsage and pinsage (a capturing epoch 0 and a counted
   epoch 1) and on gcn and gat1 (epoch 0), each against phase 6's host-loop
   epochs from the same seeds: every step's loss and accuracy within rtol
   1e-5 (bit-equal so far); the capturing epoch's wrapper calls those of
   two eager steps (the warm-up and the captured step) and a replayed
   epoch's none; the hand kernels' launches in a profiled epoch of replays,
   by name from the profiler's records, equal to those of a profiled
   host-loop epoch (as many eager steps) on the same engine (a pair that
   differs measured again, twice at most: the profiler drops a record now
   and then); the capture's time, the counted epoch beside the host loop's, the host's ms
   a step to queue a replay and the card's ms a step alone (the epoch's
   replays queued while the card sleeps), a profiled epoch's busy time and
   share, and peak memory with the graph's pool.  K3 captured at the main
   path's two dedup shapes and replayed three times with new picks, each
   equal to its plain version.  (The command lines run in phase 13.)
11. Training options, at bench.py's configuration with the options of
   its A/B switches: ``graphsage_bf16`` (``feat_dtype`` and
   ``compute_dtype`` "bfloat16"), its host loop and ``device_loop`` from
   the same seeds with per-step losses and accuracies equal bit for bit;
   ``graphsage_bf16_compute`` (``compute_dtype`` alone: the float32 table
   cast every step), its losses those of ``graphsage_bf16``;
   ``gcn_bf16``, ``pinsage_bf16``, ``mlp_bf16`` and
   ``graphsage_cached_bf16`` (a bfloat16 cache, the hit rate); and at
   float32 ``graphsage_remat``, whose per-step losses equal phase 6's
   graphsage host loop bit for bit (the same kernels in the same order;
   remat launches each convolution's forward again in the backward), and
   ``graphsage_adamw`` (weight decay 5e-4).  Every loss comparison of the
   phase is bit for bit.  ``agg_impl`` is not driven here: every value
   builds the same model (K4 computes each formulation), which the CPU
   tests hold.
   Each path runs a warm-up, a counted and a profiled epoch, its launches
   asserted, its busy ms a step and its peak memory printed beside its
   float32 path's.  The new kernel forms against their plain versions at
   the paths' shapes: K1 over the bfloat16 table at layer 0's dst ids,
   exact; K4's forward over it at layer 0 (the mean form, GCN's sum with
   K7's weights, PinSAGE's mean with the walk's counts), bit-equal; K11's
   reads rounding the misses into bfloat16 rows, exact, and the whole
   bfloat16 extract exact.
12. The tiered topology (``use_dist_graph``, ``dist_graph_percentage``
   0.85, the reference's large-graph setting): the weighted tables of
   phase 7's edge weights built again on the card, then
   ``make_tiered_topology`` (the hot prefix and its tables on the card,
   the whole CSR and tables pulled, pinned and mapped, timed).  At the
   three layers' frontiers of one batch walked through K3, K2, K8a (khop1;
   uniform_wr checked), K8b-prefix and K8b-alias with and without dedup,
   and K9 at PinSAGE's two layers, each tiered call (one launch over hot,
   cold and EMPTY rows, the cold ones read in place from host memory)
   exact against its plain version (the cold rows read on the host) and
   against the untiered kernel over the whole CSR at the same uniforms,
   timed beside that untiered call, with its cold rows, its cold sectors
   and its bound (the larger of its hot bytes over HBM and the distinct
   32-byte sectors of host memory its cold rows read, over PCIe), the
   same sectors over the card's measured ceilings for scattered mapped
   host reads of 32 and 128 bytes (``tools/host_reads.py``, run first),
   its device ms again with L2 flushed before each launch, for K2 and
   K8b-prefix the distinct sectors their own design reads, and for K8a and
   K9 the requests to host memory that their warp design sends in the
   model of ``tools/cold_requests.py``; a whole tiered batch and a
   batch of each alias form equal to the plain path's.  Then the paths
   ``graphsage_tiered``, ``graphsage_khop1_tiered``,
   ``graphsage_weighted_prefix_tiered`` and ``pinsage_tiered`` (warm-up,
   counted and profiled epochs, each busy ms a step beside its untiered
   path's), each through ``Engine.init``'s own tiered topology with its
   launches asserted; ``graphsage_tiered`` and ``pinsage_tiered`` again
   under ``device_loop``, epochs 0 and 1 per-step losses and accuracies
   equal to their host loop's bit for bit; and
   ``graphsage_auto_placement``: ``auto_placement`` at the largest of a
   few ``hbm_budget_gb`` at which the solver tiers the topology, the
   store tiered too and presampled through the tiered sampler, its epoch
   hit rate beside the presample's out-of-sample estimate; the
   ``{"tiered_topology": ...}`` JSON line.

13. Dataset files: phase 3's graph, features, labels and split written
   with ``save_dataset`` into a temporary directory (under ``/dev/shm``
   where it has room, else under ``tempfile``'s default; deleted at the
   end whatever happens), loaded with ``load_dataset`` (read-only maps)
   and every array held to phase 3's; graphsage at bench.py's
   configuration from the maps, epochs 0 and 1 per-step losses equal to
   phase 6's host loop bit for bit, its launches counted and an epoch
   profiled, the init's graph load and cache build beside phase 6's;
   graphsage_tiered at 0.85 from the maps, equal to phase 12's bit for
   bit, the file-backed CSR's pin and map beside phase 12's;
   ``xgnn-convert`` built by ``clib.convert_path()``, its
   ``create-weights`` and ``cache-by-degree`` run on the directory, then
   graphsage on ``weighted_khop`` from the files' alias tables (K8b-alias
   in training: its device ms a launch by layer from a profiled epoch) and
   graphsage_cached with ``cache_policy="degree"`` (the cache the ranking
   file's prefix); ``Engine.run()`` through the training command line on
   ``--dataset <name> --root-path <dir>`` (graphsage, 2 epochs, the valid
   accuracy each, a checkpoint each), a second engine resumed from the
   checkpoint with params and Adam state equal bit for bit, and the
   accuracy command line in a process of its own on that checkpoint, its
   valid accuracy equal to ``evaluate_full`` in this process; the JAX
   command line's ``--synthetic`` graph at its defaults (100,000 nodes,
   degree 15, signal 1.5) for two epochs, its test accuracy above 0.5;
   ``tests/test_hop2_task.py``'s contract on the card (graphsage at least
   0.10 above the MLP, between 0.55 and 0.95); and
   ``make_device_dataset(dedup=True)`` at phase 3's sizes (time, edges
   kept, peak memory; no self-loop and no repeated neighbour, checked on
   the card; features and labels equal to phase 3's).  The phase's wall
   time and the ``{"dataset_files": ...}`` JSON line.

14. The last single-card configurations.  GAT under bfloat16:
   ``gat1_bf16`` and ``gat8_bf16`` (``feat_dtype``) and
   ``gat1_bf16_compute`` (``compute_dtype``: the float32 table cast every
   step, its per-step losses those of ``gat1_bf16`` bit for bit), each a
   warm-up, a counted and a profiled epoch beside gat1's or gat8's
   (epoch, busy ms a step, peak memory), their launches counted; K5 over
   the bfloat16 table at layer 0's shape (1 and 8 heads), forward and the
   backward without a table gradient, bit-equal to the float32 kernels
   over the same values widened and held to the plain versions.  An F16
   feature file: phase 3's graph and its features rounded to float16
   written with ``save_dataset`` and the features rewritten as F16 (under
   ``/dev/shm`` where it has room; deleted at the end whatever happens)
   and loaded; ``graphsage_f16_files`` and ``gat1_f16_files`` from it,
   their per-step losses equal bit for bit to the same paths over a
   float32 table of the same values (``*_f16_widened``); K1, K4's mean
   and K5 over the float16 table at layer 0's shape against their plain
   versions; ``graphsage_cached_f16_files`` (cache 0.2, pre_sample: a
   float16 cache and host tier) beside graphsage_cached (hit rate, miss
   bytes a step, K11's reads' device ms) and K11's float16 reads exact;
   the accuracy command line over the directory (K6a's float16 form at
   layer 0 of both splits' inference, its launches counted), and K6a's
   float16 form at that shape against its plain version on the card
   (for each segment an f16 ulp of the row's aggregate of |h| times
   1/deg and two of the result: the plain version's atomics sum in
   another order) and bit for bit against the CPU's on every row past
   2048 edges and 20,000 others.  The phase's wall time and the
   ``{"last_configs": ...}`` JSON line.

15. The collocated multi-card engine (XGNN's arch6) at P = 1:
   ``MultiChipEngine`` in a world of one over NCCL at bench width.
   ``graphsage_multichip`` (``use_dist_graph``: the partitioned topology;
   ``part_cache``: the features and labels interleaved, all on the
   card): its first step's batch, loss and gradients against the
   single-store ``Engine``'s train step on that batch (its rows extracted
   by the single store, the same weights and dropout generator), rtol and
   atol 1e-5 (the seed-count weighting of the reduction is not bit-exact);
   K13-plan (``csrc/exchange.cu``) at the three layers' frontiers, walked
   as the partitioned sampler walks them, and at P = 2, 4 and 8 on the
   layer-2 frontier, bit-equal to its plain version (send, pick,
   overflow); a warm-up and a counted epoch with their launches asserted
   (K13 five times a step: three layers, the features, the labels), a
   profiled epoch beside phase 6's graphsage (busy ms a step, NCCL's
   collectives' and K13's device ms a step); then one counted epoch each
   of ``graphsage_multichip_replicated`` (the replicated topology),
   ``gcn_multichip`` and ``pinsage_multichip`` (the partitioned walk,
   capacities calibrated from 2 batches), with K9's count and ranking
   (``walk_topk``) at the walk's two layers against its plain version.
   The phase's wall time and the ``{"multichip": ...}`` JSON line.
16. XGNN's two-phase GGMS at P = 1: ``MultiChipEngine`` on the
   partitioned topology with phase 8's partial cache (0.2, ``pre_sample``,
   one presample epoch through the owner exchange and K12), every row in
   pinned, mapped host memory.  ``graphsage_multichip_ggms`` (the cache
   partitioned over the ranks, ``part_cache``): one batch's input rows
   (K11's position form, the positions' exchange with K13 and K1, K11's
   reads of the misses in place) bit-equal to the plain versions' rows,
   and K11's position form at that batch's frontier against its plain
   version, exact; ``graphsage_multichip_sgnn`` (the cache replicated on
   each rank: K11's split over it); ``graphsage_multichip_dynamic``
   (``dynamic_cache``: the refresh at each epoch's end ranks the cache by
   the next epoch's first batch, its hit rate before and after the
   first).  Each: a warm-up and a
   counted epoch with their launches asserted, then a profiled epoch (busy
   ms a step, K11's split and reads, K13 and NCCL, device ms a step) beside
   phase 8's graphsage_cached (its hit rate, miss bytes a step and K11's
   device ms).  The host table is the host's one shared copy (a host of
   one rank: a read-only ``/dev/shm`` mapping registered read-only,
   ``store/host_shared.py``); each path prints its bytes and this
   process's Rss and Pss of the mapping (``/proc/self/smaps``), and on the
   first batch K11's whole call runs over an anonymous pinned copy of the
   table and over the shared one in turns (device ms, the misses' rate),
   beside the kernel's transparent huge page settings as read.  The
   phase's wall time and the ``{"ggms": ...}`` JSON line.
17. The host cold tier under the partitioned topology and the exact
   presample_static over the cards, at P = 1 (MultiChipEngine over NCCL):
   ``graphsage_multichip_tiered`` (``use_dist_graph`` at phase 12's 0.85:
   the hot prefix partitioned, the whole CSR pinned and mapped, the cold
   rows drawn on the requesting rank by K2's cold form; bench.py's
   XGNN_BENCH_DIST_GRAPH=1 XGNN_BENCH_DIST_PCT=0.85 run) with K13-plan's
   hot mask and the cold form at the three layers' frontiers of one batch
   against their plain versions (the cold rows, their host sectors, the
   bound over PCIe and over the measured ceilings), then a warm-up, a
   counted and a profiled epoch beside graphsage_multichip (phase 15) and
   graphsage_tiered (phase 12), with each cold launch's device ms;
   ``pinsage_multichip_tiered`` (the walk's cold steps, K8a's cold form at
   fanout W and 1) likewise beside pinsage_multichip;
   ``graphsage_multichip_ggms_static`` (cache 0.2, presample_static: the
   exact closure, K12b's partitioned form a layer and a reduce by owner;
   its counts bit-equal to static_exact_ranking's over the same batches,
   its ranking time beside phase 8's, K12b's partitioned form against its
   plain version at each layer of a batch, its hit rate),
   ``graphsage_multichip_ggms_static_replicated`` (the replicated form: the
   single store's K12b and one reduce) and
   ``graphsage_multichip_ggms_static_tiered`` (the wide-khop approximation
   under the cold tier, its hit rate beside the exact ranking's).  The
   cold tier's CSR is the host's shared copy: each path prints its bytes
   and Rss and Pss.  The phase's wall time and the ``{"dist_cold": ...}``
   JSON line.
18. The multi-card ``device_loop`` at P = 1: ``graphsage_multichip``,
   ``graphsage_multichip_tiered`` (0.85) and ``pinsage_multichip`` with
   ``device_loop=True``, the rank's fused step (the NCCL collectives
   inside) captured and replayed once a step: the capturing epoch's
   wrapper calls (two eager steps' worth) and a replayed epoch's (none),
   the per-step losses and accuracies of epochs 0 and 1 bit-equal to
   phases 15 and 17's host loops on the same seeds, the capture time, the
   host ms to queue a replay, the card's ms alone, a profiled epoch of
   replays whose hand kernels by name equal a profiled host-loop epoch's
   on the same engine (within the records a session loses), and its
   device-to-device copies beside the host loop's.  The phase's wall time
   and the ``{"multichip_device_loop": ...}`` JSON line.
19. The disaggregated engine (arch5) with 1 sampler and 1 trainer sharing
   the card (bench.py's XGNN_BENCH_ARCH5=1): ``graphsage_arch5`` (every
   layer deduped, K1 over the trainer's input rows and labels) and
   ``graphsage_arch5_cached`` (cache 0.2, pre_sample presampled on the
   sampler: K11's split and reads, K1 for the labels), each a warm-up and
   a counted epoch with their launches asserted and a profiled epoch
   beside phase 6's graphsage and phase 8's graphsage_cached; the cached
   path's one host table for every trainer with its bytes, Rss and Pss,
   K11's device ms a step and the hit rate.  The phase's wall time and the
   ``{"arch5": ...}`` JSON line.
20. The multi-card placement solve at P = 1:
   ``graphsage_multichip_auto_placement``, ``MultiChipEngine`` with
   ``auto_placement`` for a group of one card, at the largest of phase 12's
   budgets at which the solver picks a partial cache and a cold tier, so
   that XGNN's two-phase GGMS and the host cold tier are its choice: the
   solved fields and the plan, a warm-up and a counted epoch with their
   launches asserted (K13-plan, K11's split and reads, K1, the cold form),
   a profiled epoch, the hit rate, beside phase 17's
   graphsage_multichip_tiered, and the shared host tier's bytes, Rss and
   Pss.  DCN groups need two cards or more (NCCL
   refuses two ranks on one card), so no DCN path runs here.  The phase's
   wall time and the ``{"auto_placement_multichip": ...}`` JSON line.

Each kernel is timed twice: ``ms`` back to back (the wrapper's host time
included, where the host is the slower) and ``device_ms`` with the host
ahead of the card (the card's time alone).  ``bound_ms`` reads each input
once: a gather over picks (K4 forward, K5) counts each distinct table row
of this batch once, and ``per_pick_bound_ms`` beside it a row per valid
pick; K4's mean form moves the sum form's bytes.  K4's mean-form
``library_ms`` is two calls, ``F.embedding_bag`` and the division.

Prints the inference's JSON line, the tooling's (phase 10), the training
options' (phase 11), the tiered topology's (phase 12), the dataset
files' (phase 13), the last configurations' (phase 14), the multi-card
engine's (phase 15), the two-phase GGMS's (phase 16), the cold tier's
and the exact presample's (phase 17), the multi-card device_loop's (phase
18), arch5's (phase 19), the multi-card placement solve's (phase 20),
the kernels' JSON line, then the
card's line (nvidia-smi's name and power limit), then the result line.
Exits non-zero with no result line when there is no CUDA device.
"""

import dataclasses
import json
import collections
import math
import os
import re
import subprocess
import sys
import time

NUM_NODE = 2_449_029
NUM_EDGE = 62_000_000  # power-law draws before symmetrising
FEAT_DIM = 128
NUM_CLASS = 47
BATCH = 8000
FANOUT = (15, 10, 5)
# bench.py's PinSAGE sampling (xgnn_tpu/config.py's walk defaults)
WALK = dict(num_random_walk=4, random_walk_length=3, restart_prob=0.5)
NUM_NEIGHBOR = 5
CAPS = (BATCH, 133376, 1007360, 2449152)
# K8b-alias's graph: 2^16 nodes at the products graph's mean degree (50.63),
# small enough for the host's alias build
ALIAS_NODES = 1 << 16
ALIAS_DRAWS = 1_659_000
# graphsage_cached: bench.py's XGNN_BENCH_CACHE_PCT=0.2 with its default
# policy (pre_sample, one presample epoch)
CACHE_PCT = 0.2
H2D_BYTES = 512 * 2**20  # the pinned host-to-device copy timed beside K11
# H100 SXM data sheet: PCIe gen 5 x16, a direction (32 GT/s a lane,
# 128b/130b line code)
PCIE_BYTES_PER_S = 16 * 32e9 * 128 / 130 / 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# K7 and K12b as they were before their redesign (commit 3d9a793), for the
# lines that print the redesigned kernels' times.  This script does not
# measure them: they are the medians that `tools/time_degree.py --root DIR`
# and `tools/time_presample.py --root DIR` (DIR a checkout of 3d9a793) read
# in turns with the redesigned kernels on an NVIDIA H100 80GB HBM3 at
# 700.00 W, the parent's readings that PERF.md's section 6 keeps in square
# brackets on the K7 and K12b rows; rerun the tools for a reading of the
# same card as this run
K7_PARENT_MS = ("0.1086", "0.0317", "0.0089")
K12B_PARENT_MS = "2.5412"
K12B_PARENT_RANKING = ("0.0632 s in tools/time_presample.py's loop; 0.072 s "
                       "in this phase at commit 3d9a793")
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = ATOL = 1e-5
# written before each launch that time_flushed_ms times: five times the
# H100's 50 MB L2
L2_FLUSH_BYTES = 256 * 2**20
# the tiered topology's share of the edges on the card (the reference's
# large-graph setting, evaluation/large_graph --use-dist-graph 0.85)
TIER_PCT = 0.85
# the tiered samplers' sources, by launch counter
SOURCES = {"sample_khop": "sampling.cu", "sample_wr": "sampling.cu",
           "sample_prefix": "weighted.cu", "sample_alias": "weighted.cu",
           "random_walk": "random_walk.cu"}
K5_BWD_TOL = 1e-4  # rtol and atol of K5's g_table and g_el_dst
# bench.py's default configuration, as RunConfig's fields
BENCH_CONFIG = dict(
    batch_size=BATCH, fanout=FANOUT, num_layer=len(FANOUT), num_hidden=256,
    model="graphsage", sample_type="khop3", cache_percentage=0.0,
    pipeline=True, agg_impl="loop", feat_dtype="float32",
    compute_dtype="float32", device_loop=False, frontier_capacities=CAPS,
    calibration_batches=0, remat=False,
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10, host_ahead: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` launches, after one warm-up, by CUDA
    events.  Back to back, the events read the host's enqueue where the
    host is slower than the card.  With ``host_ahead`` the card first sleeps
    until the host has queued every launch, so they read the card's time
    alone; the sleep grows until the host was ahead."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cycles = 20_000_000  # about 10 ms at the H100's clock
    while True:
        if host_ahead:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        # the card already past the start: the host was not ahead
        behind = host_ahead and start.query()
        torch.cuda.synchronize()
        if not behind:
            return start.elapsed_time(end) / reps
        if cycles > 2**34:
            raise RuntimeError("time_ms: the host never got ahead of the card")
        cycles *= 4


def time_flushed_ms(torch, fn, reps: int = 10) -> float:
    """Median time of ``fn`` alone over ``reps`` launches, each after a
    write of ``L2_FLUSH_BYTES`` that evicts the card's L2, by a pair of CUDA
    events around each launch, queued while the card sleeps so that the
    host is ahead.  Launches of one call back to back find in L2 what the
    last one read (mapped host memory too, which goes through L2); these
    read it anew, as a training step's fresh frontier does."""
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                          device="cuda")
    fn()
    torch.cuda.synchronize()
    events = [tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
              for _ in range(reps)]
    cycles = 20_000_000
    while True:
        torch.cuda._sleep(cycles)
        for start, end in events:
            scratch.fill_(1)
            start.record()
            fn()
            end.record()
        behind = events[0][0].query()
        torch.cuda.synchronize()
        if not behind:
            times = sorted(a.elapsed_time(b) for a, b in events)
            return (times[(reps - 1) // 2] + times[reps // 2]) / 2
        if cycles > 2**34:
            raise RuntimeError("time_flushed_ms: the host never got ahead "
                               "of the card")
        cycles *= 4


def host_tier_memory(arrays: dict) -> dict:
    """A host tier's arrays (``{name: MappedHostTensor}``): each one's
    bytes, whether it is the host's shared copy, and this process's Rss and
    Pss of the mapping that holds it (``/proc/self/smaps``), with the
    sums."""
    from xgnn_tpu_torch.store.host_shared import mapping_memory

    out = {"arrays": {}, "bytes": 0, "rss": 0, "pss": 0}
    for name, a in arrays.items():
        mem = mapping_memory(a.tensor.data_ptr())
        nbytes = a.tensor.numel() * a.tensor.element_size()
        out["arrays"][name] = {"bytes": nbytes,
                               "shared": a.shared is not None,
                               "rss": mem.get("rss"), "pss": mem.get("pss"),
                               "mapping": mem.get("path")}
        out["bytes"] += nbytes
        out["rss"] += mem.get("rss") or 0
        out["pss"] += mem.get("pss") or 0
    return out


def host_tier_text(ht: dict) -> str:
    return (f"{ht['bytes']} bytes in "
            + ", ".join(f"{n} ({'shared' if a['shared'] else 'anonymous'})"
                        for n, a in ht["arrays"].items())
            + f"; this process's Rss {ht['rss']}, Pss {ht['pss']} bytes")


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


DEVICE_LOOP_PATHS = ("graphsage", "pinsage", "gcn", "gat1")
# records that a profiled multi-card epoch may lose, by kernel name (phase
# 18): the first step's, at the session's start
LOST_RECORDS = 3
LOSS_RTOL = 1e-5  # device_loop against the host loop, step by step
LEAD_IN_KERNELS = 16  # torch.cuda._sleep's spin_kernel, before a profile


def hand_kernel_names() -> set:
    """The names of the kernels in ``xgnn_tpu_torch/csrc/*.cu`` (their
    ``__global__`` declarations)."""
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "xgnn_tpu_torch", "csrc")
    decl = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\("
                      r"(?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")
    names = set()
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                names.update(decl.findall(fh.read()))
    return names


def kernel_name(event_name: str) -> str:
    """A device event's function name without its namespace, template
    arguments and parameters (``void (anonymous namespace)::f<1>(int)`` is
    ``f``)."""
    n = event_name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void\s+", "", n)
    m = re.match(r"(?:\w+::)*(\w+)", n)
    return m.group(1) if m else n


def replays_queued(torch, dev, fused, gen_seeds):
    """A ``device_loop`` epoch's replays again (``gen_seeds``, a
    (sampling, dropout) pair a step), queued while the card sleeps: the
    card's ms for the epoch alone (its busy time: nothing idles between
    queued replays) and the host's ms a step to queue them."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cycles = 20_000_000
    while True:
        fused.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(fused.stream):
            fused.step.zero_()
            torch.cuda._sleep(cycles)
            start.record()
            t0 = time.perf_counter()
            for a, b in gen_seeds:
                fused.sample_gen.manual_seed(a)
                fused.dropout_gen.manual_seed(b)
                fused.graph.replay()
            host_s = time.perf_counter() - t0
            end.record()
            behind = start.query()
        torch.cuda.synchronize()
        if not behind:
            return start.elapsed_time(end), host_s * 1e3 / fused.steps
        if cycles > 2**34:
            raise RuntimeError("replays_queued: the host never got ahead")
        cycles *= 4


def phase_tooling(torch, tag, dev, ds, cfg, pin_cfg, steps, expected,
                  host_runs, profiled_epoch):
    """Phase 10: the device_loop paths against the host loop's epochs of
    phase 6 and K3 replayed under capture at the main path's dedup shapes
    (the command lines run in phase 13, on its dataset directory).  Returns
    the paths' rows for the JSON line."""
    import numpy as np

    from xgnn_tpu_torch import Engine
    from xgnn_tpu_torch.device import generator, seed_of
    from xgnn_tpu_torch.engine.engine import _DROPOUT, _SAMPLE
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.sampling import sample_khop0
    from xgnn_tpu_torch.ops.unique import (
        unique_seeded_split,
        unique_seeded_split_plain,
    )

    rows = {}
    configs = {"graphsage": cfg, "pinsage": pin_cfg,
               "gcn": dataclasses.replace(cfg, model="gcn"),
               "gat1": dataclasses.replace(cfg, model="gat", num_head=1)}

    def replays_alone(fused, epoch):
        return replays_queued(torch, dev, fused, [
            (seed_of(cfg.seed, _SAMPLE, epoch, i),
             seed_of(cfg.seed, _DROPOUT, epoch, i))
            for i in range(fused.steps)])

    for path in DEVICE_LOOP_PATHS:
        name = f"{path}_device_loop"
        host = host_runs[path]
        epochs = (0, 1) if path in ("graphsage", "pinsage") else (0,)
        # an eager step's wrapper calls (phase 6 counted `steps` of them)
        per_step = {k: n // steps for k, n in expected[path].items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eng = Engine(ds, dataclasses.replace(configs[path],
                                             device_loop=True)).init()
        start_gib = torch.cuda.memory_allocated(dev) / 2**30
        results = []
        for epoch in epochs:
            _build.LAUNCHES.reset()
            results.append(eng.train_epoch(epoch))
            torch.cuda.synchronize()
            counts = _build.LAUNCHES.snapshot()
            print(f"{tag} {name} epoch {epoch} ("
                  f"{'capture, then replays' if epoch == 0 else 'counted'}):"
                  f" {results[-1]['time']:.6f} s, loss "
                  f"{results[-1]['loss']:.4f}, wrapper calls {counts}",
                  flush=True)
            # the capturing epoch calls the wrappers for the eager warm-up
            # step and the captured step; a replay calls none
            want = ({k: 2 * n for k, n in per_step.items()} if epoch == 0
                    else {})
            if counts != want:
                raise AssertionError(f"{name} epoch {epoch}: wrapper calls "
                                     f"{counts} != {want}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        fused = eng._fused
        if fused is None or fused.graph is None:
            raise AssertionError(f"{name}: no captured step after "
                                 f"epoch {epochs[-1]}")
        capture_s = eng.profiler._init_items["device_loop_capture_time"]
        worst = {}
        for epoch in epochs:
            h, d = host["hist"][epoch], eng.history[epoch]
            for key in ("loss", "acc"):
                if not np.all(np.isfinite(d[key])):
                    raise AssertionError(f"{name} epoch {epoch}: {key} not "
                                         f"finite: {list(d[key])}")
                diff = float(np.max(np.abs(d[key] - h[key])))
                worst[key] = max(worst.get(key, 0.0), diff)
                if not np.allclose(d[key], h[key], rtol=LOSS_RTOL, atol=0):
                    raise AssertionError(
                        f"{name} epoch {epoch}: {key} differs from the host "
                        f"loop's by up to {diff}: {list(d[key])} against "
                        f"{list(h[key])}")
        card_ms, host_ms = replays_alone(fused, epochs[-1])
        # the hand kernels launched in a profiled epoch of `steps` replays
        # against those of a profiled host-loop epoch of `steps` eager
        # steps on the same engine, by name from the profiler's records.
        # A profiler session now and then drops a record (1 to 2 of 40
        # short sessions: tools/profiler_records.py), so a pair that
        # differs is measured again, twice at most; replays that launch
        # other kernels than the eager steps differ every time
        base = 3 if path == "graphsage" else 2
        for attempt in range(3):
            eng.config.device_loop = False
            eager = (profiled_epoch(f"{name} as the host loop", eng,
                                    10 + attempt) or {}
                     ).get("hand_kernel_launches")
            eng.config.device_loop = True
            prof = profiled_epoch(name, eng, base + attempt)
            replayed = (prof or {}).get("hand_kernel_launches")
            if eager and replayed == eager:
                break
            print(f"{tag} {name}: the replays launched {replayed} hand "
                  f"kernels by the profiler's records, the eager steps "
                  f"{eager} (attempt {attempt + 1} of 3)", flush=True)
        else:
            raise AssertionError(f"{name}: the replays' hand-kernel launches"
                                 " differ from the eager steps' in three "
                                 "pairs of profiled epochs")
        print(f"{tag} {name}: hand-kernel launches in {steps} replays (the "
              f"profiler's records) equal those of {steps} eager steps: "
              f"{replayed}", flush=True)
        host_prof = host.get("profiled") or {}
        dl_s = results[-1]["time"]
        row = {
            "capture_s": capture_s, "epochs_compared": list(epochs),
            "device_loop_epoch_s": dl_s, "host_loop_epoch_s": host["time"],
            "max_abs_loss_diff": worst["loss"],
            "max_abs_acc_diff": worst["acc"],
            "host_ms_per_step": host_ms,
            "card_alone_ms_per_step": card_ms / steps,
            "card_alone_share": card_ms / 1e3 / dl_s,
            "profiled_busy_ms_per_step": (prof or {}).get("busy_ms_per_step"),
            "profiled_busy_share": (prof or {}).get("busy_share"),
            "host_loop_busy_ms_per_step": host_prof.get("busy_ms_per_step"),
            "host_loop_busy_share": host_prof.get("busy_share"),
            "peak_gib": peak, "wrapper_calls_per_step": per_step,
            "hand_kernel_launches": replayed,
            "step_peak_gib": peak - start_gib,
            "host_loop_step_peak_gib": host["step_peak_gib"],
        }
        rows[name] = row
        print(f"{tag} {name}: capture {capture_s:.3f} s; epoch "
              f"{epochs[-1]} {dl_s:.6f} s against the host loop's "
              f"{host['time']:.6f} s (pipelined, the same seeds); per-step "
              f"loss and accuracy equal to the host loop's within rtol "
              f"{LOSS_RTOL} (largest differences {worst['loss']:.3e} and "
              f"{worst['acc']:.3e}); host {host_ms:.4f} ms a step to queue "
              f"a replay; card alone {card_ms / steps:.3f} ms a step "
              f"({card_ms / 1e3 / dl_s:.3f} of the epoch); profiled busy "
              f"{row['profiled_busy_ms_per_step']} ms a step, share "
              f"{row['profiled_busy_share']} (host loop "
              f"{row['host_loop_busy_ms_per_step']}, "
              f"{row['host_loop_busy_share']}); peak {peak:.3f} GiB, "
              f"{peak - start_gib:.3f} above what the engine held before "
              f"its epochs (the graph's pool included; the host loop's "
              f"{host['step_peak_gib']:.3f})", flush=True)
        del eng, fused
        torch.cuda.empty_cache()

    # K3 under capture at the main path's two dedup shapes: three replays,
    # each with new picks copied into the captured call's input
    graph = ds.graph
    seeds, n = next(Shuffler(ds.train_set, BATCH, seed=7).epoch_batches(0))
    frontier = torch.from_numpy(seeds).to(dev)
    num = torch.full((), n, dtype=torch.int32, device=dev)
    for layer, (k, cap) in enumerate(zip(FANOUT[:2], CAPS[1:3])):
        picks = [sample_khop0(graph.indptr, graph.indices, frontier, k,
                              generator=generator(dev, 100 * layer + i))
                 .reshape(-1) for i in range(4)]
        static = picks[0].clone()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):  # the state, made before capture
            unique_seeded_split(frontier, static, num, cap,
                                num_node=graph.num_node)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            out = unique_seeded_split(frontier, static, num, cap,
                                      num_node=graph.num_node)
        for i in range(1, 4):
            static.copy_(picks[i])
            g.replay()
            torch.cuda.synchronize()
            ref = unique_seeded_split_plain(frontier, static, num, cap)
            for o, r in zip(out, ref):
                if not torch.equal(o, r):
                    raise AssertionError(f"unique_seeded under capture, "
                                         f"layer {layer}, replay {i}: "
                                         "differs from its plain version")
        print(f"{tag} unique_seeded under capture, layer {layer} "
              f"({frontier.shape[0]} + {static.shape[0]} ids, out_cap "
              f"{cap}): three replays with new picks equal to the plain "
              "version", flush=True)
        frontier = out[0].clone()
        num = torch.clamp(out[1], max=cap)
        del g, out, picks, static

    return rows


def phase_dataset_files(torch, tag, dev, ds, cfg, steps, expected,
                        host_runs, init_items, profiled_epoch):
    """Phase 13: phase 3's products graph written as a dataset directory,
    loaded and trained from, on the whole table, on the tiered topology,
    on ``xgnn-convert``'s alias tables and degree ranking and through the
    two command lines; the JAX command line's ``--synthetic`` graph and
    the hop2 task learnt; the deduplicated device build at products
    scale.  The directory is deleted at the end, whatever happens.
    Returns the phase's row for the JSON line."""
    import contextlib
    import io
    import shutil
    import tempfile

    import numpy as np

    from xgnn_tpu_torch import (
        Dataset,
        Engine,
        RunConfig,
        load_dataset,
        make_device_dataset,
        save_dataset,
    )
    from xgnn_tpu_torch.clib import convert_path
    from xgnn_tpu_torch.examples import train as train_cli
    from xgnn_tpu_torch.inference import evaluate_full
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.synthetic import (
        make_synthetic_dataset,
        plant_hop2_task,
    )

    t_phase = time.perf_counter()
    row = {}
    # weighted_khop and weighted_khop_hash_dedup from the files' tables:
    # K8b-alias at every layer
    expected["graphsage_alias_files"] = {
        "sample_alias": 3 * steps, "unique_seeded": 2 * steps,
        "gather_rows": 2 * steps, "fanout_fwd": 3 * steps,
        "fanout_bwd": 2 * steps}
    expected["graphsage_alias_dedup_files"] = expected["graphsage_alias_files"]
    g = ds.graph
    name = "products_synth"
    # the files' bytes: the CSR, features, labels and sets, then
    # create-weights' three tables and a ranking
    need = (4 * (ds.num_node + 1) + 16 * g.num_edge
            + (4 * FEAT_DIM + 12) * ds.num_node)
    shm = (shutil.disk_usage("/dev/shm").free
           if os.path.isdir("/dev/shm") else 0)
    parent = "/dev/shm" if shm > need + 2**30 else None
    tmp = tempfile.mkdtemp(prefix="xgnn_chip_smoke_", dir=parent)
    free = shutil.disk_usage(tmp).free
    row["directory"] = {"under": parent or tempfile.gettempdir(),
                        "free_bytes": free, "bytes_needed": need}
    print(f"{tag} dataset files: a temporary directory under "
          f"{row['directory']['under']} ({free} bytes free; /dev/shm "
          f"{shm} free, the files need {need})", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(root, "build", "chip_smoke_ckpt")
    path = os.path.join(tmp, name)

    def quiet(fn, *args):
        """``fn(*args)`` with its stdout kept; the ``test_result:`` lines
        printed and parsed."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            out = fn(*args)
        lines = [ln for ln in buf.getvalue().splitlines()
                 if ln.startswith("test_result:")]
        for ln in lines:
            print(f"{tag}   {ln}", flush=True)
        return out, dict(ln[len("test_result:"):].split("=", 1)
                         for ln in lines)

    def epochs(path_name, eng, ref=None, counted=None, first=0):
        """Epochs ``first`` and ``first + 1``: their per-step losses equal
        ``ref``'s host loop bit for bit where given, the second counted
        against ``expected[counted]``."""
        out = []
        for epoch in (first, first + 1):
            _build.LAUNCHES.reset()
            r = eng.train_epoch(epoch)
            torch.cuda.synchronize()
            counts = _build.LAUNCHES.snapshot()
            losses = eng.history[epoch]["loss"]
            if not np.all(np.isfinite(losses)):
                raise AssertionError(f"{path_name} epoch {epoch}: a step "
                                     f"loss is not finite: {list(losses)}")
            if ref is not None:
                want = host_runs[ref]["hist"][epoch]["loss"]
                if not np.array_equal(losses, want):
                    raise AssertionError(
                        f"{path_name} epoch {epoch}: per-step losses "
                        f"{list(losses)} differ from {ref}'s {list(want)}")
            if epoch == first + 1 and counted and counts != expected[
                    counted]:
                raise AssertionError(f"{path_name}: launch counts {counts} "
                                     f"!= {expected[counted]}")
            r["launches"] = counts
            kind = "counted" if epoch > first else "warm-up"
            print(f"{tag} {path_name} epoch {epoch} ({kind}, pipelined): "
                  f"{r['time']:.3f} s, loss {r['loss']:.4f}, acc "
                  f"{r['train_acc']:.4f}"
                  + ("" if ref is None else
                     f", per-step losses equal {ref}'s bit for bit"),
                  flush=True)
            out.append(r)
        return out

    try:
        # (a) write, load and train graphsage
        host = {"indptr": g.indptr.cpu().numpy(),
                "indices": g.indices.cpu().numpy(),
                "feat": ds.feat.cpu().numpy(),
                "label": ds.label.cpu().numpy()}
        for key in ("train_set", "valid_set", "test_set"):
            host[key] = np.asarray(getattr(ds, key))
        src = Dataset(name=name, num_node=ds.num_node, num_edge=g.num_edge,
                      feat_dim=ds.feat_dim, num_class=ds.num_class, **host)
        t0 = time.perf_counter()
        save_dataset(src, path)
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(path, f))
                     for f in os.listdir(path))
        t0 = time.perf_counter()
        fds = load_dataset(path)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for key, want in host.items():
            got = getattr(fds, key)
            if got.shape != want.shape or not np.array_equal(got, want):
                raise AssertionError(f"dataset files: {key} differs from "
                                     "phase 3's")
        check_s = time.perf_counter() - t0
        print(f"{tag} dataset files: phase 3's graph ({ds.num_node} nodes, "
              f"{g.num_edge} edges, {FEAT_DIM} float32 features, labels and "
              f"the split) written in {write_s:.3f} s ({nbytes} bytes), "
              f"loaded (mapped) in {load_s:.4f} s; every array equal to "
              f"phase 3's ({check_s:.3f} s to read and compare); dtypes "
              f"indptr {fds.indptr.dtype}, feat {fds.feat.dtype}, label "
              f"{fds.label.dtype}", flush=True)
        del src, host
        row.update(write_s=write_s, load_s=load_s, check_s=check_s,
                   bytes=nbytes)
        paths = row["paths"] = {}

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = Engine(fds, cfg).init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        items, ref = eng.profiler._init_items, init_items["graphsage"]
        print(f"{tag} graphsage_files engine init: {init_s:.3f} s; "
              f"graph_load_time {items['graph_load_time']:.3f} s and "
              f"cache_build_time {items['cache_build_time']:.3f} s (the CSR "
              f"and the table from the maps to the card) against phase 6's "
              f"{ref['graph_load_time']:.3f} s and "
              f"{ref['cache_build_time']:.3f} s (built on the card); init "
              f"{ref['init_s']:.3f} s", flush=True)
        r = epochs("graphsage_files", eng, "graphsage", "graphsage")
        prof = profiled_epoch("graphsage_files", eng, 2) or {}
        paths["graphsage_files"] = {
            "init_s": init_s, "graph_load_s": items["graph_load_time"],
            "cache_build_s": items["cache_build_time"],
            "device_built_graph_load_s": ref["graph_load_time"],
            "device_built_cache_build_s": ref["cache_build_time"],
            "epoch_s": r[1]["time"],
            "device_built_epoch_s": host_runs["graphsage"]["time"],
            "busy_ms_per_step": prof.get("busy_ms_per_step"),
            "device_built_busy_ms_per_step": (host_runs["graphsage"].get(
                "profiled") or {}).get("busy_ms_per_step"),
            "losses_bit_equal": True}
        print(f"{tag} graphsage_files: counted epoch {r[1]['time']:.3f} s "
              f"against phase 6's {host_runs['graphsage']['time']:.3f} s; "
              f"profiled busy {prof.get('busy_ms_per_step')} ms a step "
              f"against phase 6's "
              f"{paths['graphsage_files']['device_built_busy_ms_per_step']}",
              flush=True)
        del eng

        # (b) the tiered topology from the files
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = Engine(fds, dataclasses.replace(
            cfg, use_dist_graph=True, dist_graph_percentage=TIER_PCT)).init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if eng._tier is None:
            raise AssertionError("graphsage_tiered_files: no tier")
        pinned = sum(a.tensor.numel() * a.tensor.element_size()
                     for a in eng._tier.csr.arrays.values())
        load_t = eng.profiler._init_items["graph_load_time"]
        ref_t = init_items["graphsage_tiered"]["graph_load_time"]
        print(f"{tag} graphsage_tiered_files engine init: {init_s:.3f} s; "
              f"graph load {load_t:.3f} s (the hot prefix to the card, the "
              f"file-backed CSR's {pinned} bytes copied, pinned and mapped) "
              f"against phase 12's {ref_t:.3f} s (from the card's CSR); hot "
              f"prefix {eng._tier.num_cache_node} of {fds.num_node} nodes",
              flush=True)
        r = epochs("graphsage_tiered_files", eng, "graphsage_tiered",
                   "graphsage_tiered")
        paths["graphsage_tiered_files"] = {
            "init_s": init_s, "graph_load_s": load_t,
            "device_built_graph_load_s": ref_t, "pinned_bytes": pinned,
            "epoch_s": r[1]["time"],
            "device_built_epoch_s": host_runs["graphsage_tiered"]["time"],
            "losses_bit_equal": True}
        del eng

        # (c) xgnn-convert's tables: K8b-alias in training, the degree
        # ranking's cache
        t0 = time.perf_counter()
        exe = convert_path()
        if exe is None:
            raise AssertionError("xgnn-convert: no C++ compiler to build it")
        build_s = time.perf_counter() - t0
        convert_s = {}
        for cmd in ("create-weights", "cache-by-degree"):
            t0 = time.perf_counter()
            done = subprocess.run([exe, cmd, path], capture_output=True,
                                  text=True, timeout=600)
            convert_s[cmd] = time.perf_counter() - t0
            if done.returncode != 0:
                raise AssertionError(f"xgnn-convert {cmd}: exit "
                                     f"{done.returncode}\n{done.stderr}")
        wds = load_dataset(path)
        for key in ("prob_table", "alias_table", "prob_prefix_table"):
            if getattr(wds, key) is None:
                raise AssertionError(f"create-weights wrote no {key}")
        ranking = wds.cache_rankings.get("degree")
        if ranking is None:
            raise AssertionError("cache-by-degree wrote no ranking")
        row["convert"] = {"build_s": build_s, **convert_s}
        print(f"{tag} xgnn-convert: built in {build_s:.3f} s; "
              f"create-weights {convert_s['create-weights']:.3f} s, "
              f"cache-by-degree {convert_s['cache-by-degree']:.3f} s on "
              f"{g.num_edge} edges", flush=True)

        for path_name, st in (
                ("graphsage_alias_files", "weighted_khop"),
                ("graphsage_alias_dedup_files", "weighted_khop_hash_dedup")):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            eng = Engine(wds, dataclasses.replace(cfg, sample_type=st)).init()
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            r = epochs(path_name, eng, None, path_name)
            prof = profiled_epoch(path_name, eng, 2) or {}
            alias = {k: v for k, v in (prof.get("sampler_ms") or {}).items()
                     if "alias" in k}
            if prof and not alias:
                raise AssertionError(f"{path_name}: the profiled epoch "
                                     "recorded no K8b-alias launch")
            # by instance (the hash-dedup form's draws a thread differ by
            # layer: the names sort in the layers' order), by place in a
            # step within an instance
            by_layer = [t for _, v in sorted(alias.items())
                        for t in v["ms_by_place"] or [v["ms_per_launch"]]]
            items = eng.profiler._init_items
            paths[path_name] = {
                "init_s": init_s, "graph_load_s": items["graph_load_time"],
                "cache_build_s": items["cache_build_time"],
                "epoch_s": r[1]["time"], "loss": r[1]["loss"],
                "busy_ms_per_step": prof.get("busy_ms_per_step"),
                "launches": r[1]["launches"],
                "k8b_alias_launches_per_step": (
                    r[1]["launches"]["sample_alias"] / steps),
                "k8b_alias_ms_by_layer": by_layer, "k8b_alias_ms": alias}
            print(f"{tag} {path_name} ({st} from create-weights' tables): "
                  f"init {init_s:.3f} s (graph load "
                  f"{items['graph_load_time']:.3f} s: the CSR and the three "
                  f"tables to the card, the coarse CDF built there; cache "
                  f"build {items['cache_build_time']:.3f} s); counted epoch "
                  f"{r[1]['time']:.3f} s, losses finite; "
                  f"{r[1]['launches']['sample_alias'] // steps} K8b-alias "
                  f"launches a step; profiled busy "
                  f"{prof.get('busy_ms_per_step')} ms a step; K8b-alias "
                  f"device ms a launch by layer {by_layer}", flush=True)
            del eng

        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eng = Engine(wds, dataclasses.replace(
            cfg, cache_percentage=CACHE_PCT, cache_policy="degree")).init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        store = eng.feature_source
        k = store.num_cache
        top = torch.from_numpy(np.array(ranking[:k])).to(dev).long()
        if not torch.equal(store.posmap[top], torch.arange(
                k, dtype=torch.int32, device=dev)):
            raise AssertionError("graphsage_cached_degree_files: the cache "
                                 "is not the ranking file's prefix")
        r = epochs("graphsage_cached_degree_files", eng, None,
                   "graphsage_cached")
        paths["graphsage_cached_degree_files"] = {
            "init_s": init_s, "cache_build_s": eng.init_times["cache_build"],
            "device_built_cache_build_s":
                init_items["graphsage_cached"]["cache_build"],
            "epoch_s": r[1]["time"], "hit_rate": r[1]["hit_rate"]}
        print(f"{tag} graphsage_cached_degree_files: the cache holds the "
              f"ranking file's first {k} rows; init {init_s:.3f} s, cache "
              f"build {eng.init_times['cache_build']:.3f} s (the mapped "
              f"table copied, pinned and mapped) against phase 8's "
              f"{init_items['graphsage_cached']['cache_build']:.3f} s; "
              f"epoch hit rate {r[1]['hit_rate']:.4f}", flush=True)
        del eng, store, wds
        torch.cuda.empty_cache()

        # (d) the command lines on the files: Engine.run() through the
        # training command line, its resume, and the accuracy command line
        # on its checkpoint
        shutil.rmtree(ckpt, ignore_errors=True)
        files = ["--dataset", name, "--root-path", tmp]
        t0 = time.perf_counter()
        first, _ = quiet(train_cli.main, files + [
            "--num-epoch", "2", "--report-acc", "1", "--pipeline",
            "--checkpoint-dir", ckpt])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        resumed = Engine(first.ds, first.config)
        out, _ = quiet(resumed.run)
        if out["epochs"]:
            raise AssertionError(f"the resumed run trained epochs "
                                 f"{[e['epoch'] for e in out['epochs']]}")
        state = lambda e: (list(e.model.parameters()) + e.opt.mu + e.opt.nu
                           + [e.opt.count])
        for a, b in zip(state(first), state(resumed)):
            if not torch.equal(a, b):
                raise AssertionError("the resumed params or Adam state "
                                     "differ from the checkpointed run's")
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-m", "xgnn_tpu_torch.examples.accuracy"]
            + files + ["--checkpoint-dir", ckpt], cwd=root,
            capture_output=True, text=True, timeout=300)
        acc_s = time.perf_counter() - t0
        if cli.returncode != 0:
            raise AssertionError(f"accuracy CLI exit {cli.returncode}:\n"
                                 f"{cli.stdout}\n{cli.stderr}")
        got = dict(line[len("test_result:"):].split("=")
                   for line in cli.stdout.splitlines()
                   if line.startswith("test_result:"))
        fds = first.ds
        ref = evaluate_full(first.model, fds.indptr, fds.indices, fds.feat,
                            fds.label, fds.valid_set)
        cli_valid = float(got["full_valid_acc"])
        if abs(cli_valid - ref) > 1e-4 + 2 / len(fds.valid_set):
            raise AssertionError(f"accuracy CLI valid {cli_valid} against "
                                 f"evaluate_full in this process {ref}")
        row["clis"] = {"train_s": run_s, "accuracy_s": acc_s,
                       "full_valid_acc": cli_valid}
        print(f"{tag} run(): two epochs and their valid accuracy through "
              f"the training command line on --dataset {name} --root-path "
              f"<dir> in {run_s:.3f} s (the load included); resumed at epoch "
              f"2 with params and Adam state equal bit for bit; the accuracy "
              f"command line on the checkpoint: "
              f"{'; '.join(cli.stdout.split())} "
              f"({acc_s:.3f} s, a process of its own), evaluate_full here "
              f"{ref:.6f}", flush=True)
        del first, resumed, fds
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) learning on the JAX command line's graph and the hop2 task
    t0 = time.perf_counter()
    eng, got = quiet(train_cli.main, ["--synthetic", "--num-epoch", "2",
                                      "--report-acc", "1"])
    synth_s = time.perf_counter() - t0
    test_acc = float(got["test_acc"])
    if not test_acc > 0.5:
        raise AssertionError(f"--synthetic: test accuracy {test_acc} after "
                             "two epochs (chance is 1/32)")
    row["synthetic"] = {"test_acc": test_acc, "s": synth_s,
                        "num_edge": eng.ds.num_edge}
    print(f"{tag} --synthetic at the JAX command line's defaults (100,000 "
          f"nodes, {eng.ds.num_edge} edges, degree 15, signal 1.5): two "
          f"epochs in {synth_s:.3f} s (the graph's build on the host "
          f"included), test accuracy {test_acc:.4f} (chance 1/32)",
          flush=True)
    del eng
    t0 = time.perf_counter()
    hop2 = plant_hop2_task(make_synthetic_dataset(
        num_node=20000, avg_degree=8, feat_dim=32, num_class=8, seed=3,
        planted_signal=1.0, train_frac=0.5), seed=4)
    accs = {}
    for model in ("graphsage", "mlp"):
        heng = Engine(hop2, RunConfig(
            batch_size=512, fanout=(5, 5, 5), num_layer=3, num_hidden=64,
            num_epoch=3, model=model, sample_type="khop3",
            cache_percentage=0.0, pipeline=False, lr=0.01, dropout=0.1,
            calibration_batches=2)).init()
        for epoch in range(3):
            r = heng.train_epoch(epoch)
        if not math.isfinite(r["loss"]):
            raise AssertionError(f"hop2 {model}: loss {r['loss']}")
        accs[model] = heng.evaluate("valid", max_batches=8)
        del heng
    sep = accs["graphsage"] - accs["mlp"]
    row["hop2"] = dict(accs, separation=sep, s=time.perf_counter() - t0)
    print(f"{tag} hop2 task (tests/test_hop2_task.py's sizes): valid "
          f"accuracy graphsage {accs['graphsage']:.4f}, mlp "
          f"{accs['mlp']:.4f}, separation {sep:.4f} (the contract: >= 0.10, "
          f"0.55 < graphsage < 0.95)", flush=True)
    if not (sep >= 0.10 and 0.55 < accs["graphsage"] < 0.95):
        raise AssertionError(f"hop2 contract: {accs}")

    # (f) the deduplicated build at products scale
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    dds = make_device_dataset(NUM_NODE, NUM_EDGE, FEAT_DIM, NUM_CLASS,
                              train_frac=0.08, seed=0, name=name)
    torch.cuda.synchronize()
    dedup_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    dg = dds.graph
    deg = (dg.indptr[1:] - dg.indptr[:-1]).long()
    rows_of = torch.repeat_interleave(
        torch.arange(dds.num_node, device=dev), deg,
        output_size=dg.num_edge)
    loops = int((dg.indices.long() == rows_of).sum())
    same_row = rows_of[1:] == rows_of[:-1]
    unsorted = int((same_row & (dg.indices[1:] <= dg.indices[:-1])).sum())
    if loops or unsorted:
        raise AssertionError(f"dedup build: {loops} self-loops, {unsorted} "
                             "repeated or unsorted neighbours")
    for key in ("feat", "label"):
        if not torch.equal(getattr(dds, key), getattr(ds, key).to(dev)):
            raise AssertionError(f"dedup build: {key} differs from phase "
                                 "3's")
    row["dedup"] = {"s": dedup_s, "edges": dg.num_edge,
                    "draws": 2 * NUM_EDGE, "peak_gib": peak}
    print(f"{tag} make_device_dataset(dedup=True) at phase 3's sizes: "
          f"{dedup_s:.3f} s, {dg.num_edge} edges kept of {2 * NUM_EDGE} "
          f"directed draws (phase 3 kept {g.num_edge} without dedup); no "
          f"row holds a self-loop or a repeated neighbour (checked on the "
          f"card); features and labels equal phase 3's; peak "
          f"{peak:.3f} GiB above what was held before", flush=True)
    del dds, dg, deg, rows_of, same_row
    torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t_phase
    print(f"{tag} phase 13 (dataset files) wall time {row['wall_s']:.3f} s",
          flush=True)
    return row


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.autograd import DeviceType
    from torch.nn import functional as F
    from torch.profiler import ProfilerActivity, profile

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine import Engine
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.ops import _build, random_walk, sampling, unique
    from xgnn_tpu_torch.ops.attend import (
        PER_HEAD,
        SHARED,
        _bwd_rows,
        attend_backward,
        attend_backward_plain,
        attend_forward,
        attend_forward_plain,
    )
    from xgnn_tpu_torch.ops.degree import (
        pick_multiplicity,
        pick_multiplicity_plain,
        weights_of,
    )
    from xgnn_tpu_torch.ops.fanout import (
        MEAN_EPS,
        fanout_backward,
        fanout_backward_plain,
        fanout_reduce,
        fanout_reduce_plain,
        masked_mean,
        masked_mean_plain,
    )
    from xgnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from xgnn_tpu_torch.ops.presample import (
        accumulate_freq,
        accumulate_freq_plain,
        closure_expand,
        closure_expand_plain,
    )
    from xgnn_tpu_torch.ops.tiered import (
        tiered_direct,
        tiered_direct_plain,
        tiered_extract,
        tiered_extract_plain,
        tiered_split,
        tiered_split_plain,
    )
    from xgnn_tpu_torch.ops.random_walk import (
        sample_random_walk,
        sample_random_walk_plain,
    )
    from xgnn_tpu_torch.ops.sampling import (
        HASH_DEDUP_ROUNDS,
        build_coarse_cdf,
        sample_khop0,
        sample_khop0_plain,
        sample_khop1,
        sample_khop1_plain,
        sample_uniform_wr,
        sample_uniform_wr_plain,
        sample_weighted_khop,
        sample_weighted_khop_hash_dedup,
        sample_weighted_khop_hash_dedup_plain,
        sample_weighted_khop_plain,
        sample_weighted_khop_prefix,
        sample_weighted_khop_prefix_plain,
    )
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import (
        Sampler,
        default_capacities,
        make_tiered_topology,
    )
    from xgnn_tpu_torch.store.placement import resolve_auto_placement
    from xgnn_tpu_torch.store.presample import static_exact_ranking
    from xgnn_tpu_torch.synthetic import build_alias_tables
    from xgnn_tpu_torch.tools import cold_requests, host_reads
    from xgnn_tpu_torch.synthetic_device import (
        alias_tables,
        edge_weights,
        prefix_table,
    )
    from xgnn_tpu_torch.types import Graph
    from xgnn_tpu_torch.ops.unique import (
        unique_seeded_split,
        unique_seeded_split_plain,
    )
    from xgnn_tpu_torch.train import loss_fn
    from xgnn_tpu_torch import inference as inference_mod
    from xgnn_tpu_torch.inference import evaluate_full, full_graph_inference
    from xgnn_tpu_torch.ops import spmm as spmm_ops
    from xgnn_tpu_torch.ops.spmm import (
        gat_aggregate_csr,
        gat_aggregate_csr_plain,
        inverse_degree,
        spmm_csr,
        spmm_csr_plain,
    )

    # plain versions are compared in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card -----------------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    tag = f"[{card}]"

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"{tag} build: {time.perf_counter() - t0:.3f} s wall for "
          f"{sorted(built) or 'nothing (already built)'}", flush=True)

    # ---- 3. main-path set-up -----------------------------------------------
    t0 = time.perf_counter()
    ds = make_device_dataset(NUM_NODE, NUM_EDGE, FEAT_DIM, NUM_CLASS,
                             train_frac=0.08, seed=0, name="products_synth",
                             dedup=False)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    print(f"{tag} graph: {ds.num_node} nodes, {ds.num_edge} edges, built in "
          f"{graph_s:.3f} s", flush=True)
    cfg = RunConfig(**BENCH_CONFIG)
    t0 = time.perf_counter()
    engine = Engine(ds, cfg).init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the init stages' times by path, for phase 13
    init_items = {"graphsage": dict(engine.profiler._init_items,
                                    init_s=init_s)}
    print(f"{tag} engine init: {init_s:.3f} s; "
          f"capacities {engine.sampler.capacities}", flush=True)

    # ---- 4. kernels against their plain versions ---------------------------
    seeds, n = next(Shuffler(ds.train_set, BATCH, seed=7).epoch_batches(0))
    seeds = torch.from_numpy(seeds).to(dev)
    batch = engine.sampler.sample(seeds, n, generator(dev, 7))
    b0, b1, b2 = batch.blocks
    feat = engine.feature_source.feat
    gen = generator(dev, 11)
    # the inputs of layers 1 and 2: (1,007,360, 256) and (133,376, 256)
    h1 = torch.randn((b0.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    h2 = torch.randn((b1.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    kernels = []

    def record(name, source, replaces, shape, err, tol, fn, plain, library,
               library_call, nbytes, flops, per_step, path="graphsage",
               pick_nbytes=None, plain_reps=10, bound=None):
        """``nbytes`` reads each distinct table row once; ``pick_nbytes``,
        where given, is the same traffic with a table row per valid pick,
        what a gather that keeps no row between picks moves
        (``per_pick_bound_ms``).  ``bound``, where given, is a ``(ms, by)``
        computed by the caller (K11's, over two links)."""
        ms = time_ms(torch, fn)
        plain_ms = time_ms(torch, plain, reps=plain_reps)
        device_ms = time_ms(torch, fn, host_ahead=True)
        lib_ms = None if library is None else time_ms(torch, library)
        b_ms, b_by = bound_ms(nbytes, flops) if bound is None else bound
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "launches": None,
            "launches_per_step": per_step, "max_abs_err": err,
            "tolerance": tol, "ms": ms, "kernel_ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_call": library_call, "path": path,
        })
        if pick_nbytes is not None:
            kernels[-1]["per_pick_bound_ms"] = bound_ms(pick_nbytes, flops)[0]
        print(f"{tag} {name} {shape}: max_abs_err {err:.3e} ({tol}); "
              f"kernel {ms:.4f} ms ({device_ms:.4f} ms on the card alone), "
              f"plain {plain_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)

    def max_err(a, b):
        return (float((a.detach().double() - b.detach().double()).abs().max())
                if a.numel() else 0.0)

    def sector_floor(indptr, frontier, draws, coalesced, tables=1,
                     whole_at=0):
        """A sampler call's 32-byte-sector floor, K8b-prefix's model: the
        in-order arrays (``coalesced`` bytes) once; a valid row's indptr
        pair as the sectors it spans (two where row % 8 == 7); ``draws`` (a
        row's, a tensor or an int) random reads into each of ``tables``
        edge-aligned tables, at most the row's sectors in each; a row of
        1 to ``whole_at`` entries read whole from one table instead (hash
        dedup's).  Stores the sector floor's ms in the last kernel's row
        and prints it beside the device ms."""
        ok = (frontier >= 0) & (frontier < indptr.shape[0] - 1)
        node = torch.where(ok, frontier, 0).long()
        start = indptr[node].long()
        deg = torch.where(ok, indptr[node + 1].long() - start, 0)
        row = torch.where(deg > 0, (start * 4 + deg * 4 - 1) // 32
                          - start * 4 // 32 + 1, 0)
        whole = (deg > 0) & (deg <= whole_at)
        reads = torch.where(whole, row, tables * torch.minimum(
            row, torch.as_tensor(draws, device=row.device).long()))
        nsec = (int(ok.sum()) + int((ok & (node % 8 == 7)).sum())
                + int(reads.sum()))
        k = kernels[-1]
        k["sector_bound_ms"] = bound_ms(coalesced + 32 * nsec, 0)[0]
        print(f"{tag} {k['name']} {k['shape'][:48]}: sector floor "
              f"{k['sector_bound_ms']:.4f} ms, "
              f"{k['sector_bound_ms'] / k['device_ms']:.2f} of the device "
              f"ms", flush=True)

    def assert_close(name, a, b, exact):
        ok = torch.equal(a, b) if exact else torch.allclose(
            a, b, rtol=RTOL, atol=ATOL)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {max_err(a, b)})")

    def assert_agg_close(name, a, b, mass):
        """K6's tolerance: within RTOL of the same aggregate of the terms'
        magnitudes (``mass``), the error bound of a sum taken in another
        order (the plain version's atomics, a hub row's parts)."""
        if not bool(((a - b).abs() <= RTOL * mass + 1e-7).all()):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {max_err(a, b)})")

    # K2 at each layer's frontier and K3 at each dedup, one batch walked
    # layer by layer as sampler._sample_minibatch walks it
    empty = torch.iinfo(torch.int32).max
    graph = engine.sampler.graph
    frontier = seeds
    num = torch.full((), n, dtype=torch.int32, device=dev)
    for layer, k in enumerate(FANOUT):
        u = torch.rand((frontier.shape[0], k), generator=gen, device=dev)
        nbr = sample_khop0(graph.indptr, graph.indices, frontier, k, u=u)
        ref = sample_khop0_plain(graph.indptr, graph.indices, frontier, k,
                                 u=u)
        torch.cuda.synchronize()
        assert_close("sample_khop", nbr, ref, exact=True)
        rows = int((frontier != empty).sum())
        picks = int((nbr != empty).sum())
        record("sample_khop", "xgnn_tpu_torch/csrc/sampling.cu",
               "xgnn_tpu/ops/sampling.py:144",
               f"layer {layer}: frontier {frontier.shape[0]} ({rows} valid) "
               f"x K={k}, {picks} picks", max_err(nbr, ref), "exact",
               lambda: sample_khop0(graph.indptr, graph.indices, frontier, k,
                                    u=u),
               lambda: sample_khop0_plain(graph.indptr, graph.indices,
                                          frontier, k, u=u),
               None, None,
               # frontier, two indptr entries per valid row, u, one index
               # per pick, the output
               nbytes=frontier.numel() * 4 + rows * 8 + u.numel() * 4
               + picks * 4 + nbr.numel() * 4,
               flops=0, per_step=3)
        sector_floor(graph.indptr, frontier, (nbr != empty).sum(1),
                     (frontier.numel() + u.numel() + nbr.numel()) * 4)
        # K8a on the same frontier and uniforms: graphsage_khop1's draw
        wr = sample_uniform_wr(graph.indptr, graph.indices, frontier, k, u=u)
        wr_ref = sample_uniform_wr_plain(graph.indptr, graph.indices,
                                         frontier, k, u=u)
        k1 = sample_khop1(graph.indptr, graph.indices, frontier, k, u=u)
        k1_ref = sample_khop1_plain(graph.indptr, graph.indices, frontier, k,
                                    u=u)
        torch.cuda.synchronize()
        assert_close("sample_wr (uniform_wr)", wr, wr_ref, exact=True)
        assert_close("sample_wr (khop1)", k1, k1_ref, exact=True)
        live = int((wr != empty).sum())  # k index loads per row of degree > 0
        for form, fn, plain, out, ref in (
                ("uniform_wr", sample_uniform_wr, sample_uniform_wr_plain,
                 wr, wr_ref),
                ("khop1", sample_khop1, sample_khop1_plain, k1, k1_ref)):
            record("sample_wr", "xgnn_tpu_torch/csrc/sampling.cu",
                   "xgnn_tpu/ops/sampling.py:"
                   + ("98" if form == "uniform_wr" else "130"),
                   f"{form}, layer {layer}: frontier {frontier.shape[0]} "
                   f"({rows} valid) x K={k}, {live} draws, "
                   f"{int((out != empty).sum())} picks kept",
                   max_err(out, ref), "exact",
                   lambda: fn(graph.indptr, graph.indices, frontier, k, u=u),
                   lambda: plain(graph.indptr, graph.indices, frontier, k,
                                 u=u),
                   None, None,
                   # as K2: frontier, indptr pairs, u, one index per draw,
                   # the output
                   nbytes=frontier.numel() * 4 + rows * 8 + u.numel() * 4
                   + live * 4 + out.numel() * 4,
                   flops=0, per_step=3, path="graphsage_khop1")
            sector_floor(graph.indptr, frontier, k,
                         (frontier.numel() + u.numel() + out.numel()) * 4)
        del wr, wr_ref, k1, k1_ref
        if layer == len(FANOUT) - 1:
            break
        cap = CAPS[layer + 1]
        picks = nbr.reshape(-1)

        def dedup(p):
            return unique_seeded_split(frontier, p, num, cap,
                                       num_node=graph.num_node)

        def dedup_plain(p):
            return unique_seeded_split_plain(frontier, p, num, cap)

        out, ref = dedup(picks), dedup_plain(picks)
        torch.cuda.synchronize()
        err = max(max_err(o, r) for o, r in zip(out, ref))
        for o, r in zip(out, ref):
            assert_close("unique_seeded", o, r, exact=True)
        # K3's table and bitmaps persist across calls: two more with other
        # picks of the same frontier
        for _ in range(2):
            other = sample_khop0(graph.indptr, graph.indices, frontier, k,
                                 generator=gen).reshape(-1)
            for o, r in zip(dedup(other), dedup_plain(other)):
                assert_close("unique_seeded (a later call)", o, r,
                             exact=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dedup(picks)
            torch.cuda.synchronize()
            # CUPTI may drop a short trace's last kernel records if it
            # stops at once
            time.sleep(0.2)
        per_call = sum(1 for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        state_bytes = unique.state(dev, graph.num_node).buf.numel() * 8
        print(f"{tag} unique_seeded layer {layer}: equal to the plain version "
              f"on three calls; {per_call} kernel launches per call "
              f"(profiler); state {state_bytes} bytes per stream", flush=True)
        ids = torch.cat([frontier, picks])  # the library call's input
        record("unique_seeded", "xgnn_tpu_torch/csrc/unique.cu",
               "xgnn_tpu/ops/unique.py:178",
               f"layer {layer}: {ids.shape[0]} ids (prefix "
               f"{frontier.shape[0]}), out_cap {cap}, {int(out[1])} unique",
               err, "exact",
               lambda: dedup(picks), lambda: dedup_plain(picks),
               lambda: torch.unique(ids, sorted=True, return_inverse=True),
               "torch.unique(sorted=True, return_inverse=True) on the "
               "concatenated ids; its id order differs (no seeded prefix)",
               # prefix and picks in, the picks' local ids and the unique
               # ids out (the state's own traffic is the design's cost, not
               # the function's)
               nbytes=ids.numel() * 4 + picks.numel() * 4 + cap * 4 + 8,
               flops=0, per_step=2)
        kernels[-1]["launches_per_call"] = per_call
        kernels[-1]["state_bytes"] = state_bytes
        frontier, num = out[0], torch.clamp(out[1], max=cap)
    del u, nbr, ref, ids, out, frontier, picks, other

    def assert_plain_batch(sampler, batch, module, name, plain, kernels_named,
                           batch_seeds=None, batch_n=None):
        """The whole batch sampled again with ``module.name`` and K3 swapped
        for their plain versions, from the same generator seed, equal to
        ``batch`` field by field (the main batch's seeds unless given)."""
        kernel_fns = getattr(module, name), unique.unique_seeded_split
        setattr(module, name, plain)
        unique.unique_seeded_split = (
            lambda prefix, picks, num_prev, out_cap, num_node=None:
            unique_seeded_split_plain(prefix, picks, num_prev, out_cap))
        try:
            plain_batch = sampler.sample(
                seeds if batch_seeds is None else batch_seeds,
                n if batch_n is None else batch_n, generator(dev, 7))
        finally:
            setattr(module, name, kernel_fns[0])
            unique.unique_seeded_split = kernel_fns[1]
        pairs = [(f"block {i} {f}", getattr(kb, f), getattr(pb, f))
                 for i, (kb, pb) in enumerate(zip(batch.blocks,
                                                  plain_batch.blocks))
                 for f in ("neigh", "weights", "num_dst", "num_src",
                           "dst_ids")]
        pairs += [(f, getattr(batch, f), getattr(plain_batch, f))
                  for f in ("input_nodes", "num_input", "overflow")]
        for what, a, b in pairs:
            if (a is None) != (b is None) or (a is not None
                                              and not torch.equal(a, b)):
                raise AssertionError(f"sampled batch: {what} through the "
                                     "kernels differs from the plain path")
        print(f"{tag} sampled batch: {len(pairs)} fields of "
              f"{len(batch.blocks)} blocks through {kernels_named} equal the "
              "plain path's", flush=True)

    assert_plain_batch(engine.sampler, batch, sampling, "sample_khop0",
                       sample_khop0_plain, "K2/K3")

    # K1 on the direct-extract layer's dst ids, and on the same ids with
    # 30% of them EMPTY (a frontier further below its capacity)
    width = feat.shape[1]
    sparse = b0.dst_ids.clone()
    sparse[torch.rand(sparse.shape, generator=gen, device=dev) < 0.3] = \
        torch.iinfo(torch.int32).max
    for ids in (b0.dst_ids, sparse):
        out, ref = gather_rows(feat, ids), gather_rows_plain(feat, ids)
        torch.cuda.synchronize()
        assert_close("gather_rows", out, ref, exact=True)
        n_valid = int(((ids >= 0) & (ids < feat.shape[0])).sum())
        safe = torch.where((ids >= 0) & (ids < feat.shape[0]), ids, 0)
        record("gather_rows", "xgnn_tpu_torch/csrc/gather.cu",
               "xgnn_tpu/ops/pallas_gather.py:85",
               f"{ids.shape[0]} ids ({n_valid} valid) x {tuple(feat.shape)} "
               "f32", max_err(out, ref), "exact",
               lambda: gather_rows(feat, ids),
               lambda: gather_rows_plain(feat, ids),
               lambda: torch.index_select(feat, 0, safe),
               "torch.index_select on the ids clamped into the table",
               nbytes=n_valid * width * 4 + ids.shape[0] * (width * 4 + 4),
               flops=0, per_step=2)
        del out, ref

    # K1 on the label column at the seeds (LabelSource.extract)
    lab = engine.label_source.label[:, None]
    out, ref = gather_rows(lab, seeds), gather_rows_plain(lab, seeds)
    torch.cuda.synchronize()
    assert_close("gather_rows", out, ref, exact=True)
    n_valid = int(((seeds >= 0) & (seeds < lab.shape[0])).sum())
    safe = torch.where((seeds >= 0) & (seeds < lab.shape[0]), seeds, 0)
    record("gather_rows", "xgnn_tpu_torch/csrc/gather.cu",
           "xgnn_tpu/ops/pallas_gather.py:85",
           f"labels: {seeds.shape[0]} ids ({n_valid} valid) x "
           f"{tuple(lab.shape)} int32", max_err(out, ref), "exact",
           lambda: gather_rows(lab, seeds),
           lambda: gather_rows_plain(lab, seeds),
           lambda: torch.index_select(lab, 0, safe),
           "torch.index_select on the ids clamped into the table",
           nbytes=n_valid * 4 + seeds.shape[0] * 8, flops=0, per_step=2)
    del out, ref

    def distinct_rows(nb, valid):
        """the table rows the valid picks read, each counted once"""
        return int(torch.unique(nb[valid]).numel())

    def fwd_case(h, blk, per_step, weights=None, path="graphsage",
                 wname="GCN weights", mean=False):
        """K4 forward: the sum form (GCN), or with ``mean`` the masked mean
        (SAGE, PinSAGE), whose library yardstick is two calls: the sum by
        F.embedding_bag, then the division by the clamped denominator."""
        nb = blk.neigh
        fn, plain = ((masked_mean, masked_mean_plain) if mean
                     else (fanout_reduce, fanout_reduce_plain))
        form = "mean" if mean else "sum"
        with torch.no_grad():
            s, d = fn(h, nb, weights)
            s_ref, d_ref = plain(h, nb, weights)
        torch.cuda.synchronize()
        assert_close(f"fanout_fwd {form}", s, s_ref, exact=True)
        assert_close("fanout_fwd denom", d, d_ref, exact=True)
        valid = (nb >= 0) & (nb < h.shape[0])
        picks, rows_read = int(valid.sum()), distinct_rows(nb, valid)
        clamped = torch.where(valid, nb, 0).long()
        msk = valid.float() if weights is None else valid.float() * weights
        den_lib = torch.clamp(msk.sum(1, keepdim=True), min=MEAN_EPS)
        f = h.shape[1]

        def library():
            out = F.embedding_bag(clamped, h, mode="sum",
                                  per_sample_weights=msk)
            return out / den_lib if mean else out

        # the ids (and weights) in, the sum or mean and the denominator out
        other = (nb.numel() * (4 if weights is None else 8)
                 + nb.shape[0] * (f + 1) * 4)
        with torch.no_grad():
            record("fanout_fwd", "xgnn_tpu_torch/csrc/fanout.cu",
                   "xgnn_tpu/models/gnn.py:"
                   + ("144-147 (masked_mean_stream over fanout_reduce, :62)"
                      if mean else "62"),
                   f"{form} form: {tuple(nb.shape)} picks ({picks} valid, "
                   f"{rows_read} distinct rows) over {tuple(h.shape)} f32"
                   + ("" if weights is None else f", {wname}"),
                   max(max_err(s, s_ref), max_err(d, d_ref)), "exact",
                   lambda: fn(h, nb, weights),
                   lambda: plain(h, nb, weights), library,
                   "F.embedding_bag(mode='sum', per_sample_weights=mask"
                   + ("" if weights is None else " * weights") + ")"
                   + (", then / clamp(denom, 1e-9) (two calls; denom "
                      "precomputed)" if mean else ""),
                   nbytes=rows_read * f * 4 + other,
                   pick_nbytes=picks * f * 4 + other,
                   flops=picks * f + (nb.shape[0] * f if mean else 0),
                   per_step=per_step, path=path)
        kernels[-1]["form"] = form

    fwd_case(feat, b0, 3, mean=True)
    fwd_case(h1, b1, 3, mean=True)
    fwd_case(h2, b2, 3, mean=True)

    def bwd_case(h, blk, weights=None, with_dst=True, path="graphsage",
                 wname="GCN weights", per_step=2, mean=True):
        """K4 backward: the gradient w.r.t. h of the fanout mean (SAGE's and
        PinSAGE's, given the forward's denominator) or, without ``mean``,
        of the sum (GCN's), and of the dst prefix h[:D] where ``with_dst``
        (SAGE's and PinSAGE's local-id blocks; GCN's weighted sum has no
        prefix term)."""
        nb = blk.neigh
        d, (rows, f) = nb.shape[0], h.shape
        g_out = torch.randn((d, f), generator=gen, device=dev)
        g_dst = (torch.randn((d, f), generator=gen, device=dev) if with_dst
                 else None)
        with torch.no_grad():
            den = masked_mean(h, nb, weights)[1] if mean else None
        args = (g_out, nb, weights, rows, g_dst, den)
        gh = fanout_backward(*args)
        again = fanout_backward(*args)
        ref = fanout_backward_plain(*args)
        torch.cuda.synchronize()
        assert_close("fanout_bwd", gh, ref, exact=False)
        if not torch.equal(gh, again):
            raise AssertionError("fanout_bwd: two launches on the same "
                                 "inputs differ")
        valid = (nb >= 0) & (nb < rows)
        picks = int(valid.sum())
        longest = int(torch.bincount(nb[valid].long(), minlength=rows).max())
        form = "mean" if mean else "sum"
        print(f"{tag} fanout_bwd {form} form {tuple(nb.shape)} into ({rows}, "
              f"{f}){'' if weights is None else ' with ' + wname}: longest "
              f"segment {longest} picks of one src row; two launches equal "
              "bit for bit", flush=True)
        hl = h.clone().requires_grad_(True)
        msk = valid.float() if weights is None else valid.float() * weights
        lib_out = F.embedding_bag(torch.where(valid, nb, 0).long(), hl,
                                  mode="sum", per_sample_weights=msk)
        if mean:
            lib_out = lib_out / torch.clamp(den, min=MEAN_EPS)
        if with_dst:
            lib_outs, lib_grads = (hl[:d], lib_out), (g_dst, g_out)
        else:
            lib_outs, lib_grads = (lib_out,), (g_out,)
        record("fanout_bwd", "xgnn_tpu_torch/csrc/fanout.cu",
               "xgnn_tpu/models/gnn.py:"
               + ("144-147 (masked_mean_stream over fanout_reduce, :62)"
                  if mean else "62"),
               f"{form} form: {tuple(nb.shape)} picks ({picks} valid) into "
               f"({rows}, {f}) f32 "
               + ("" if weights is None else f"with {wname}, ")
               + ("with the prefix gradient" if with_dst else "no prefix")
               + f"; longest segment {longest}",
               max_err(gh, ref),
               f"rtol {RTOL}, atol {ATOL}; bit-equal across launches",
               lambda: fanout_backward(*args),
               lambda: fanout_backward_plain(*args),
               lambda: torch.autograd.grad(lib_outs, hl, lib_grads,
                                           retain_graph=True),
               "torch.autograd.grad of "
               + ("(h[:D], " if with_dst else "(")
               + "F.embedding_bag(mode='sum', per_sample_weights=mask"
               + ("" if weights is None else " * weights") + ")"
               + (" / clamp(denom, 1e-9)" if mean else "") + ") w.r.t. h",
               # grad_out (and grad_dst, denom), neigh (and weights) in,
               # every grad_h row out
               nbytes=(2 if with_dst else 1) * d * f * 4
               + nb.numel() * (4 if weights is None else 8) + rows * f * 4
               + (d * 4 if mean else 0),
               flops=picks * f + (d * f if with_dst else 0)
               + (picks * f if mean else 0),
               per_step=per_step, path=path)
        kernels[-1]["longest_segment"] = longest
        kernels[-1]["form"] = form

    bwd_case(h1, b1)
    bwd_case(h2, b2)

    # K7 at each layer, as GCNConv calls it: the multiplicity of every pick
    # over the block and GCN's weights rsqrt(max(cnt, 1)), beside the
    # three elementwise launches the weights replace
    for layer, (blk, rows) in enumerate(((b0, feat.shape[0]),
                                         (b1, b0.dst_cap),
                                         (b2, b1.dst_cap))):
        nb = blk.neigh
        out, w = pick_multiplicity(nb, rows)
        ref, ref_w = pick_multiplicity_plain(nb, rows)
        torch.cuda.synchronize()
        assert_close("pick_multiplicity", out, ref, exact=True)
        assert_close("pick_multiplicity's weights", w, ref_w, exact=True)
        valid = (nb >= 0) & (nb < rows)
        spare = torch.where(valid, nb, rows).reshape(-1).long()
        record("pick_multiplicity", "xgnn_tpu_torch/csrc/degree.cu",
               "xgnn_tpu/ops/degree.py:31",
               f"layer {layer}: {tuple(nb.shape)} picks ({int(valid.sum())} "
               f"valid) over {rows} rows, counts and GCN's weights",
               max_err(out, ref), "exact; weights bit-equal to torch.rsqrt",
               lambda: pick_multiplicity(nb, rows),
               lambda: pick_multiplicity_plain(nb, rows),
               lambda: torch.bincount(spare, minlength=rows + 1)[spare],
               "torch.bincount(ids, minlength=N + 1)[ids] on the ids with "
               "the invalid ones moved to bin N (the counts alone)",
               # the ids in, the counts and the weights out
               nbytes=nb.numel() * 12, flops=0, per_step=3, path="gcn")
        apart_ms = time_ms(torch, lambda: weights_of(out), host_ahead=True)
        kernels[-1]["elementwise_weights_device_ms"] = apart_ms
        print(f"{tag} pick_multiplicity layer {layer}: the weights apart "
              f"(three elementwise launches) {apart_ms:.4f} ms on the card "
              f"alone; the parent's build (a memset and two kernels, counts "
              f"alone), not measured here: {K7_PARENT_MS[layer]} ms in "
              "tools/time_degree.py's turns", flush=True)
        del out, ref, w, ref_w, spare

    # K4 as GCNConv runs it: per-pick weights rsqrt(max(cnt, 1)) from K7;
    # forward aggregate first at layers 0 and 1 and transform first at
    # layer 2 (over the 47-wide transformed table: float lanes), backward
    # at layers 1 and 2 without a prefix gradient
    h2t = torch.randn((b1.dst_cap, NUM_CLASS), generator=gen, device=dev)
    for layer, (h, blk) in enumerate(((feat, b0), (h1, b1), (h2t, b2))):
        _, w = pick_multiplicity(blk.neigh, h.shape[0])
        fwd_case(h, blk, 3, weights=w, path="gcn")
        if layer:
            bwd_case(h, blk, weights=w, with_dst=False, path="gcn",
                     mean=False)
        del w

    def attend_library(table, nb, el, proj, mode):
        """index_select -> masked softmax -> bmm over the materialised
        picks: stock PyTorch ops for the same function"""
        d, k = nb.shape
        heads = el.shape[1]
        valid = (nb >= 0) & (nb < table.shape[0])
        rows = torch.index_select(table, 0, torch.where(valid, nb, 0)
                                  .reshape(-1)).view(d, k, -1)
        if mode == SHARED:
            score = rows @ proj
        else:
            rows = rows.view(d, k, heads, -1)
            score = (rows * proj).sum(-1)
        e = F.leaky_relu(el[:, None, :] + score, 0.2)
        a = torch.softmax(e.masked_fill(~valid[:, :, None], -math.inf), 1)
        a = torch.nan_to_num(a)
        if mode == SHARED:
            return torch.bmm(a.transpose(1, 2), rows)
        return torch.einsum("bkh,bkhd->bhd", a, rows)

    def attend_inputs(table, blk, heads, mode):
        """el_dst and proj for K5, with el_dst moved off leaky_relu's kink:
        where a pick's pre-activation lies within 1e-4 of 0, the kernel's
        and the plain version's float32 scores may fall on two sides of it,
        and their gradients then differ by the jump of the derivative (1
        against 0.2), as two correct subgradients."""
        nb = blk.neigh
        d, k = nb.shape
        el = torch.randn((d, heads), generator=gen, device=dev)
        if mode == SHARED:
            proj = 0.1 * torch.randn((table.shape[1], heads), generator=gen,
                                     device=dev)
        else:
            proj = 0.1 * torch.randn((heads, table.shape[1] // heads),
                                     generator=gen, device=dev)
        valid = (nb >= 0) & (nb < table.shape[0])
        rows = table[torch.where(valid, nb, 0).reshape(-1)]
        if mode == SHARED:
            score = rows @ proj
        else:
            score = (rows.view(d * k, heads, -1) * proj).sum(-1)
        score = score.view(d, k, heads)
        del rows
        for _ in range(3):
            near = (((el[:, None, :] + score).abs() < 1e-4)
                    & valid[:, :, None]).any(1)
            if not bool(near.any()):
                break
            el = el + 1e-3 * near
        return el, proj

    def attend_cost(table, nb, heads, mode):
        """valid picks, their mask, and multiply-adds per pick of one pass
        (a score or a payload): H * W shared, W per head"""
        valid = (nb >= 0) & (nb < table.shape[0])
        width = table.shape[1]
        return int(valid.sum()), valid, heads * width if mode == SHARED \
            else width

    k5_tol = f"rtol {RTOL}, atol {ATOL}"

    def attend_fwd_case(layer, table, blk, heads, mode, path):
        nb = blk.neigh
        el, proj = attend_inputs(table, blk, heads, mode)
        got = attend_forward(table, nb, el, proj, mode)
        ref = attend_forward_plain(table, nb, el, proj, mode)
        torch.cuda.synchronize()
        for what, a, b in zip(("out", "m", "s"), got, ref):
            assert_close(f"attend_fwd {what}", a, b, exact=False)
        picks, valid, per_pick = attend_cost(table, nb, heads, mode)
        rows_read = distinct_rows(nb, valid)
        out_numel = got[0].numel()
        # the ids, el_dst and proj in; out, m and s out
        other = (nb.numel() * 4 + el.numel() * 4 + proj.numel() * 4
                 + out_numel * 4 + 2 * el.numel() * 4)
        record("attend_fwd", "xgnn_tpu_torch/csrc/attend.cu",
               "xgnn_tpu/models/gnn.py:486",
               f"layer {layer}: {tuple(nb.shape)} picks ({picks} valid, "
               f"{rows_read} distinct rows) over {tuple(table.shape)} f32, "
               f"{heads} head(s), {mode}",
               max(max_err(a, b) for a, b in zip(got, ref)), k5_tol,
               lambda: attend_forward(table, nb, el, proj, mode),
               lambda: attend_forward_plain(table, nb, el, proj, mode),
               lambda: attend_library(table, nb, el, proj, mode),
               "index_select -> masked softmax -> bmm (stock PyTorch ops)",
               # each distinct row read once besides the rest; the score
               # and the payload: 2 flops per element of each
               nbytes=rows_read * table.shape[1] * 4 + other,
               pick_nbytes=picks * table.shape[1] * 4 + other,
               flops=4 * picks * per_pick, per_step=3, path=path)
        return el, proj, got

    def attend_bwd_case(layer, table, blk, heads, mode, need_table, path,
                        fwd):
        nb = blk.neigh
        el, proj, (out, m, s_) = fwd
        g_out = torch.randn(out.shape, generator=gen, device=dev)
        args = (g_out, table, nb, el, proj, m, s_, mode, need_table)
        got = attend_backward(*args)
        again = attend_backward(*args)
        ref = attend_backward_plain(*args)
        torch.cuda.synchronize()
        if any(a is not None and not torch.equal(a, b)
               for a, b in zip(got, again)):
            raise AssertionError("attend_bwd: two launches on the same "
                                 "inputs differ")
        # g_e is a difference of two W-term dot products: its float32
        # rounding (about 1e-5 at W = 256) survives the cancellation, and
        # g_table sums a src row's picks in another order
        for what, a, b in (("g_table", got[0], ref[0]),
                           ("g_el_dst", got[1], ref[1])):
            if a is not None and not torch.allclose(a, b, rtol=K5_BWD_TOL,
                                                    atol=K5_BWD_TOL):
                raise AssertionError(f"attend_bwd {what}: kernel disagrees "
                                     "with its plain version (max abs err "
                                     f"{max_err(a, b)})")
        rel = float((got[2].double() - ref[2].double()).norm()
                    / ref[2].double().norm())
        if not rel < 1e-5:
            raise AssertionError(f"attend_bwd g_proj: relative norm error "
                                 f"{rel} (tolerance 1e-5)")
        picks, valid, per_pick = attend_cost(table, nb, heads, mode)
        rows_read = distinct_rows(nb, valid)
        out_numel = out.numel()
        rows_n, width = table.shape
        # g_out, the ids, el_dst, m, s and proj in; g_el_dst, g_proj and
        # every g_table row out
        other = (out_numel * 4 + nb.numel() * 4 + 3 * el.numel() * 4
                 + 2 * proj.numel() * 4 + el.numel() * 4
                 + (rows_n * width * 4 if need_table else 0))
        count = torch.bincount(nb[valid].long(), minlength=rows_n)
        longest = int(count.max())
        print(f"{tag} attend_bwd layer {layer}: g_proj relative norm error "
              f"{rel:.3e}; longest segment {longest} picks of one src row; "
              "two launches equal bit for bit", flush=True)
        if heads == 1 and need_table:
            attend_one_head_sum(layer, args, got, count, width)
        leaves = [el.clone().requires_grad_(True),
                  proj.clone().requires_grad_(True)]
        tab = table.clone().requires_grad_(True) if need_table else table
        lib_out = attend_library(tab, nb, leaves[0], leaves[1], mode)
        wrt = ([tab] if need_table else []) + leaves
        record("attend_bwd", "xgnn_tpu_torch/csrc/attend.cu (with "
               "csrc/fanout.cu's segmented sum)",
               "xgnn_tpu/models/gnn.py:486",
               f"layer {layer}: {tuple(nb.shape)} picks ({picks} valid, "
               f"{rows_read} distinct rows) over {tuple(table.shape)} f32, "
               f"{heads} head(s), {mode}, "
               f"{'with' if need_table else 'without'} g_table; longest "
               f"segment {longest}",
               max(max_err(a, b) for a, b in zip(got[:2], ref[:2])
                   if a is not None),
               f"g_table and g_el_dst rtol/atol {K5_BWD_TOL} (the max abs "
               "err is theirs); g_proj relative norm 1e-5; bit-equal across "
               "launches",
               lambda: attend_backward(*args),
               lambda: attend_backward_plain(*args),
               lambda: torch.autograd.grad(lib_out, wrt, g_out,
                                           retain_graph=True),
               "torch.autograd.grad of index_select -> masked softmax -> "
               "bmm",
               # each distinct row read once besides the rest
               nbytes=rows_read * width * 4 + other,
               pick_nbytes=picks * width * 4 + other,
               # the score, g_out . payload, g_proj and the two terms of
               # the per-pick row: 5 multiply-adds per element
               flops=10 * picks * per_pick, per_step=3, path=path)
        kernels[-1]["longest_segment"] = longest
        kernels[-1]["g_proj_rel_err"] = rel

    def attend_one_head_sum(layer, args, got, count, width):
        """At one head the table's gradient is K4's segmented sum over
        g_out with weights a and the rank-1 term (sum g_pre) * u, from the
        dst-row pass's two floats a pick: given the kernel's a and g_pre,
        bit-equal to the CPU plain version on every src row of at most 32
        picks.  In shared mode the prefix's gradient g_el @ wl.T, folded
        into the sum, lands after the rest: the result equals g_table
        plus it, bit for bit."""
        g_out, table, nb, el, proj, m, s_, mode, _ = args
        g_el, _, a, g_pre, per_pick = _bwd_rows(*args)
        if per_pick is not None or a is None:
            raise AssertionError("attend_bwd at one head: a row a pick")
        u = proj[:, 0] if mode == SHARED else proj[0]
        cpu = [t.cpu() for t in (g_out.view(nb.shape[0], width), nb, a,
                                 g_pre, u)]
        ref = fanout_backward_plain(cpu[0], cpu[1], cpu[2], table.shape[0],
                                    c=cpu[3], u=cpu[4])
        short = (count <= 32).cpu()
        if not torch.equal(got[0].cpu()[short], ref[short]):
            raise AssertionError(f"attend_bwd layer {layer}: the src-row "
                                 "pass differs from its plain version on "
                                 "rows of at most 32 picks")
        what = (f"{tag} attend_bwd layer {layer}: the src-row pass bit-equal "
                f"to its plain version on {int(short.sum())} rows of at most "
                f"32 picks (of {short.numel()})")
        if mode == SHARED:
            wl = 0.1 * torch.randn(proj.shape, generator=gen, device=dev)
            folded = attend_backward(*args, wl=wl)[0]
            want = got[0].clone()
            want[:nb.shape[0]] += g_el @ wl.T
            if not torch.equal(folded, want):
                raise AssertionError(f"attend_bwd layer {layer}: the folded "
                                     "prefix differs from g_table + g_el @ "
                                     "wl.T")
            what += "; the folded prefix equals g_table + g_el @ wl.T"
        print(what, flush=True)

    # K5: layers 0 and 1 in shared mode at one head, layer 1 also at 8
    # heads, layer 2 per head on the 47-wide transformed table
    fwd0 = attend_fwd_case(0, feat, b0, 1, SHARED, "gat1")
    attend_bwd_case(0, feat, b0, 1, SHARED, False, "gat1", fwd0)
    del fwd0
    fwd0 = attend_fwd_case(0, feat, b0, 8, SHARED, "gat8")
    attend_bwd_case(0, feat, b0, 8, SHARED, False, "gat8", fwd0)
    del fwd0
    fwd1 = attend_fwd_case(1, h1, b1, 1, SHARED, "gat1")
    attend_bwd_case(1, h1, b1, 1, SHARED, True, "gat1", fwd1)
    fwd1 = attend_fwd_case(1, h1, b1, 8, SHARED, "gat8")
    attend_bwd_case(1, h1, b1, 8, SHARED, True, "gat8", fwd1)
    fwd2 = attend_fwd_case(2, h2t, b2, 1, PER_HEAD, "gat1")
    attend_bwd_case(2, h2t, b2, 1, PER_HEAD, True, "gat1", fwd2)
    del fwd1, fwd2, h2t
    torch.cuda.empty_cache()
    del h1, h2, batch, b0, b1, b2

    # PinSAGE: bench.py's walk, capacities calibrated from 2 batches
    pin_cfg = dataclasses.replace(
        cfg, model="pinsage", sample_type="random_walk",
        num_neighbor=NUM_NEIGHBOR, num_layer_pinsage=2,
        num_random_walk=WALK["num_random_walk"],
        random_walk_length=WALK["random_walk_length"],
        random_walk_restart_prob=WALK["restart_prob"],
        frontier_capacities=None, calibration_batches=2,
    )
    t0 = time.perf_counter()
    pin_engine = Engine(ds, pin_cfg).init()
    torch.cuda.synchronize()
    pin_caps = pin_engine.sampler.capacities
    print(f"{tag} pinsage engine init (2 calibration batches): "
          f"{time.perf_counter() - t0:.3f} s; capacities {pin_caps}",
          flush=True)
    num_walk, walk_len = WALK["num_random_walk"], WALK["random_walk_length"]
    restart = torch.tensor(WALK["restart_prob"], dtype=torch.float32)

    def walk_traffic(frontier, u):
        """What K9 must move for this frontier and these uniforms: the
        frontier, the uniforms it reads (not u_restart[0]), an indptr pair
        for each walker-step from a node and an index for each step from a
        node of degree > 0, and the output.  Returns those bytes, the same
        with each random read a 32-byte sector (an indptr pair spans two
        when v % 8 == 7), and the two step counts."""
        u_step, u_restart = u
        ip, ix = graph.indptr, graph.indices
        seed = frontier[:, None].expand(-1, num_walk)
        cur, on, live, straddle = seed, 0, 0, 0
        for step in range(walk_len):
            if step:
                cur = torch.where(u_restart[step] < restart, seed, cur)
            ok = (cur >= 0) & (cur < graph.num_node)
            node = torch.where(ok, cur, 0)
            start = ip[node]
            deg = torch.where(ok, ip[node + 1] - start, 0)
            off = torch.minimum(torch.floor(u_step[step] * deg).int(),
                                torch.clamp(deg - 1, min=0))
            nxt = torch.where(deg > 0, ix[torch.where(deg > 0, start + off,
                                                      0)], empty)
            on += int(ok.sum())
            live += int((deg > 0).sum())
            straddle += int((ok & (node % 8 == 7)).sum())
            cur = torch.where(nxt == empty, seed, nxt)
        b = frontier.numel()
        fixed = (b * 4 + (2 * walk_len - 1) * b * num_walk * 4
                 + b * NUM_NEIGHBOR * 8)
        return (fixed + on * 8 + live * 4,
                fixed + 32 * (on + straddle + live), on, live)

    def walk_case(layer, frontier):
        b = frontier.shape[0]
        u = random_walk.draw_uniforms(num_walk, walk_len, b, gen, dev)
        got = sample_random_walk(graph.indptr, graph.indices, frontier,
                                 NUM_NEIGHBOR, u=u, **WALK)
        ref = sample_random_walk_plain(graph.indptr, graph.indices, frontier,
                                       NUM_NEIGHBOR, u=u, **WALK)
        torch.cuda.synchronize()
        assert_close("random_walk neigh", got[0], ref[0], exact=True)
        assert_close("random_walk weights", got[1], ref[1], exact=True)
        nbytes, sector_bytes, on, live = walk_traffic(frontier, u)
        rows, m = int((frontier != empty).sum()), num_walk * walk_len
        record("random_walk", "xgnn_tpu_torch/csrc/random_walk.cu",
               "xgnn_tpu/ops/random_walk.py:38",
               f"layer {layer}: frontier {b} ({rows} valid), W={num_walk} "
               f"L={walk_len} p={WALK['restart_prob']} K={NUM_NEIGHBOR}; "
               f"{on} walker-steps from a node, {live} index reads, "
               f"{int((got[0] != empty).sum())} picks kept",
               max(max_err(a, r) for a, r in zip(got, ref)), "exact",
               lambda: sample_random_walk(graph.indptr, graph.indices,
                                          frontier, NUM_NEIGHBOR, u=u,
                                          **WALK),
               lambda: sample_random_walk_plain(graph.indptr, graph.indices,
                                                frontier, NUM_NEIGHBOR, u=u,
                                                **WALK),
               None, None, nbytes=nbytes,
               # the count and the rank: 2 M^2 integer compares a seed
               flops=2 * m * m * rows, per_step=2, path="pinsage")
        kernels[-1]["sector_bound_ms"] = bound_ms(sector_bytes, 0)[0]
        return got

    # K9 at layer 0 (the seeds), then at the calibrated layer-1 frontier
    # that K3 makes of its picks, as the sampler walks them
    nb0, _ = walk_case(0, seeds)
    f1, n1 = unique_seeded_split(seeds, nb0.reshape(-1),
                                 torch.full((), n, dtype=torch.int32,
                                            device=dev),
                                 pin_caps[1], num_node=graph.num_node)[:2]
    print(f"{tag} pinsage layer-1 frontier: {int(n1)} unique of capacity "
          f"{pin_caps[1]}", flush=True)
    walk_case(1, f1)
    del nb0, f1, n1
    pbatch = pin_engine.sampler.sample(seeds, n, generator(dev, 7))
    assert_plain_batch(pin_engine.sampler, pbatch, random_walk,
                       "sample_random_walk", sample_random_walk_plain,
                       "K9/K3")
    # K4 as PinSAGEConv runs it: the walk's counts as per-pick weights;
    # forward at both layers, backward with the prefix gradient at layer 1
    # (layer 0's feature table needs no gradient)
    pb0, pb1 = pbatch.blocks
    h_pin = torch.randn((pb0.dst_cap, cfg.num_hidden), generator=gen,
                        device=dev)
    fwd_case(feat, pb0, 2, weights=pb0.weights, path="pinsage",
             wname="walk counts", mean=True)
    fwd_case(h_pin, pb1, 2, weights=pb1.weights, path="pinsage",
             wname="walk counts", mean=True)
    bwd_case(h_pin, pb1, weights=pb1.weights, with_dst=True, path="pinsage",
             wname="walk counts", per_step=1)
    del pbatch, pb0, pb1, h_pin

    # ---- 5. small reference: kernels on the card vs plain on the CPU -------
    small = make_device_dataset(3000, 12000, 32, 6, seed=1, device=dev,
                                dedup=False)
    scfg = RunConfig(batch_size=64, fanout=(5, 4, 3), num_hidden=16,
                     frontier_capacities=(64, 512, 2048, 3072))

    small_seeds = torch.from_numpy(small.train_set[:64]).to(dev)
    sb = Sampler(small.graph, scfg, direct_extract=True).sample(
        small_seeds, 64, generator(dev, 3))
    # PinSAGE on its own two walk layers (bench.py's walk)
    pcfg = RunConfig(batch_size=64, num_hidden=16, model="pinsage",
                     sample_type="random_walk", num_neighbor=NUM_NEIGHBOR,
                     num_random_walk=WALK["num_random_walk"],
                     random_walk_length=WALK["random_walk_length"],
                     random_walk_restart_prob=WALK["restart_prob"])
    sbp = Sampler(small.graph, pcfg, direct_extract=True).sample(
        small_seeds, 64, generator(dev, 3))
    to_cpu = lambda blk: type(blk)(**{
        k: (v.cpu() if isinstance(v, torch.Tensor) else v)
        for k, v in vars(blk).items()
    })
    labels = small.label[sb.output_nodes]
    # GraphSAGE, then GCN and GAT (1 and 8 heads: per-head and shared K5),
    # PinSAGE and MLP
    for model_name, heads in (("graphsage", 1), ("gcn", 1), ("gat", 1),
                              ("gat", 8), ("pinsage", 1), ("mlp", 1)):
        if model_name == "pinsage":
            mcfg, mb = pcfg, sbp
        else:
            scfg.model, scfg.num_head = model_name, heads
            mcfg, mb = scfg, sb
        model = build_model(mcfg, 32, 6)
        cpu_model = build_model(mcfg, 32, 6)
        model.to(dev)
        logits = model(mb.blocks, small.feat)
        ref_logits = cpu_model([to_cpu(b) for b in mb.blocks],
                               small.feat.cpu())
        loss, _ = loss_fn(logits, labels, mb.num_output)
        ref_loss, _ = loss_fn(ref_logits, labels.cpu(), mb.num_output.cpu())
        if not (torch.allclose(logits.cpu(), ref_logits, rtol=1e-4,
                               atol=1e-5)
                and torch.allclose(loss.cpu(), ref_loss, rtol=1e-5)):
            raise AssertionError(f"small reference ({model_name}, {heads} "
                                 "head(s)): card logits disagree with the "
                                 "CPU plain path")
        print(f"{tag} small reference {model_name} ({heads} head(s)): "
              f"logits {tuple(logits.shape)} max abs diff "
              f"{max_err(logits.cpu(), ref_logits):.3e}, loss "
              f"{loss.item():.6f} vs {ref_loss.item():.6f}", flush=True)
    # K6a and K6b on the small graph, the kernels on the card against their
    # plain versions on the CPU; then full-graph logits of the zoo against
    # the CPU's
    si, sx, sn = small.graph.indptr, small.graph.indices, small.num_node
    cpu_csr = (si.cpu(), sx.cpu())
    sh = torch.randn((sn, 32), generator=gen, device=dev)
    for mean in (False, True):
        got = spmm_csr(si, sx, sh, num_node=sn, mean=mean).cpu()
        ref = spmm_csr_plain(*cpu_csr, sh.cpu(), num_node=sn, mean=mean)
        mass = spmm_csr_plain(*cpu_csr, sh.abs().cpu(), num_node=sn,
                              mean=mean)
        assert_agg_close("spmm_csr (small graph)", got, ref, mass)
        print(f"{tag} small reference spmm_csr ({'mean' if mean else 'sum'}"
              f", {sn} rows x 32): max abs err {max_err(got, ref):.3e} "
              f"against the CPU's plain version (bit-equal: "
              f"{torch.equal(got, ref)})", flush=True)
    sf = torch.randn((sn, 8, 4), generator=gen, device=dev)
    sel_, ser = (torch.randn((sn, 8), generator=gen, device=dev)
                 for _ in range(2))
    got = gat_aggregate_csr(si, sx, sf, sel_, ser, num_node=sn).cpu()
    cpu_gat = [t.cpu() for t in (sf, sel_, ser)]
    ref = gat_aggregate_csr_plain(*cpu_csr, *cpu_gat, num_node=sn)
    mass = gat_aggregate_csr_plain(*cpu_csr, cpu_gat[0].abs(), *cpu_gat[1:],
                                   num_node=sn)
    assert_agg_close("gat_aggregate_csr (small graph)", got, ref, mass)
    print(f"{tag} small reference gat_aggregate_csr ({sn} rows, 8 heads of "
          f"4): max abs err {max_err(got, ref):.3e} against the CPU's plain "
          "version", flush=True)
    for model_name, heads in (("graphsage", 1), ("gcn", 1), ("gat", 1),
                              ("gat", 8), ("pinsage", 1)):
        mcfg = RunConfig(num_hidden=16, model=model_name, num_head=heads)
        model = build_model(mcfg, 32, 6)
        ref_logits = full_graph_inference(model, *cpu_csr, small.feat.cpu(),
                                          device="cpu")
        logits = full_graph_inference(model.to(dev), si, sx, small.feat)
        if not torch.allclose(logits.cpu(), ref_logits, rtol=1e-4,
                              atol=1e-5):
            raise AssertionError(f"small reference full_graph_inference "
                                 f"({model_name}, {heads} head(s)): card "
                                 "logits disagree with the CPU's")
        print(f"{tag} small reference full_graph_inference {model_name} "
              f"({heads} head(s)): logits {tuple(logits.shape)} max abs diff "
              f"{max_err(logits.cpu(), ref_logits):.3e}", flush=True)
    del small, sb, sbp, model, logits, sh, sf, sel_, ser, got, ref, mass

    # ---- 6. main path ------------------------------------------------------
    steps = Shuffler(ds.train_set, BATCH).num_local_step
    sampled = {"sample_khop": 3 * steps, "unique_seeded": 2 * steps}
    gat = {"gather_rows": 2 * steps, "attend_fwd": 3 * steps,
           "attend_bwd": 3 * steps, **sampled}
    expected = {
        "graphsage": {"gather_rows": 2 * steps, "fanout_fwd": 3 * steps,
                      "fanout_bwd": 2 * steps, **sampled},
        # labels only; layer 0's feature table needs no gradient
        "gcn": {"gather_rows": steps, "pick_multiplicity": 3 * steps,
                "fanout_fwd": 3 * steps, "fanout_bwd": 2 * steps, **sampled},
        # labels and layer 0's el_dst rows; K5's backward at every layer
        "gat1": gat, "gat8": gat,
        # a walk a layer, one dedup; labels and layer 0's dst rows; the
        # weighted sum at both layers, the prefix form's backward at layer 1
        "pinsage": {"random_walk": 2 * steps, "unique_seeded": steps,
                    "gather_rows": 2 * steps, "fanout_fwd": 2 * steps,
                    "fanout_bwd": steps},
        # labels and layer 0's dst rows; no aggregate
        "mlp": {"gather_rows": 2 * steps, **sampled},
        "graphsage_khop1": {"sample_wr": 3 * steps,
                            "unique_seeded": 2 * steps,
                            "gather_rows": 2 * steps, "fanout_fwd": 3 * steps,
                            "fanout_bwd": 2 * steps},
        "graphsage_weighted_prefix": {"sample_prefix": 3 * steps,
                                      "unique_seeded": 2 * steps,
                                      "gather_rows": 2 * steps,
                                      "fanout_fwd": 3 * steps,
                                      "fanout_bwd": 2 * steps},
        # non-direct extract: the last layer deduped too, K11 once a step
        # (its split and its SMs' reads), K1 for the labels only (the dst
        # rows are x's prefix)
        "graphsage_cached": {"sample_khop": 3 * steps,
                             "unique_seeded": 3 * steps,
                             "tiered_split": steps, "tiered_direct": steps,
                             "gather_rows": steps,
                             "fanout_fwd": 3 * steps,
                             "fanout_bwd": 2 * steps},
        # and K12 once a step; K11 once more at the epoch's end, in its
        # all-miss form, to rebuild the refreshed cache
        "graphsage_dynamic": {"sample_khop": 3 * steps,
                              "unique_seeded": 3 * steps,
                              "accumulate_freq": steps,
                              "tiered_split": steps + 1,
                              "tiered_direct": steps + 1,
                              "gather_rows": steps, "fanout_fwd": 3 * steps,
                              "fanout_bwd": 2 * steps},
    }
    counts_by_path, inference_rows = {}, {}
    host_runs = {}  # the host loop's epochs 0 and 1 by path, for phase 10
    mean = lambda v: sum(v) / max(len(v), 1)

    def run_epochs(path, eng):
        """A warm-up epoch, then a counted one with the launch counters set
        to 0 just before it and read just after it."""
        start_gib = torch.cuda.memory_allocated(dev) / 2**30
        for epoch in (0, 1):
            _build.LAUNCHES.reset()
            r = eng.train_epoch(epoch)
            torch.cuda.synchronize()
            counts = _build.LAUNCHES.snapshot()
            print(f"{tag} {path} epoch {epoch} "
                  f"({'warm-up' if epoch == 0 else 'counted'}, pipelined): "
                  f"{r['time']:.3f} s, {steps} steps, loss {r['loss']:.4f}, "
                  f"acc {r['train_acc']:.4f}, launches {counts}", flush=True)
            if counts != expected[path]:
                raise AssertionError(f"{path}: launch counts {counts} != "
                                     f"{expected[path]}")
            losses = eng.history[epoch]["loss"]
            if not all(math.isfinite(v) for v in losses):
                raise AssertionError(f"{path} epoch {epoch}: a step loss is "
                                     f"not finite: {list(losses)}")
        counts_by_path[path] = counts
        host_runs[path] = {
            "hist": [eng.history[0], eng.history[1]], "time": r["time"],
            # the epochs' peak above what was held before them
            "step_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30
            - start_gib}
        stage = eng.history[1]["stages"]
        print(f"{tag} {path} epoch 1 host enqueue per step: sample "
              f"{mean(stage['sample']) * 1e3:.3f} ms, extract "
              f"{mean(stage['extract']) * 1e3:.3f} ms, train "
              f"{mean(stage['train']) * 1e3:.3f} ms", flush=True)
        return r

    hand_names = hand_kernel_names()

    def profiled_epoch(path, eng, epoch):
        """Device busy share over one more pipelined epoch, from the
        profiler's device events (the union of their intervals over the
        epoch's wall time), and device ms per step by kernel."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a lead-in of short kernels, left out below: after a CUDA
            # graph replay in the process, a session lost the records of
            # the first few kernels it saw (seen on an H100, torch 2.11)
            for _ in range(LEAD_IN_KERNELS):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.2)
            t0 = time.perf_counter()
            eng.train_epoch(epoch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            # time for CUPTI to complete the last kernels' records before
            # the trace stops (tests/test_torch_port_cuda.py, _settle)
            time.sleep(0.2)
        if not all(math.isfinite(v) for v in eng.history[epoch]["loss"]):
            raise AssertionError(f"{path} epoch {epoch}: a step loss is not "
                                 "finite")
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA
                       and kernel_name(e.name) != "spin_kernel")
        if not spans:
            print(f"{tag} {path} device busy share: not measured (the "
                  "profiler recorded no device events)", flush=True)
            return None
        busy_us, reach, by_name = 0.0, -math.inf, {}
        # the hand kernels' launches as the profiler recorded them
        hand = collections.Counter()
        for start, end, name in spans:
            busy_us += max(0.0, end - max(start, reach))
            reach = max(reach, end)
            by_name[name] = by_name.get(name, 0.0) + (end - start)
            if kernel_name(name) in hand_names:
                hand[kernel_name(name)] += 1
        print(f"{tag} {path} epoch {epoch} (profiled, pipelined): "
              f"{wall_us / 1e3:.1f} ms wall, device busy "
              f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / steps:.3f} ms per "
              f"step), busy share {busy_us / wall_us:.3f}, {len(spans)} "
              "device events; device ms per step by kernel:", flush=True)
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:16]:
            print(f"{tag}   {us / 1e3 / steps:9.3f}  {name[:120]}", flush=True)
        # each sampler instance's ms a launch, by its place among the
        # instance's launches in a step (K9's two layers share one)
        launches_of = collections.defaultdict(list)
        for start, end, name in spans:
            if "sample_" in name or "random_walk" in name:
                launches_of[name].append(end - start)
        sampler_ms = {}
        for name, ts in sorted(launches_of.items()):
            k = len(ts) // steps
            by_place = (None if k < 2 or len(ts) != k * steps else
                        [sum(ts[i::k]) / steps / 1e3 for i in range(k)])
            at = ("" if by_place is None else "; by place in a step "
                  + " / ".join(f"{t:.4f}" for t in by_place))
            print(f"{tag}   sampler {sum(ts) / len(ts) / 1e3:.4f} ms a launch "
                  f"over {len(ts)} launches{at}: {name[:100]}", flush=True)
            sampler_ms[name[:100]] = {"ms_per_launch": sum(ts) / len(ts)
                                      / 1e3, "launches": len(ts),
                                      "ms_by_place": by_place}
        groups = (
            ("*fill*", lambda n: "fill" in n),
            ("*add*", lambda n: "add" in n),
            ("K4's segmented backward, *bwd_* but not *attend* (GAT: K5's "
             "g_table sum)", lambda n: "bwd_" in n and "attend" not in n),
            ("K5, *attend* and *proj_reduce*",
             lambda n: "attend" in n or "proj_reduce" in n),
            ("K7, *multiplicity_kernel*",
             lambda n: "multiplicity_kernel" in n),
            ("K9, *random_walk*", lambda n: "random_walk" in n),
            ("K8b, *sample_prefix* and *sample_alias*",
             lambda n: "sample_prefix" in n or "sample_alias" in n),
            ("K11's split, *split_*", lambda n: "split_" in n),
            ("K11's reads in place, *direct_kernel*",
             lambda n: "direct_kernel" in n),
            ("K12, *accumulate_kernel*", lambda n: "accumulate_kernel" in n),
            ("elementwise divisions, *divfunctor* (a mean's division "
             "outside K4, forward and backward, and Adam's)",
             lambda n: "divfunctor" in n),
            ("NCCL collectives, *nccl*", lambda n: "nccl" in n),
            ("K13-plan, *plan_*", lambda n: "plan_" in n),
        )
        group_ms = {}
        for what, match in groups:
            hits = [(name, end - start) for start, end, name in spans
                    if match(name.lower())]
            us = sum(t for _, t in hits)
            group_ms[what] = us / 1e3 / steps
            print(f"{tag}   device ms per step in {what}: "
                  f"{us / 1e3 / steps:.3f} ({len(hits) / steps:.1f} "
                  "kernels a step)", flush=True)
        k11 = [(a, b) for a, b, name in spans if "direct_kernel" in name]
        if k11:
            # how much of K11's reads' time other kernels (training, on the
            # other stream) ran beside them
            merged = []
            for a, b, name in spans:
                if "direct_kernel" in name:
                    continue
                if merged and a <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])
            total = sum(b - a for a, b in k11)
            beside = sum(max(0.0, min(b, mb) - max(a, ma))
                         for a, b in k11 for ma, mb in merged)
            print(f"{tag}   K11 overlaps other kernels for {beside / 1e3:.1f} "
                  f"of its {total / 1e3:.1f} ms ({beside / max(total, 1e-9):.3f}"
                  "): extract beside training", flush=True)
        # device-to-device copies: at P = 1 NCCL's all_to_all is one
        dtod = sum(1 for _, _, name in spans if "dtod" in name.lower())
        return {"busy_ms_per_step": busy_us / 1e3 / steps,
                "busy_share": busy_us / wall_us, "wall_ms": wall_us / 1e3,
                "device_events": len(spans), "dtod_per_step": dtod / steps,
                "hand_kernel_launches": dict(sorted(hand.items())),
                "sampler_ms": sampler_ms, "group_ms": group_ms}

    def edges_of(sampler):
        """edges aggregated per step, counted from the block masks
        (bench.py), the mean of 5 batches"""
        counts_e = []
        for i, (s_ids, s_n) in enumerate(Shuffler(ds.train_set, BATCH,
                                                  seed=43).epoch_batches(1)):
            if i >= 5:
                break
            b = sampler.sample(torch.from_numpy(s_ids).to(dev), s_n,
                               generator(dev, 900 + i))
            counts_e.append(sum(int(blk.mask.sum()) for blk in b.blocks))
        return sum(counts_e) / len(counts_e)

    # graphsage, gcn, gat1, gat8 and mlp sample with the same configuration
    edges_per_step = edges_of(engine.sampler)
    print(f"{tag} edges aggregated per step {edges_per_step:.1f}",
          flush=True)

    def rate_and_memory(path, r, per_step=None):
        per_step = edges_per_step if per_step is None else per_step
        print(f"{tag} {path}: edges/s over the counted epoch "
              f"{per_step * steps / r['time']:.1f}; peak device "
              f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} "
              "GiB", flush=True)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r1 = run_epochs("graphsage", engine)
    rate_and_memory("graphsage", r1)
    engine.config.pipeline = False
    r2 = engine.train_epoch(2)
    stage = engine.history[2]["stages"]
    print(f"{tag} graphsage epoch 2 (unpipelined, synchronised per stage): "
          f"{r2['time']:.3f} s; per step sample "
          f"{mean(stage['sample']) * 1e3:.3f} ms, extract "
          f"{mean(stage['extract']) * 1e3:.3f} ms, train "
          f"{mean(stage['train']) * 1e3:.3f} ms; loss {r2['loss']:.4f}",
          flush=True)
    if not all(math.isfinite(v) for v in engine.history[2]["loss"]):
        raise AssertionError("epoch 2: a step loss is not finite")
    engine.config.pipeline = True
    host_runs["graphsage"]["profiled"] = profiled_epoch("graphsage", engine,
                                                        3)
    # the trained models, for phase 9
    trained = {"graphsage": (engine.config, engine.model)}
    del engine

    # GCN 3x256 and GAT 3x256 at 1 and at 8 heads, the same configuration
    for path, model_name, heads in (("gcn", "gcn", 1), ("gat1", "gat", 1),
                                    ("gat8", "gat", 8)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eng = Engine(ds, dataclasses.replace(cfg, model=model_name,
                                             num_head=heads)).init()
        r1 = run_epochs(path, eng)
        rate_and_memory(path, r1)
        host_runs[path]["profiled"] = profiled_epoch(path, eng, 2)
        trained[path] = (eng.config, eng.model)
        del eng

    # PinSAGE 2x256 on bench.py's walk (its engine set up in phase 4)
    pin_edges = edges_of(pin_engine.sampler)
    print(f"{tag} pinsage edges aggregated per step {pin_edges:.1f}",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r1 = run_epochs("pinsage", pin_engine)
    rate_and_memory("pinsage", r1, pin_edges)
    host_runs["pinsage"]["profiled"] = profiled_epoch("pinsage", pin_engine,
                                                      2)
    trained["pinsage"] = (pin_engine.config, pin_engine.model)
    del pin_engine

    # MLP 3x256 (its sampled edges counted as bench.py counts them, though
    # it aggregates none) and GraphSAGE on khop1, the main configuration
    for path, change in (("mlp", dict(model="mlp")),
                         ("graphsage_khop1", dict(sample_type="khop1"))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eng = Engine(ds, dataclasses.replace(cfg, **change)).init()
        per_step = edges_per_step if path == "mlp" else edges_of(eng.sampler)
        if path != "mlp":
            print(f"{tag} {path} edges aggregated per step {per_step:.1f}",
                  flush=True)
        r1 = run_epochs(path, eng)
        rate_and_memory(path, r1, per_step)
        host_runs[path]["profiled"] = profiled_epoch(path, eng, 2)
        del eng

    # ---- 7. weighted sampling ----------------------------------------------
    # The weighted dataset through its entry point: make_device_dataset
    # (weighted=True) gives phase 3's graph, features, labels and split,
    # with the prefix table and its coarse CDF; kept for K8b-prefix, the
    # graphsage_weighted_prefix path and K8b-alias, then freed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wds = make_device_dataset(NUM_NODE, NUM_EDGE, FEAT_DIM, NUM_CLASS,
                              train_frac=0.08, seed=0, name="products_synth",
                              weighted=True, dedup=False)
    torch.cuda.synchronize()
    wds_s = time.perf_counter() - t0
    wgraph = wds.graph
    prefix, coarse = wgraph.prob_prefix_table, wgraph.coarse_cdf
    for name in ("indptr", "indices", "feat", "label", "train_set",
                 "valid_set", "test_set"):
        a, b = getattr(wds, name), getattr(ds, name)
        same = (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else a.shape == b.shape and bool((a == b).all()))
        if not same:
            raise AssertionError(f"weighted dataset: {name} differs from "
                                 "the unweighted one of the same seed")
    # the unweighted dataset's tensors go: the paths' peak memory stays
    # comparable
    ds, graph, feat = wds, wgraph, wds.feat
    # every row of the prefix table nondecreasing, as K8b-prefix needs
    starts = torch.zeros(wgraph.num_edge, dtype=torch.bool, device=dev)
    starts[wgraph.indptr[:-1][wgraph.indptr[1:] > wgraph.indptr[:-1]]
           .long()] = True
    if not bool(((prefix[1:] >= prefix[:-1]) | starts[1:]).all()):
        raise AssertionError("weighted dataset: a prefix row decreases")
    del starts
    # the tables once more, each step timed: the coarse CDF equal to the
    # dataset's, the prefix sums within 1e-6 (a float64 scan on the card
    # need not round alike twice)
    t0 = time.perf_counter()
    w = edge_weights(wgraph.num_edge, 0, dev)
    again = prefix_table(wgraph.indptr, w)
    del w
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    again_cdf = build_coarse_cdf(wgraph.indptr, prefix, wgraph.num_node)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if not (torch.allclose(again, prefix, rtol=1e-6, atol=0.0)
            and torch.equal(again_cdf, coarse)):
        raise AssertionError("weighted dataset: its tables differ from "
                             "the same functions run again")
    print(f"{tag} weighted dataset: prefix sums run again differ in "
          f"{int((again != prefix).sum())} of {prefix.numel()} entries",
          flush=True)
    del again, again_cdf
    print(f"{tag} weighted dataset: built in {wds_s:.3f} s (phase 3's "
          f"unweighted one, the card's first work: {graph_s:.3f} s), equal "
          f"to it but for its tables: prefix {prefix.numel() * 4} bytes "
          f"(weights and sums again: {t1 - t0:.3f} s), coarse CDF "
          f"{coarse.numel() * 4} bytes ({t2 - t1:.3f} s); largest degree "
          f"{wgraph.n_max_deg}", flush=True)
    wcfg = dataclasses.replace(cfg, sample_type="weighted_khop_prefix")
    weng = Engine(wds, wcfg).init()

    def prefix_traffic(frontier, k, out):
        """The bytes K8b-prefix must move (the frontier, an indptr pair a
        valid row, u, the prefix entries a binary search over each live row
        reads, at most the row, one index a pick, the output), the same
        with each random read as the 32-byte sectors it spans (an indptr
        pair spans two when v % 8 == 7; a search a sector a step, at most
        the row's sectors; an index a sector a pick), what the kept design
        reads of the rows of at most 128 entries, what a coarse row for
        every live row would read, and the rows past 128."""
        ok = (frontier >= 0) & (frontier < wgraph.num_node)
        node = torch.where(ok, frontier, 0).long()
        start = wgraph.indptr[node].long()
        deg = torch.where(ok, wgraph.indptr[node + 1] - start, 0).double()
        live_rows = deg > 0
        d = deg[live_rows]
        steps = k * (torch.ceil(torch.log2(d)) + 1)
        search = torch.minimum(d, steps)
        first = start[live_rows] * 4
        row_sectors = (first + d.long() * 4 - 1) // 32 - first // 32 + 1
        live = d.numel()
        picks = int((out != empty).sum())
        fixed = frontier.numel() * 4 + live * k * 4 + out.numel() * 4
        nbytes = (fixed + int(ok.sum()) * 8 + int(search.sum()) * 4
                  + picks * 4)
        sector_bytes = fixed + 32 * (
            int(ok.sum()) + int((ok & (node % 8 == 7)).sum())
            + int(torch.minimum(row_sectors.double(), steps).sum()) + picks)
        return (nbytes, sector_bytes, int(d[d <= 128].sum()) * 4,
                live * 512, int((d > 128).sum()))

    # K8b-prefix at each layer's frontier, one batch walked layer by layer
    # through K3 as the sampler walks it
    frontier = seeds
    num = torch.full((), n, dtype=torch.int32, device=dev)
    for layer, k in enumerate(FANOUT):
        u = torch.rand((frontier.shape[0], k), generator=gen, device=dev)
        a = (wgraph.indptr, wgraph.indices, prefix, frontier, k, None,
             wgraph.n_max_deg, coarse)
        got = sample_weighted_khop_prefix(*a, u=u)
        ref = sample_weighted_khop_prefix_plain(*a, u=u)
        torch.cuda.synchronize()
        assert_close("sample_prefix", got, ref, exact=True)
        nbytes, sector_b, direct_b, coarse_b, hubs = prefix_traffic(
            frontier, k, got)
        rows = int((frontier != empty).sum())
        record("sample_prefix", "xgnn_tpu_torch/csrc/weighted.cu",
               "xgnn_tpu/ops/sampling.py:339",
               f"layer {layer}: frontier {frontier.shape[0]} ({rows} valid, "
               f"{hubs} past 128 entries) x K={k}, "
               f"{int((got != empty).sum())} picks",
               max_err(got, ref), "exact",
               lambda: sample_weighted_khop_prefix(*a, u=u),
               lambda: sample_weighted_khop_prefix_plain(*a, u=u),
               None, None, nbytes=nbytes, flops=0, per_step=3,
               path="graphsage_weighted_prefix")
        kernels[-1].update(direct_read_bytes=direct_b,
                           coarse_row_bytes=coarse_b,
                           sector_bound_ms=bound_ms(sector_b, 0)[0])
        print(f"{tag} sample_prefix layer {layer}: rows of <= 128 entries "
              f"read whole {direct_b} bytes, a coarse row for every live row "
              f"{coarse_b} bytes; sector floor "
              f"{kernels[-1]['sector_bound_ms']:.4f} ms", flush=True)
        if layer == len(FANOUT) - 1:
            break
        out = unique_seeded_split(frontier, got.reshape(-1), num,
                                  CAPS[layer + 1], num_node=wgraph.num_node)
        frontier, num = out[0], torch.clamp(out[1], max=CAPS[layer + 1])
    del u, got, ref, out, frontier, a
    wbatch = weng.sampler.sample(seeds, n, generator(dev, 7))
    assert_plain_batch(weng.sampler, wbatch, sampling,
                       "sample_weighted_khop_prefix",
                       sample_weighted_khop_prefix_plain, "K8b-prefix/K3")
    del wbatch

    # GraphSAGE 3x256 on weighted_khop_prefix, the main configuration
    w_edges = edges_of(weng.sampler)
    print(f"{tag} graphsage_weighted_prefix edges aggregated per step "
          f"{w_edges:.1f}", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r1 = run_epochs("graphsage_weighted_prefix", weng)
    rate_and_memory("graphsage_weighted_prefix", r1, w_edges)
    host_runs["graphsage_weighted_prefix"]["profiled"] = profiled_epoch(
        "graphsage_weighted_prefix", weng, 2)
    del weng, prefix, coarse
    wds.prob_prefix_table = None
    wgraph.prob_prefix_table = wgraph.coarse_cdf = None
    torch.cuda.empty_cache()

    def alias_error(g, w):
        """The largest gap, over every (row, id), between the probability
        that g's alias tables give an id and the one its weights ``w`` give
        it (multi-edges summed), over the row's largest"""
        num_node = g.num_node
        deg = (g.indptr[1:] - g.indptr[:-1]).long()
        rows = torch.repeat_interleave(
            torch.arange(num_node, device=dev), deg, output_size=g.num_edge)
        w64 = w.double()
        total = torch.zeros(num_node, dtype=torch.float64,
                            device=dev).index_add_(0, rows, w64)
        want = w64 / total[rows]
        del w64
        slot = 1.0 / deg[rows].double()
        own = g.prob_table.double() * slot
        key = torch.cat([rows * num_node + g.indices,
                         rows * num_node + g.alias_table,
                         rows * num_node + g.indices])
        mass = torch.cat([own, slot - own, -want])
        del own, slot
        ids, inv = torch.unique(key, return_inverse=True)
        del key
        gap = torch.zeros(ids.shape[0], dtype=torch.float64,
                          device=dev).index_add_(0, inv, mass)
        top = torch.zeros(num_node, dtype=torch.float64,
                          device=dev).scatter_reduce_(0, rows, want, "amax")
        return float((gap.abs() / top[ids // num_node]).max())

    def alias_traffic(g, frontier, k, m, dedup, out):
        """The bytes K8b-alias must move: the frontier, an indptr pair a
        valid row, 16 bytes a draw (u, coin, prob and alias or index) of
        the rows it draws from, an index an entry of a whole row (dedup,
        deg <= K), the output."""
        ok = (frontier >= 0) & (frontier < g.num_node)
        node = torch.where(ok, frontier, 0).long()
        deg = torch.where(ok, g.indptr[node + 1] - g.indptr[node], 0)
        drawn = (deg > k) if dedup else (deg > 0)
        whole = int(deg[(deg > 0) & (deg <= k)].sum()) if dedup else 0
        return (frontier.numel() * 4 + int(ok.sum()) * 8
                + int(drawn.sum()) * m * 16 + whole * 4 + out.numel() * 4)

    def alias_phase(g, graph_name, caps, batch_seeds, train_paths=None):
        """K8b-alias with and without dedup at the three frontiers of one
        batch walked through K3 by the draws without dedup, exact; then one
        batch through Sampler.sample for each alias form, its launches
        counted, equal to the plain path's.  ``train_paths``: the training
        paths whose launches the kernels' rows report, by dedup (the
        batch's paths where not given)."""
        paths = {False: f"weighted_khop ({graph_name})",
                 True: f"weighted_khop_hash_dedup ({graph_name})"}
        frontier = batch_seeds
        num = torch.full((), BATCH, dtype=torch.int32, device=dev)
        for layer, k in enumerate(FANOUT):
            b = frontier.shape[0]
            rows = int((frontier != empty).sum())
            for dedup in (False, True):
                m = (HASH_DEDUP_ROUNDS if dedup else 1) * k
                fn, plain = ((sample_weighted_khop_hash_dedup,
                              sample_weighted_khop_hash_dedup_plain) if dedup
                             else (sample_weighted_khop,
                                   sample_weighted_khop_plain))
                u = torch.rand((b, m), generator=gen, device=dev)
                coin = torch.rand((b, m), generator=gen, device=dev)
                a = (g.indptr, g.indices, g.prob_table, g.alias_table,
                     frontier, k)
                got, ref = fn(*a, u=u, coin=coin), plain(*a, u=u, coin=coin)
                torch.cuda.synchronize()
                assert_close("sample_alias", got, ref, exact=True)
                record("sample_alias", "xgnn_tpu_torch/csrc/weighted.cu",
                       "xgnn_tpu/ops/sampling.py:"
                       + ("248" if dedup else "217"),
                       f"{'hash_dedup' if dedup else 'weighted_khop'}, layer "
                       f"{layer}: frontier {b} ({rows} valid) x K={k}, {m} "
                       f"draws a row, {int((got != empty).sum())} picks; "
                       f"{graph_name}, {g.num_node} nodes",
                       max_err(got, ref), "exact",
                       lambda: fn(*a, u=u, coin=coin),
                       lambda: plain(*a, u=u, coin=coin), None, None,
                       nbytes=alias_traffic(g, frontier, k, m, dedup, got),
                       flops=0, per_step=3,
                       path=(train_paths or paths)[dedup])
                # a draw reads prob and then alias or the index: two tables
                sector_floor(g.indptr, frontier, m,
                             (frontier.numel() + u.numel() + coin.numel()
                              + got.numel()) * 4, tables=2,
                             whole_at=k if dedup else 0)
                if not dedup:
                    picks = got
            if layer == len(FANOUT) - 1:
                break
            out = unique_seeded_split(frontier, picks.reshape(-1), num,
                                      caps[layer + 1], num_node=g.num_node)
            frontier, num = out[0], torch.clamp(out[1], max=caps[layer + 1])
        for dedup, st, fn_name, plain in (
                (False, "weighted_khop", "sample_weighted_khop",
                 sample_weighted_khop_plain),
                (True, "weighted_khop_hash_dedup",
                 "sample_weighted_khop_hash_dedup",
                 sample_weighted_khop_hash_dedup_plain)):
            sampler = Sampler(g, dataclasses.replace(cfg, sample_type=st),
                              caps, direct_extract=True)
            _build.LAUNCHES.reset()
            batch = sampler.sample(batch_seeds, BATCH, generator(dev, 7))
            torch.cuda.synchronize()
            counts = _build.LAUNCHES.snapshot()
            want = {"sample_alias": len(FANOUT),
                    "unique_seeded": len(FANOUT) - 1}
            if counts != want:
                raise AssertionError(f"{st} ({graph_name}): launch counts "
                                     f"{counts} != {want}")
            counts_by_path[paths[dedup]] = counts
            print(f"{tag} {st} batch on the {graph_name}: capacities "
                  f"{list(caps)}, "
                  f"{sum(int(blk.mask.sum()) for blk in batch.blocks)} edges,"
                  f" launches {counts}", flush=True)
            assert_plain_batch(sampler, batch, sampling, fn_name, plain,
                               "K8b-alias/K3", batch_seeds, BATCH)

    # K8b-alias on the products graph, its alias tables built on the card
    # by the port's alias_tables from the weighted dataset's own edge
    # weights (edge_weights, the draw make_device_dataset made), and held
    # to those weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    w = edge_weights(wgraph.num_edge, 0, dev)
    wgraph.prob_table, wgraph.alias_table = alias_tables(
        wgraph.indptr, wgraph.indices, w)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    build_peak = torch.cuda.max_memory_allocated(dev) - held
    err = alias_error(wgraph, w)
    print(f"{tag} products alias tables: {wgraph.num_edge * 8} bytes built "
          f"on the card in {t1 - t0:.3f} s (peak {build_peak} bytes above "
          f"what was held); largest gap to the weights' probabilities "
          f"{err:.3e} of the row's largest (tolerance 1e-6)", flush=True)
    if not err <= 1e-6:
        raise AssertionError(f"products alias tables: a row's probabilities "
                             f"miss its weights' by {err:.3e}")
    del w
    # the products graph's rows count phase 13's training launches
    alias_phase(wgraph, "products graph", CAPS, seeds,
                {False: "graphsage_alias_files",
                 True: "graphsage_alias_dedup_files"})
    del wds, wgraph
    torch.cuda.empty_cache()

    # K8b-alias on a graph of 2^16 nodes at products' mean degree, its alias
    # tables built on the host by the port's build_alias_tables (bit-equal
    # to the JAX package's); its 40 MB of tables fit the card's 50 MB L2
    t0 = time.perf_counter()
    sg = make_device_dataset(ALIAS_NODES, ALIAS_DRAWS, 8, NUM_CLASS, seed=3,
                             train_frac=0.2, device=dev, dedup=False)
    host = dataclasses.replace(sg, indptr=sg.indptr.cpu().numpy(),
                               indices=sg.indices.cpu().numpy(), graph=None)
    t1 = time.perf_counter()
    build_alias_tables(host, seed=3)
    t2 = time.perf_counter()
    agraph = Graph.from_dataset(host, dev, weighted=True)
    torch.cuda.synchronize()
    print(f"{tag} alias graph: {host.num_node} nodes, {host.num_edge} edges "
          f"(mean degree {host.num_edge / host.num_node:.2f}, largest "
          f"{agraph.n_max_deg}) built on the card in {t1 - t0:.3f} s; alias "
          f"tables ({host.num_edge * 8} bytes) built on the host in "
          f"{t2 - t1:.3f} s", flush=True)
    acaps = [BATCH] + default_capacities(BATCH, FANOUT, agraph.num_node)[1:]
    alias_phase(agraph, "alias graph", acaps,
                torch.from_numpy(host.train_set[:BATCH]).to(dev))
    del sg, host, agraph

    # ---- 8. the tiered store: GraphSAGE on a presampled hot-row cache ------
    # ds is phase 7's weighted dataset, phase 3's graph, features, labels
    # and split; its alias tables go
    ds.graph.prob_table = ds.graph.alias_table = None
    del feat, graph
    torch.cuda.empty_cache()
    # K11's PCIe bound: the link's rated rate; the pinned host-to-device
    # copy rate beside it, the practical ceiling
    pinned = torch.empty(H2D_BYTES // 4, dtype=torch.float32).pin_memory()
    on_card = torch.empty(pinned.shape, dtype=torch.float32, device=dev)
    h2d_ms = time_ms(torch, lambda: on_card.copy_(pinned, non_blocking=True),
                     reps=5)
    h2d_rate = H2D_BYTES / h2d_ms * 1e3
    del pinned, on_card
    # a copy faster than the rating: the copy's rate is the peak
    pcie_rate = max(PCIE_BYTES_PER_S, h2d_rate)
    print(f"{tag} PCIe: rated {PCIE_BYTES_PER_S / 1e9:.3f} GB/s a direction "
          f"(gen 5 x16); pinned host-to-device copy_: {H2D_BYTES} bytes in "
          f"{h2d_ms:.4f} ms, {h2d_rate / 1e9:.3f} GB/s; K11's bound takes "
          f"{pcie_rate / 1e9:.3f} GB/s", flush=True)
    ccfg = dataclasses.replace(cfg, cache_percentage=CACHE_PCT,
                               cache_policy="pre_sample", presample_epoch=1)
    _build.LAUNCHES.reset()
    t0 = time.perf_counter()
    ceng = Engine(ds, ccfg).init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_counts = _build.LAUNCHES.snapshot()
    init_items["graphsage_cached"] = dict(ceng.profiler._init_items,
                                          init_s=init_s, **ceng.init_times)
    store = ceng.feature_source
    num_cache, width = store.num_cache, store.feat_dim
    print(f"{tag} graphsage_cached engine init: {init_s:.3f} s; presample "
          f"{ceng.init_times['presample']:.3f} s (one epoch, "
          f"{init_counts.get('accumulate_freq', 0)} K12 launches), cache "
          f"build {ceng.init_times['cache_build']:.3f} s (the table's "
          f"{store.feat_host.numel() * 4} bytes pulled, pinned and mapped, "
          f"then {num_cache} rows by K11's all-miss form); capacities "
          f"{ceng.sampler.capacities}", flush=True)
    if (init_counts.get("accumulate_freq") != steps
            or init_counts.get("tiered_split") != 1
            or init_counts.get("tiered_direct") != 1):
        raise AssertionError(f"graphsage_cached init: launches {init_counts}")
    # the store keeps no device copy of the features; the dataset's goes
    ds.feat = store.feat_host
    torch.cuda.empty_cache()

    # K3 at the last layer's dedup (non-direct extract), walked layer by
    # layer through K2 and K3 as the sampler walks them
    frontier = seeds
    num = torch.full((), n, dtype=torch.int32, device=dev)
    indptr, indices = ds.graph.indptr, ds.graph.indices
    for layer, k in enumerate(FANOUT):
        u = torch.rand((frontier.shape[0], k), generator=gen, device=dev)
        picks = sample_khop0(indptr, indices, frontier, k, u=u).reshape(-1)
        cap = CAPS[layer + 1]
        out = unique_seeded_split(frontier, picks, num, cap,
                                  num_node=NUM_NODE)
        if layer < len(FANOUT) - 1:
            frontier, num = out[0], torch.clamp(out[1], max=cap)
            continue
        ref = unique_seeded_split_plain(frontier, picks, num, cap)
        torch.cuda.synchronize()
        for o, r in zip(out, ref):
            assert_close("unique_seeded (last layer)", o, r, exact=True)
        ids = torch.cat([frontier, picks])
        record("unique_seeded", "xgnn_tpu_torch/csrc/unique.cu",
               "xgnn_tpu/ops/unique.py:178",
               f"layer {layer} (non-direct extract): {ids.shape[0]} ids "
               f"(prefix {frontier.shape[0]}, {int((picks != empty).sum())} "
               f"valid picks), out_cap {cap}, {int(out[1])} unique",
               max(max_err(o, r) for o, r in zip(out, ref)), "exact",
               lambda: unique_seeded_split(frontier, picks, num, cap,
                                           num_node=NUM_NODE),
               lambda: unique_seeded_split_plain(frontier, picks, num, cap),
               lambda: torch.unique(ids, sorted=True, return_inverse=True),
               "torch.unique(sorted=True, return_inverse=True) on the "
               "concatenated ids; its id order differs (no seeded prefix)",
               nbytes=ids.numel() * 4 + picks.numel() * 4 + cap * 4 + 8,
               flops=0, per_step=3, path="graphsage_cached")
    del u, picks, out, ref, ids, frontier

    # K11 on one sampled batch's input nodes, as drawn and with 30% EMPTY
    cbatch = ceng.sampler.sample(seeds, n, generator(dev, 7))
    num_in = cbatch.num_input
    sparse = cbatch.input_nodes.clone()
    sparse[torch.rand(sparse.shape, generator=gen, device=dev) < 0.3] = empty
    print(f"{tag} graphsage_cached batch: {int(num_in)} input nodes of "
          f"capacity {cbatch.input_nodes.shape[0]}", flush=True)

    def k11_case(ids, num_valid, posmap, what, per_step,
                 path="graphsage_cached"):
        """K11's split, its SMs' reads and the whole extract against their
        plain versions, exactly; the split and the reads recorded with
        their bounds, the whole call timed beside them."""
        cache = None if posmap is None else store.cache_feat
        args = (ids, num_valid, posmap, cache)
        # the split: the hit and zero rows, the miss list, the counts
        out, counts, pos, miss_ids = tiered_split(*args, store.host)
        p_out, p_counts, p_pos, p_ids = tiered_split_plain(*args,
                                                           store.feat_host)
        torch.cuda.synchronize()
        hits, misses = (int(c) for c in p_counts)
        valid = hits + misses
        if not (torch.equal(counts, p_counts)
                and torch.equal(pos[:misses], p_pos[:misses])
                and torch.equal(miss_ids[:misses], p_ids[:misses])):
            raise AssertionError(f"tiered_split {what}: counts or miss list "
                                 "differ from the plain version")
        kept = torch.ones(ids.numel(), dtype=torch.bool, device=dev)
        kept[pos[:misses].long()] = False
        assert_close("tiered_split", out[kept], p_out[kept], exact=True)
        # the ids, a posmap word a valid id, the hit rows, the rows of out
        # it writes, the miss list and the counts
        split_bytes = (ids.numel() * 4 + valid * 4 + hits * width * 4
                       + (ids.numel() - misses) * width * 4 + misses * 8 + 8)
        record("tiered_split", "xgnn_tpu_torch/csrc/tiered.cu",
               "xgnn_tpu/store/feature_store.py:64-109 (_split_kernel, with "
               "compact_mask_positions, xgnn_tpu/ops/unique.py:27)",
               f"{what}: {ids.numel()} ids ({valid} valid: {hits} hits, "
               f"{misses} misses) over a ({num_cache}, {width}) cache",
               max_err(out[kept], p_out[kept]), "exact: hit and zero rows, "
               "miss positions and ids, counts",
               lambda: tiered_split(*args, store.host),
               lambda: tiered_split_plain(*args, store.feat_host), None,
               "none: no one PyTorch call splits and compacts",
               nbytes=split_bytes, flops=0, per_step=per_step, path=path,
               plain_reps=3)
        del out, pos, miss_ids, kept
        # the SMs' reads, on the plain split's output and miss list
        got = tiered_direct(p_out.clone(), p_ids, p_pos, p_counts,
                            store.host)
        ref = tiered_direct_plain(p_out.clone(), p_ids, p_pos, misses,
                                  store.feat_host)
        torch.cuda.synchronize()
        assert_close("tiered_direct", got, ref, exact=True)
        d_err = max_err(got, ref)
        del got, ref
        d_out = p_out.clone()
        # the miss list and the rows it writes in HBM; the miss rows over
        # PCIe
        pcie = misses * width * 4
        d_hbm_ms = (misses * (width * 4 + 8) + 4) / HBM_BYTES_PER_S * 1e3
        pcie_ms = pcie / pcie_rate * 1e3
        record("tiered_direct", "xgnn_tpu_torch/csrc/tiered.cu",
               "xgnn_tpu/store/feature_store.py:111-118 and 217-250 (the "
               "host gather, the copy, _combine_kernel)",
               f"{what}: {misses} miss rows of {width} f32 from a "
               f"({NUM_NODE}, {width}) mapped host table into "
               f"({ids.numel()}, {width})", d_err, "exact",
               lambda: tiered_direct(d_out, p_ids, p_pos, p_counts,
                                     store.host),
               lambda: tiered_direct_plain(d_out, p_ids, p_pos, misses,
                                           store.feat_host),
               None, "none: no one PyTorch call reads a mapped host table",
               nbytes=0, flops=0, per_step=per_step, path=path, plain_reps=3,
               bound=max((d_hbm_ms, "bytes"), (pcie_ms, "bytes")))
        kernels[-1].update(pcie_bound_ms=pcie_ms, pcie_bytes=pcie,
                           pcie_bytes_per_s_rated=pcie_rate,
                           h2d_bytes_per_s=h2d_rate,
                           copy_bound_ms=pcie / h2d_rate * 1e3,
                           pcie_bytes_per_s=pcie / kernels[-1]["device_ms"]
                           * 1e3)
        direct_row = kernels[-1]
        del d_out, p_out, p_pos, p_ids
        # the whole extract
        out, counts = tiered_extract(*args, store.host)
        ref, ref_counts = tiered_extract_plain(*args, store.feat_host)
        torch.cuda.synchronize()
        assert_close("tiered_extract", out, ref, exact=True)
        if not torch.equal(counts, ref_counts):
            raise AssertionError(f"tiered_extract: counts {counts.tolist()} "
                                 f"!= {ref_counts.tolist()}")
        del ref
        # the ids, a posmap word a valid id, the hit rows and the output in
        # HBM; the miss rows over PCIe
        hbm = (ids.numel() * 4 + valid * 4 + hits * width * 4
               + ids.numel() * width * 4 + 8)
        hbm_ms = hbm / HBM_BYTES_PER_S * 1e3
        e_ms = time_ms(torch, lambda: tiered_extract(*args, store.host))
        e_dev = time_ms(torch, lambda: tiered_extract(*args, store.host),
                        host_ahead=True)
        e_bound = max(hbm_ms, pcie_ms)
        direct_row.update(extract_ms=e_ms, extract_device_ms=e_dev,
                          extract_bound_ms=e_bound,
                          extract_pcie_bytes_per_s=pcie / e_dev * 1e3)
        print(f"{tag} tiered_extract {what} (split and reads): {e_ms:.4f} ms "
              f"({e_dev:.4f} ms on the card alone), {pcie} bytes over PCIe "
              f"at {pcie / e_dev / 1e6:.3f} GB/s (rated "
              f"{pcie_rate / 1e9:.3f} GB/s, pinned copy_ "
              f"{h2d_rate / 1e9:.3f} GB/s); bound {e_bound:.4f} ms (HBM "
              f"{hbm_ms:.4f} ms, PCIe {pcie_ms:.4f} ms, "
              f"{pcie / h2d_rate * 1e3:.4f} ms at the copy's rate)",
              flush=True)
        return out

    k11_case(cbatch.input_nodes, num_in, store.posmap, "the batch as drawn",
             1)
    k11_case(sparse, num_in, store.posmap, "30% EMPTY", 1)
    # the all-miss form: the cache's rows, in slot order
    cached = (store.posmap != empty).nonzero().flatten()
    cache_ids = torch.empty(num_cache, dtype=torch.int32, device=dev)
    cache_ids[store.posmap[cached].long()] = cached.to(torch.int32)
    counts_by_path["graphsage_cached_init"] = init_counts
    rows = k11_case(cache_ids, num_cache, None, "all-miss form (cache build)",
                    0, path="graphsage_cached_init")
    assert_close("tiered_extract (cache build)", rows, store.cache_feat,
                 exact=True)
    del sparse, cached, rows

    # K12 on the batch (the dynamic cache's per-step count)
    freq = torch.zeros(NUM_NODE, dtype=torch.int32, device=dev)
    got = accumulate_freq(freq.clone(), cbatch.input_nodes, num_in)
    ref = accumulate_freq_plain(freq.clone(), cbatch.input_nodes, num_in)
    torch.cuda.synchronize()
    assert_close("accumulate_freq", got, ref, exact=True)
    ok = ((torch.arange(cbatch.input_nodes.shape[0], device=dev) < num_in)
          & (cbatch.input_nodes >= 0) & (cbatch.input_nodes < NUM_NODE))
    lib_idx = torch.where(ok, cbatch.input_nodes, 0).long()
    lib_val = ok.to(torch.int32)
    live = int(ok.sum())
    record("accumulate_freq", "xgnn_tpu_torch/csrc/presample.cu",
           "xgnn_tpu/store/presample.py:100-105",
           f"{cbatch.input_nodes.shape[0]} ids ({live} valid) into "
           f"({NUM_NODE},) int32", max_err(got, ref), "exact",
           lambda: accumulate_freq(freq, cbatch.input_nodes, num_in),
           lambda: accumulate_freq_plain(freq, cbatch.input_nodes, num_in),
           lambda: freq.index_put_((lib_idx,), lib_val, accumulate=True),
           "freq.index_put_((ids,), mask, accumulate=True) on the ids "
           "clamped to 0 where masked",
           # the ids in, a freq word read and written a valid id
           nbytes=cbatch.input_nodes.numel() * 4 + live * 8, flops=0,
           per_step=1, path="graphsage_dynamic")
    del got, ref, ok, lib_idx, lib_val, freq

    # K12b: one batch's three layers of the exact static closure
    bseeds = seeds[:n].contiguous()
    zero = torch.zeros(NUM_NODE, dtype=torch.int32, device=dev)
    got = closure_expand(indptr, indices, bseeds, len(FANOUT), zero.clone())
    ref = closure_expand_plain(indptr, indices, bseeds, len(FANOUT),
                               zero.clone())
    torch.cuda.synchronize()
    assert_close("closure_expand", got, ref, exact=True)
    deg = (indptr[1:] - indptr[:-1]).long()
    marked = [closure_expand_plain(indptr, indices, bseeds, lay,
                                   zero.clone()).bool()
              for lay in range(len(FANOUT))]
    # least: the seeds, an indptr pair and the indices of each row within
    # L-1 hops (its neighbours are all that the last hop needs), counts
    # read and written.  The kernel expands each of those rows once (a
    # frontier row, or a row of a closed tile streamed whole); the parent
    # streamed every marked row's indices again each layer
    reach = marked[-1]
    need_edges = int(deg[reach].sum())
    need = (bseeds.numel() * 4 + int(reach.sum()) * 8 + need_edges * 4
            + NUM_NODE * 8)
    rescan = sum(int(deg[m].sum()) for m in marked)
    record("closure_expand", "xgnn_tpu_torch/csrc/presample.cu",
           "xgnn_tpu/store/presample.py:69-83 (expand inside "
           "static_exact_ranking)",
           f"{n} seeds, {len(FANOUT)} layers over ({NUM_NODE}, "
           f"{indices.numel()}) CSR: {int(got.sum())} nodes reached, "
           f"{int(reach.sum())} rows within {len(FANOUT) - 1} hops, "
           f"{need_edges} of their edges (the parent streamed {rescan})",
           max_err(got, ref), "exact",
           lambda: closure_expand(indptr, indices, bseeds, len(FANOUT), zero),
           lambda: closure_expand_plain(indptr, indices, bseeds, len(FANOUT),
                                        zero),
           None, "none: no one PyTorch call expands a CSR mask",
           nbytes=need, flops=0, per_step=1, path="presample_static",
           plain_reps=3)
    kernels[-1]["edges_needed"] = need_edges
    print(f"{tag} closure_expand: the parent's build, not measured here: "
          f"{K12B_PARENT_MS} ms a batch in tools/time_presample.py's turns",
          flush=True)
    del got, ref, marked, reach, deg, zero
    # presample_static's ranking, a K12b launch a batch
    _build.LAUNCHES.reset()
    t0 = time.perf_counter()
    static = static_exact_ranking(ds.graph, ds.train_set, ccfg, NUM_NODE,
                                  dev)
    static_s = time.perf_counter() - t0
    counts_by_path["presample_static"] = _build.LAUNCHES.snapshot()
    if counts_by_path["presample_static"] != {"closure_expand": steps}:
        raise AssertionError("presample_static: launches "
                             f"{counts_by_path['presample_static']}")
    print(f"{tag} presample_static ranking: {steps} batches in "
          f"{static_s:.3f} s (the parent's build: {K12B_PARENT_RANKING}), "
          f"{int((static > 0).sum())} nodes reached, "
          f"launches {counts_by_path['presample_static']}", flush=True)
    del static, cbatch, bseeds

    # graphsage_cached: warm-up, counted, unpipelined and profiled epochs
    c_edges = edges_of(ceng.sampler)
    print(f"{tag} graphsage_cached edges aggregated per step {c_edges:.1f}",
          flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r1 = run_epochs("graphsage_cached", ceng)
    rate_and_memory("graphsage_cached", r1, c_edges)
    hist = ceng.history[1]
    print(f"{tag} graphsage_cached epoch 1: hit rate {r1['hit_rate']:.6f}; "
          f"per step {mean(hist['hit']):.1f} hits, {mean(hist['miss']):.1f} "
          f"misses, {mean(hist['miss']) * width * 4:.1f} miss bytes; K11 "
          f"launches {counts_by_path['graphsage_cached']['tiered_direct']} "
          f"(expected {steps}), K12 "
          f"{counts_by_path['graphsage_cached'].get('accumulate_freq', 0)} "
          "(expected 0)", flush=True)
    if not 0.0 < r1["hit_rate"] <= 1.0:
        raise AssertionError(f"graphsage_cached: hit rate {r1['hit_rate']}")
    ceng.config.pipeline = False
    r2 = ceng.train_epoch(2)
    stage = ceng.history[2]["stages"]
    print(f"{tag} graphsage_cached epoch 2 (unpipelined, synchronised per "
          f"stage): {r2['time']:.3f} s; per step sample "
          f"{mean(stage['sample']) * 1e3:.3f} ms, extract "
          f"{mean(stage['extract']) * 1e3:.3f} ms, train "
          f"{mean(stage['train']) * 1e3:.3f} ms; loss {r2['loss']:.4f}, hit "
          f"rate {r2['hit_rate']:.6f}", flush=True)
    if not all(math.isfinite(v) for v in ceng.history[2]["loss"]):
        raise AssertionError("graphsage_cached epoch 2: a step loss is not "
                             "finite")
    ceng.config.pipeline = True
    host_runs["graphsage_cached"]["profiled"] = profiled_epoch(
        "graphsage_cached", ceng, 3)
    del ceng, store, hist
    torch.cuda.empty_cache()

    # two epochs of the dynamic cache at the same configuration: it counts
    # every step (K12) and refreshes at each epoch's end
    deng = Engine(ds, dataclasses.replace(ccfg,
                                          cache_policy="dynamic_cache")).init()
    posmap0 = deng.feature_source.posmap.clone()
    run_epochs("graphsage_dynamic", deng)
    moved = int((deng.feature_source.posmap != posmap0).sum())
    if not moved:
        raise AssertionError("graphsage_dynamic: the refresh left posmap as "
                             "it was")
    check = torch.randint(0, NUM_NODE, (200_000,), generator=gen, device=dev,
                          dtype=torch.int32)
    out, info = deng.feature_source.extract(check, check.shape[0])
    want = deng.feature_source.feat_host[check.cpu().long()]
    if not torch.equal(out.cpu(), want):
        raise AssertionError("graphsage_dynamic: extraction after the "
                             "refresh differs from the host table")
    rates = [float(h["hit"].sum() / (h["hit"].sum() + h["miss"].sum()))
             for h in (deng.history[0], deng.history[1])]
    print(f"{tag} graphsage_dynamic: the refresh moved {moved} posmap "
          f"entries; {check.shape[0]} ids after it ({int(info['num_hit'])} "
          f"hits) equal the host table; epoch hit rates {rates}", flush=True)
    del deng, out, want, check, posmap0

    # ---- 9. full-graph inference and evaluation ----------------------------
    # phase 6's trained models over every node of phase 3's graph, with the
    # features back on the card (phase 8 left them in pinned host memory)
    ds.feat = ds.feat.to(dev)
    indptr, indices = ds.graph.indptr, ds.graph.indices
    num_edge = indices.numel()
    deg = indptr[1:] - indptr[:-1]
    hubs = deg > spmm_ops.HUB_CAP
    edge_cols = indices.long()
    # the distinct rows a layer reads: each input read once
    in_edges = torch.bincount(edge_cols, minlength=NUM_NODE)
    src_rows = int((in_edges > 0).sum())
    print(f"{tag} inference graph: {NUM_NODE} nodes, {num_edge} edges "
          f"({src_rows} distinct rows read), largest degree "
          f"{int(deg.max())}; {int(hubs.sum())} rows past HUB_CAP "
          f"{spmm_ops.HUB_CAP} hold {int(deg[hubs].sum())} edges "
          f"({float(deg[hubs].sum()) / num_edge:.4f})", flush=True)
    # the yardsticks' structure: cuSPARSE's CSR of ones, the row of each
    # edge; built once, outside every timing
    csr_ones = torch.sparse_csr_tensor(
        indptr, indices, torch.ones(num_edge, device=dev),
        (NUM_NODE, NUM_NODE))
    inv_deg = inverse_degree(indptr, NUM_NODE)[:, None]
    edge_rows = torch.repeat_interleave(
        torch.arange(NUM_NODE, device=dev), deg.long(),
        output_size=num_edge)
    csr_bytes = num_edge * 4 + (NUM_NODE + 1) * 4

    # the same graph with the rows past HUB_CAP emptied: what the rows
    # kernel takes for the rest
    no_hub_indptr = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=dev),
        torch.cumsum(torch.where(hubs, 0, deg), 0).to(torch.int32)])
    no_hub_indices = indices[~hubs[edge_rows]].contiguous()

    def hub_split(fn_on, name):
        """The call's device ms with every row on the rows kernel (HUB_CAP
        past the largest degree: no hub kernel) and over the graph without
        the hub rows, beside the call as it runs."""
        cap = spmm_ops.HUB_CAP
        spmm_ops.HUB_CAP = 2**31 - 1
        try:
            flat_ms = time_ms(torch, lambda: fn_on(indptr, indices), reps=3,
                              host_ahead=True)
        finally:
            spmm_ops.HUB_CAP = cap
        rest_ms = time_ms(torch, lambda: fn_on(no_hub_indptr, no_hub_indices),
                          reps=3, host_ahead=True)
        print(f"{tag} {name}: every row on the rows kernel (no hub kernel) "
              f"{flat_ms:.4f} ms; the {int(hubs.sum())} hub rows excluded "
              f"{rest_ms:.4f} ms", flush=True)
        return {"no_hub_kernel_ms": flat_ms, "hubs_excluded_ms": rest_ms}

    def spmm_case(path, layer, h, mean):
        f = h.shape[1]
        form = "mean" if mean else "sum"

        def fn_on(ip, ix):
            return spmm_csr(ip, ix, h, num_node=NUM_NODE, mean=mean)

        def fn():
            return fn_on(indptr, indices)

        def plain():
            return spmm_csr_plain(indptr, indices, h, num_node=NUM_NODE,
                                  mean=mean)

        def library():
            out = torch.sparse.mm(csr_ones, h)
            return out * inv_deg if mean else out

        out, again, ref = fn(), fn(), plain()
        mass = spmm_csr_plain(indptr, indices, h.abs(), num_node=NUM_NODE,
                              mean=mean)
        torch.cuda.synchronize()
        assert_agg_close(f"spmm_csr ({path} layer {layer})", out, ref, mass)
        equal = torch.equal(out, again)
        if not equal:
            raise AssertionError(f"spmm_csr ({path} layer {layer}): two "
                                 "launches differ")
        lib_err = max_err(library(), out)
        del again, mass
        record("spmm_csr", "xgnn_tpu_torch/csrc/spmm.cu",
               "xgnn_tpu/ops/spmm.py:29-72 (spmm_csr; the plan's "
               "spmm_csr_planned :437-483)",
               f"{form}, {path} layer {layer}: ({NUM_NODE}, {num_edge}) CSR "
               f"over ({h.shape[0]}, {f}) f32",
               max_err(out, ref), "1e-5 of the aggregate of |h|", fn, plain,
               library,
               "torch.sparse.mm(sparse_csr_tensor(indptr, indices, ones), h)"
               " (cuSPARSE)" + (" times 1/max(deg, 1)" if mean else ""),
               nbytes=src_rows * f * 4 + csr_bytes + NUM_NODE * f * 4,
               flops=num_edge * f + (NUM_NODE * f if mean else 0),
               per_step=3, path=f"inference_{path}",
               pick_nbytes=num_edge * f * 4 + csr_bytes + NUM_NODE * f * 4,
               plain_reps=1)
        kernels[-1].update(bit_equal=equal, library_max_abs_err=lib_err,
                           **hub_split(fn_on, f"spmm_csr {form} F={f}"))
        print(f"{tag} spmm_csr {form} F={f}: two launches equal bit for "
              f"bit; per-pick bound {kernels[-1]['per_pick_bound_ms']:.4f} "
              f"ms; the library's max abs err {lib_err:.3e}", flush=True)

    def gat_library(feat, el, er):
        """The composition: each edge's scores, their row max
        (scatter_reduce amax), the weights, their row sums, then a CSR
        sparse.mm a head with the weights as values."""
        heads = feat.shape[1]
        e = F.leaky_relu(el[edge_rows] + er[edge_cols], 0.2)
        m = torch.full((NUM_NODE, heads), -1e30, device=dev).scatter_reduce_(
            0, edge_rows[:, None].expand_as(e), e, "amax")
        w = torch.exp(e - m[edge_rows])
        den = torch.zeros((NUM_NODE, heads), device=dev).index_add_(
            0, edge_rows, w)
        out = torch.stack([torch.sparse.mm(torch.sparse_csr_tensor(
            indptr, indices, w[:, k].contiguous(), (NUM_NODE, NUM_NODE)),
            feat[:, k]) for k in range(heads)], 1)
        return out / torch.clamp(den, min=1e-9)[..., None]

    def gat_case(path, layer, feat, el, er):
        _, heads, d = feat.shape

        def fn_on(ip, ix):
            return gat_aggregate_csr(ip, ix, feat, el, er, num_node=NUM_NODE)

        def fn():
            return fn_on(indptr, indices)

        def plain():
            return gat_aggregate_csr_plain(indptr, indices, feat, el, er,
                                           num_node=NUM_NODE)

        out, again, ref = fn(), fn(), plain()
        mass = gat_aggregate_csr_plain(indptr, indices, feat.abs(), el, er,
                                       num_node=NUM_NODE)
        torch.cuda.synchronize()
        assert_agg_close(f"gat_aggregate_csr ({path} layer {layer})", out,
                         ref, mass)
        equal = torch.equal(out, again)
        if not equal:
            raise AssertionError(f"gat_aggregate_csr ({path} layer "
                                 f"{layer}): two launches differ")
        lib_err = max_err(gat_library(feat, el, er), out)
        del again, mass
        row = heads * d + heads  # a feat row and its er words
        # each edge's feat row as the 32-byte sectors it spans; el, er (in
        # the L2), the CSR and the output once
        first = (feat.data_ptr() % 32
                 + torch.arange(NUM_NODE, device=dev) * (heads * d * 4))
        sectors = (first + heads * d * 4 - 1) // 32 - first // 32 + 1
        sector_bytes = (32 * int((in_edges * sectors).sum()) + csr_bytes
                        + NUM_NODE * heads * (2 + d) * 4)
        record("gat_aggregate_csr", "xgnn_tpu_torch/csrc/spmm.cu",
               "xgnn_tpu/ops/spmm.py:114-177 (gat_aggregate_csr with "
               "segment_max_csr :75-111; the plan's gat_aggregate_planned "
               ":617-691)",
               f"{path} layer {layer}: ({NUM_NODE}, {num_edge}) CSR over "
               f"({feat.shape[0]}, {heads}, {d}) f32",
               max_err(out, ref),
               "1e-5 of the softmax-weighted aggregate of |feat|", fn, plain,
               lambda: gat_library(feat, el, er),
               "scores by index, scatter_reduce amax, exp, index_add_, then "
               "a CSR torch.sparse.mm a head with the weights as values",
               nbytes=(src_rows * row + NUM_NODE * heads) * 4 + csr_bytes
               + NUM_NODE * heads * d * 4,
               # a product and an add an element; a score, an exp and the
               # sum's add a head
               flops=num_edge * heads * (2 * d + 4),
               per_step=3, path=f"inference_{path}",
               pick_nbytes=(num_edge * row + NUM_NODE * heads) * 4
               + csr_bytes + NUM_NODE * heads * d * 4,
               plain_reps=1)
        kernels[-1].update(bit_equal=equal, library_max_abs_err=lib_err,
                           sector_bound_ms=bound_ms(sector_bytes, 0)[0],
                           **hub_split(fn_on, f"gat_aggregate_csr ({heads}, "
                                              f"{d})"))
        print(f"{tag} gat_aggregate_csr ({heads}, {d}): two launches equal "
              f"bit for bit; per-pick bound "
              f"{kernels[-1]['per_pick_bound_ms']:.4f} ms, sector floor "
              f"{kernels[-1]['sector_bound_ms']:.4f} ms; the "
              f"composition's max abs err {lib_err:.3e}", flush=True)

    def traced_inference(model):
        """One inference queued while the card sleeps, so that its events
        read the card's time alone: the arguments of each K6 call, and
        the device ms of each and of the whole inference."""
        calls, marks = [], []
        real = inference_mod.spmm_csr, inference_mod.gat_aggregate_csr

        def traced(fn):
            def wrapped(*args, **kw):
                calls.append((args, kw))
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                out = fn(*args, **kw)
                ev[1].record()
                marks.append(ev)
                return out
            return wrapped

        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        inference_mod.spmm_csr = traced(real[0])
        inference_mod.gat_aggregate_csr = traced(real[1])
        try:
            torch.cuda._sleep(1_000_000_000)  # about 0.5 s
            start.record()
            full_graph_inference(model, indptr, indices, ds.feat)
            end.record()
            if start.query():
                raise AssertionError("traced inference: the host was not "
                                     "ahead of the card")
        finally:
            inference_mod.spmm_csr, inference_mod.gat_aggregate_csr = real
        torch.cuda.synchronize()
        return (calls, [a.elapsed_time(b) for a, b in marks],
                start.elapsed_time(end))

    # the layers whose shapes K6 is recorded at (graphsage's layer 2 and
    # pinsage's two share graphsage's layer 1 and 0 shapes; gat8's layer 2
    # gat1's)
    recorded_layers = {"graphsage": (0, 1), "gcn": (0, 2), "gat1": (0, 2),
                       "gat8": (0,), "pinsage": ()}
    for path in ("graphsage", "gcn", "gat1", "gat8", "pinsage"):
        mcfg, model = trained[path]
        kname = "gat_aggregate_csr" if mcfg.model == "gat" else "spmm_csr"
        num_layers = len(model.layers)
        full_graph_inference(model, indptr, indices, ds.feat)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.LAUNCHES.reset()
        t0 = time.perf_counter()
        logits = full_graph_inference(model, indptr, indices, ds.feat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _build.LAUNCHES.snapshot()
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        counts_by_path[f"inference_{path}"] = counts
        if counts != {kname: num_layers}:
            raise AssertionError(f"inference {path}: launches {counts}")
        if (logits.shape != (NUM_NODE, NUM_CLASS)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError(f"inference {path}: logits "
                                 f"{tuple(logits.shape)} not all finite")
        del logits
        calls, k6_layers, busy = traced_inference(model)
        k6_ms = sum(k6_layers)
        if len(calls) != num_layers:
            raise AssertionError(f"inference {path}: {len(calls)} K6 calls")
        t0 = time.perf_counter()
        acc_valid = evaluate_full(model, indptr, indices, ds.feat, ds.label,
                                  ds.valid_set)
        acc_test = evaluate_full(model, indptr, indices, ds.feat, ds.label,
                                 ds.test_set)
        eval_s = time.perf_counter() - t0
        eng = Engine(ds, mcfg).init()
        eng.model.load_state_dict(model.state_dict())
        t0 = time.perf_counter()
        sampled = eng.evaluate("valid")
        sampled_s = time.perf_counter() - t0
        del eng
        print(f"{tag} inference {path} ({num_layers} layers): "
              f"{wall * 1e3:.3f} ms wall, {busy:.3f} ms on the card alone "
              f"(K6 {k6_ms:.3f} ms: "
              f"{', '.join(f'{t:.3f}' for t in k6_layers)} by layer); "
              f"{num_edge * num_layers / wall:.1f} "
              f"edges aggregated/s; peak {peak:.3f} GiB; launches {counts}; "
              f"evaluate_full valid {acc_valid:.6f} test {acc_test:.6f} "
              f"({eval_s:.3f} s for both); Engine.evaluate('valid') "
              f"{sampled:.6f} ({sampled_s:.3f} s); chance "
              f"{1 / NUM_CLASS:.6f} (uniform random labels)", flush=True)
        inference_rows[path] = {
            "wall_ms": wall * 1e3, "device_ms": busy, "k6_ms": k6_layers,
            "edges_per_s": num_edge * num_layers / wall, "peak_gib": peak,
            "acc_valid": acc_valid, "acc_test": acc_test,
            "sampled_acc_valid": sampled}
        for layer in recorded_layers[path]:
            args, kw = calls[layer]
            if kname == "spmm_csr":
                spmm_case(path, layer, args[2], kw.get("mean", False))
            else:
                gat_case(path, layer, *args[2:5])
        calls = args = kw = None
        torch.cuda.empty_cache()
    print(json.dumps({"inference": inference_rows}), flush=True)

    # ---- 10. tooling: device_loop, K3 under capture, run() and the CLIs ----
    del trained, calls
    torch.cuda.empty_cache()
    tooling_rows = phase_tooling(
        torch, tag, dev, ds, cfg, pin_cfg, steps, expected, host_runs,
        profiled_epoch)
    print(json.dumps({"tooling": tooling_rows}), flush=True)

    # ---- 11. training options: bfloat16, remat, AdamW ----------------------
    torch.cuda.empty_cache()
    bf16 = dict(feat_dtype="bfloat16", compute_dtype="bfloat16")
    labels_only = {"gather_rows": steps}  # K1's 4-byte form: the labels
    sampled = {"sample_khop": 3 * steps, "unique_seeded": 2 * steps}
    expected.update({
        # layer 0 reads the bfloat16 table: its dst rows (K1) and its mean
        # (K4); layers 1 and 2 are float32
        "graphsage_bf16": {**labels_only, "gather_rows_bf16": steps,
                           "fanout_fwd_bf16": steps, "fanout_fwd": 2 * steps,
                           "fanout_bwd": 2 * steps, **sampled},
        # bf16 compute over the float32 table: the whole table cast a
        # step, then the same kernels
        "graphsage_bf16_compute": {**labels_only, "gather_rows_bf16": steps,
                                   "fanout_fwd_bf16": steps,
                                   "fanout_fwd": 2 * steps,
                                   "fanout_bwd": 2 * steps, **sampled},
        "gcn_bf16": {**labels_only, "pick_multiplicity": 3 * steps,
                     "fanout_fwd_bf16": steps, "fanout_fwd": 2 * steps,
                     "fanout_bwd": 2 * steps, **sampled},
        "pinsage_bf16": {"random_walk": 2 * steps, "unique_seeded": steps,
                         **labels_only, "gather_rows_bf16": steps,
                         "fanout_fwd_bf16": steps, "fanout_fwd": steps,
                         "fanout_bwd": steps},
        "mlp_bf16": {**labels_only, "gather_rows_bf16": steps, **sampled},
        # K11 writes bfloat16 rows (its reads round them); x's prefix is
        # layer 0's dst rows
        "graphsage_cached_bf16": {"sample_khop": 3 * steps,
                                  "unique_seeded": 3 * steps,
                                  "tiered_split": steps,
                                  "tiered_direct_bf16": steps,
                                  **labels_only, "fanout_fwd_bf16": steps,
                                  "fanout_fwd": 2 * steps,
                                  "fanout_bwd": 2 * steps},
        # every convolution's forward again in the backward: K1 at layer
        # 0's dst rows and K4 at each layer
        "graphsage_remat": {"gather_rows": 3 * steps,
                            "fanout_fwd": 6 * steps,
                            "fanout_bwd": 2 * steps, **sampled},
        "graphsage_adamw": expected["graphsage"],
    })
    option_rows = {}

    def option_path(path, base, change, per_step, f32_path, dataset=None):
        """A warm-up and a counted epoch (run_epochs) and a profiled one on
        the path's own engine (over ``dataset``, phase 3's by default);
        its busy time a step beside the float32 path's of phase 6 or 8."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        eng = Engine(ds if dataset is None else dataset,
                     dataclasses.replace(base, **change)).init()
        r = run_epochs(path, eng)
        rate_and_memory(path, r, per_step)
        prof = profiled_epoch(path, eng, 2) or {}
        f32 = host_runs[f32_path]
        f32_prof = f32.get("profiled") or {}
        row = {"epoch_s": r["time"], "f32_path": f32_path,
               "f32_epoch_s": f32["time"],
               "busy_ms_per_step": prof.get("busy_ms_per_step"),
               "f32_busy_ms_per_step": f32_prof.get("busy_ms_per_step"),
               "busy_share": prof.get("busy_share"),
               "step_peak_gib": host_runs[path]["step_peak_gib"],
               "f32_step_peak_gib": f32["step_peak_gib"]}
        option_rows[path] = row
        print(f"{tag} {path}: counted epoch {r['time']:.3f} s against "
              f"{f32_path}'s {f32['time']:.3f} s; profiled busy "
              f"{row['busy_ms_per_step']} ms a step against "
              f"{row['f32_busy_ms_per_step']}; peak above the engine "
              f"{row['step_peak_gib']:.3f} GiB against "
              f"{row['f32_step_peak_gib']:.3f}", flush=True)
        return eng

    def same_losses(path, ref_path, hist=None):
        """Epochs 0 and 1 of ``path`` (or ``hist``) against ``ref_path``'s
        per-step losses and accuracies, finite and equal bit for bit: the
        same kernels run in the same order on the same rows."""
        got = hist or host_runs[path]["hist"]
        for epoch in (0, 1):
            for key in ("loss", "acc"):
                a, b = got[epoch][key], host_runs[ref_path]["hist"][epoch][key]
                if not np.all(np.isfinite(a)) or not np.array_equal(a, b):
                    raise AssertionError(
                        f"{path} epoch {epoch}: {key} not bit-equal to "
                        f"{ref_path}'s: {list(a)} against {list(b)}")
        option_rows.setdefault(path, {}).update(losses_as=ref_path,
                                                bit_equal=True)
        print(f"{tag} {path}: epochs 0 and 1 per-step losses and "
              f"accuracies equal {ref_path}'s bit for bit", flush=True)

    # graphsage_bf16: the host loop, then device_loop from the same seeds
    eng = option_path("graphsage_bf16", cfg, bf16, edges_per_step,
                      "graphsage")
    table = eng.feature_source.feat
    if table.dtype != torch.bfloat16:
        raise AssertionError(f"graphsage_bf16: a {table.dtype} table")
    seeds, n = next(Shuffler(ds.train_set, BATCH, seed=7).epoch_batches(0))
    seeds = torch.from_numpy(seeds).to(dev)
    b0 = eng.sampler.sample(seeds, n, generator(dev, 7)).blocks[0]
    width = table.shape[1]
    # K1 over the bfloat16 table at layer 0's dst ids
    ids = b0.dst_ids
    out, ref = gather_rows(table, ids), gather_rows_plain(table, ids)
    torch.cuda.synchronize()
    assert_close("gather_rows_bf16", out, ref, exact=True)
    valid = (ids >= 0) & (ids < table.shape[0])
    n_valid = int(valid.sum())
    safe = torch.where(valid, ids, 0)
    record("gather_rows_bf16", "xgnn_tpu_torch/csrc/gather.cu",
           "xgnn_tpu/ops/pallas_gather.py:85",
           f"{ids.shape[0]} ids ({n_valid} valid) x {tuple(table.shape)} "
           "bf16", max_err(out, ref), "exact",
           lambda: gather_rows(table, ids),
           lambda: gather_rows_plain(table, ids),
           lambda: torch.index_select(table, 0, safe),
           "torch.index_select on the bf16 table, the ids clamped into it",
           nbytes=n_valid * width * 2 + ids.shape[0] * (width * 2 + 4),
           flops=0, per_step=1, path="graphsage_bf16")
    del out, ref, safe, valid

    def fwd16_case(table, blk, weights, path, mean, wname):
        """K4's forward over a bfloat16 or float16 table at a layer-0
        shape, bit for bit against its plain version (the rows upcast,
        summed in the same order); the library yardstick is
        F.embedding_bag over the same table (float32 accumulation, a result
        of the table's type)."""
        s16 = "bf16" if table.dtype == torch.bfloat16 else "f16"
        nb = blk.neigh
        fn, plain = ((masked_mean, masked_mean_plain) if mean
                     else (fanout_reduce, fanout_reduce_plain))
        with torch.no_grad():
            s, d = fn(table, nb, weights)
            s_ref, d_ref = plain(table, nb, weights)
        torch.cuda.synchronize()
        form = "mean" if mean else "sum"
        assert_close(f"fanout_fwd_{s16} {form}", s, s_ref, exact=True)
        assert_close(f"fanout_fwd_{s16} denom", d, d_ref, exact=True)
        valid = (nb >= 0) & (nb < table.shape[0])
        picks, rows_read = int(valid.sum()), distinct_rows(nb, valid)
        clamped = torch.where(valid, nb, 0).long()
        msk = valid.float() if weights is None else valid.float() * weights
        msk_bf = msk.to(table.dtype)

        def library():
            out = F.embedding_bag(clamped, table, mode="sum",
                                  per_sample_weights=msk_bf)
            return out / msk.sum(1, keepdim=True).clamp(min=MEAN_EPS) \
                if mean else out

        other = (nb.numel() * (4 if weights is None else 8)
                 + nb.shape[0] * (width + 1) * 4)
        with torch.no_grad():
            record(f"fanout_fwd_{s16}", "xgnn_tpu_torch/csrc/fanout.cu",
                   "xgnn_tpu/models/gnn.py:"
                   + ("144-147 (masked_mean_stream over fanout_reduce, :62; "
                      "K14 xgnn_tpu/ops/fanout.py:47)" if mean
                      else "62 (K14 xgnn_tpu/ops/fanout.py:47)"),
                   f"{form} form: {tuple(nb.shape)} picks ({picks} valid, "
                   f"{rows_read} distinct rows) over {tuple(table.shape)} "
                   + s16 + ("" if weights is None else f", {wname}"),
                   max(max_err(s, s_ref), max_err(d, d_ref)), "exact",
                   lambda: fn(table, nb, weights),
                   lambda: plain(table, nb, weights), library,
                   f"F.embedding_bag(mode='sum') over the {s16} table (f32 "
                   f"accumulation, a {s16} result)"
                   + (", then / clamp(denom, 1e-9)" if mean else ""),
                   nbytes=rows_read * width * 2 + other,
                   pick_nbytes=picks * width * 2 + other,
                   flops=picks * width * (2 if weights is not None else 1)
                   + (nb.shape[0] * width if mean else 0),
                   per_step=1, path=path)
        del s, d, s_ref, d_ref

    fwd16_case(table, b0, None, "graphsage_bf16", True, "")
    # GCN's layer 0: the sum form with K7's weights
    _, gcn_w = pick_multiplicity(b0.neigh, table.shape[0])
    fwd16_case(table, b0, gcn_w, "gcn_bf16", False, "GCN weights")
    del gcn_w, b0
    dl = Engine(ds, dataclasses.replace(cfg, **bf16, device_loop=True)).init()
    dl_times = [dl.train_epoch(epoch)["time"] for epoch in (0, 1)]
    torch.cuda.synchronize()
    if dl._fused is None or dl._fused.graph is None:
        raise AssertionError("graphsage_bf16 device_loop: no captured step")
    same_losses("graphsage_bf16_device_loop", "graphsage_bf16",
                [dl.history[0], dl.history[1]])
    option_rows["graphsage_bf16"]["device_loop_epoch_s"] = dl_times[1]
    print(f"{tag} graphsage_bf16 device_loop: epoch 1 {dl_times[1]:.6f} s "
          f"against the host loop's "
          f"{host_runs['graphsage_bf16']['time']:.6f} s", flush=True)
    del dl, eng, table
    # compute_dtype alone: the float32 table cast to bfloat16 every step
    # (as JAX casts it), the rows of the bfloat16 table's path
    option_path("graphsage_bf16_compute", cfg,
                dict(compute_dtype="bfloat16"), edges_per_step, "graphsage")
    same_losses("graphsage_bf16_compute", "graphsage_bf16")

    # gcn, pinsage and mlp over the bfloat16 table
    option_path("gcn_bf16", cfg, dict(model="gcn", **bf16), edges_per_step,
                "gcn")
    eng = option_path("pinsage_bf16", pin_cfg, bf16, pin_edges, "pinsage")
    table = eng.feature_source.feat
    pb0 = eng.sampler.sample(seeds, n, generator(dev, 7)).blocks[0]
    fwd16_case(table, pb0, pb0.weights, "pinsage_bf16", True,
               "the walk's visit counts")
    del eng, pb0, table
    option_path("mlp_bf16", cfg, dict(model="mlp", **bf16), edges_per_step,
                "mlp")

    # graphsage_cached_bf16: a bfloat16 cache, K11 rounding the misses
    eng = option_path("graphsage_cached_bf16", ccfg, bf16, c_edges,
                      "graphsage_cached")
    store = eng.feature_source
    if (store.cache_feat.dtype != torch.bfloat16
            or store.feat_host.dtype != torch.float32):
        raise AssertionError("graphsage_cached_bf16: a cache of "
                             f"{store.cache_feat.dtype}, a host table of "
                             f"{store.feat_host.dtype}")
    hist = eng.history[1]
    hit_rate = float(hist["hit"].sum() / (hist["hit"].sum()
                                          + hist["miss"].sum()))
    option_rows["graphsage_cached_bf16"]["hit_rate"] = hit_rate
    print(f"{tag} graphsage_cached_bf16 epoch 1: hit rate {hit_rate:.6f}; "
          f"per step {np.mean(hist['hit']):.1f} hits, "
          f"{np.mean(hist['miss']):.1f} misses, "
          f"{np.mean(hist['miss']) * width * 4:.1f} miss bytes (the "
          "host's float32)", flush=True)
    cb = eng.sampler.sample(seeds, n, generator(dev, 7))
    c_ids, c_num = cb.input_nodes, cb.num_input
    out, counts = tiered_extract(c_ids, c_num, store.posmap, store.cache_feat,
                                 store.host)
    ref, ref_counts = tiered_extract_plain(c_ids, c_num, store.posmap,
                                           store.cache_feat, store.feat_host)
    torch.cuda.synchronize()
    assert_close("tiered_extract bf16", out, ref, exact=True)
    if not torch.equal(counts, ref_counts):
        raise AssertionError("tiered_extract bf16: counts differ")
    del out, ref
    p_out, p_counts, p_pos, p_ids = tiered_split_plain(
        c_ids, c_num, store.posmap, store.cache_feat, store.feat_host)
    misses = int(p_counts[1])
    got = tiered_direct(p_out.clone(), p_ids, p_pos, p_counts, store.host)
    ref = tiered_direct_plain(p_out.clone(), p_ids, p_pos, misses,
                              store.feat_host)
    torch.cuda.synchronize()
    assert_close("tiered_direct_bf16", got, ref, exact=True)
    d_err = max_err(got, ref)
    del got, ref
    d_out = p_out.clone()
    pcie = misses * width * 4  # the host's float32 rows
    d_hbm_ms = (misses * (width * 2 + 8) + 4) / HBM_BYTES_PER_S * 1e3
    pcie_ms = pcie / pcie_rate * 1e3
    record("tiered_direct_bf16", "xgnn_tpu_torch/csrc/tiered.cu",
           "xgnn_tpu/store/feature_store.py:111-118 (_combine_kernel's "
           "astype) and 217-250 (the host gather, the copy)",
           f"{misses} miss rows of {width} f32 from a ({NUM_NODE}, {width}) "
           f"mapped host table, rounded into ({c_ids.numel()}, {width}) "
           "bf16", d_err, "exact",
           lambda: tiered_direct(d_out, p_ids, p_pos, p_counts, store.host),
           lambda: tiered_direct_plain(d_out, p_ids, p_pos, misses,
                                       store.feat_host),
           None, "none: no one PyTorch call reads a mapped host table",
           nbytes=0, flops=0, per_step=1, path="graphsage_cached_bf16",
           plain_reps=3, bound=max((d_hbm_ms, "bytes"), (pcie_ms, "bytes")))
    kernels[-1].update(pcie_bound_ms=pcie_ms, pcie_bytes=pcie,
                       pcie_bytes_per_s=pcie / kernels[-1]["device_ms"] * 1e3)
    del eng, store, cb, c_ids, p_out, p_pos, p_ids, d_out, hist

    # remat at float32: phase 6's kernels in phase 6's order, so phase 6's
    # losses; AdamW.  (agg_impl builds the same model whatever its value:
    # K4 computes every formulation, tests/test_torch_port_options.py)
    for path, change in (("graphsage_remat", dict(remat=True)),
                         ("graphsage_adamw", dict(weight_decay=5e-4))):
        option_path(path, cfg, change, edges_per_step, "graphsage")
        if path != "graphsage_adamw":
            same_losses(path, "graphsage")
    print(json.dumps({"options": option_rows}), flush=True)

    # ---- 12. the tiered topology: the hot CSR prefix on the card, the cold
    # rows read in place from mapped host memory -----------------------------
    torch.cuda.empty_cache()
    g = ds.graph
    # the weighted samplers' tables for phase 7's edge weights, on the card
    w = edge_weights(g.num_edge, 0, dev)
    g.prob_prefix_table = prefix_table(g.indptr, w)
    g.coarse_cdf = build_coarse_cdf(g.indptr, g.prob_prefix_table,
                                    g.num_node)
    g.prob_table, g.alias_table = alias_tables(g.indptr, g.indices, w)
    del w
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hot, tier, n_all = make_tiered_topology(
        g.indptr, g.indices, TIER_PCT, SampleType.WEIGHTED_KHOP,
        prob_table=g.prob_table, alias_table=g.alias_table,
        prob_prefix_table=g.prob_prefix_table, device=dev)
    torch.cuda.synchronize()
    tier_s = time.perf_counter() - t0
    ncn = tier.num_cache_node
    host_bytes = sum(a.tensor.numel() * a.tensor.element_size()
                     for a in tier.csr.arrays.values())
    print(f"{tag} tiered topology at {TIER_PCT}: hot prefix {ncn} of "
          f"{n_all} nodes, {hot.num_edge} of {g.num_edge} edges on the card "
          f"(its alias, prefix and coarse CDF tables too); the whole CSR "
          f"and tables ({host_bytes} bytes) pulled, pinned and mapped in "
          f"{tier_s:.3f} s", flush=True)
    if not 0 < ncn < n_all:
        raise AssertionError(f"tiered topology: hot prefix {ncn} of {n_all}")
    seeds, n = next(Shuffler(ds.train_set, BATCH, seed=7).epoch_batches(0))
    seeds = torch.from_numpy(seeds).to(dev)
    tier_rows = {}  # cold rows by layer of the batch walked below
    # the card's ceilings for the cold rows' scattered host reads: a
    # sector alone (32-byte reads) and sectors in whole lines (128-byte)
    probe = host_reads.host_read_rates(torch, dev)
    read_rate, line_rate = (host_reads.ceiling(probe, w)["sectors_per_s"]
                            for w in (32, 128))
    print(f"{tag} mapped host reads of a {host_reads.BUFFER_BYTES} byte "
          f"buffer: {host_reads.describe(probe)}; ceilings "
          f"{read_rate / 1e6:.1f}M sectors/s at 32 bytes a read, "
          f"{line_rate / 1e6:.1f}M at 128, against PCIe's rated "
          f"{PCIE_BYTES_PER_S / 32 / 1e6:.1f}M", flush=True)

    edge_pos = torch.arange(g.num_edge, dtype=torch.int32, device=dev)

    def sectors(pos, width):
        """The distinct 32-byte sectors that the elements at ``pos`` of an
        array of ``width``-byte elements span (the array 32-byte aligned)"""
        return int(torch.unique(pos.long() * width // 32).numel())

    def cold_traffic(frontier, k, form, u, coin, out):
        """What a tiered call must move: the hot rows' bytes through HBM
        (the frontier, u and coin, an indptr pair a hot row, an index a hot
        pick, the output) and the distinct 32-byte sectors of host memory
        that the cold rows read (a host read goes through L2, so a sector
        crosses the link once a call): the int64 indptr pair of each cold
        row; then per form, at the positions this run's uniforms give, an
        index a pick (khop, wr); a prob and an alias or an index a draw,
        and a row of at most K entries whole (alias, dedup); the total and
        every entry that the binary searches of a row's picks read, and an
        index a pick (prefix).  The positions are found on the whole graph
        on the card (``g``), the same rows at the same offsets, and held
        to the call's cold picks.  Returns (hot bytes, cold sectors, hot
        rows, cold rows)."""
        ok = (frontier >= 0) & (frontier < n_all)
        cold = ok & (frontier >= ncn)
        v = frontier[cold].long()
        start = g.indptr[v].long()
        deg = g.indptr[v + 1].long() - start
        n_sec = sectors(torch.cat([v, v + 1]), 8)
        uc = u[cold]
        if form in ("khop", "wr"):
            fn = sample_khop0_plain if form == "khop" else (
                sample_uniform_wr_plain)
            pos = fn(g.indptr, edge_pos, frontier[cold], k, u=uc)
            picked = pos != empty
            # khop1's picks are sorted and deduplicated: K2's are the reads
            if form == "khop" and not torch.equal(torch.where(
                    picked, g.indices[torch.where(picked, pos, 0)], empty),
                    out[cold]):
                raise AssertionError("cold_traffic: khop positions")
            n_sec += sectors(pos[picked], 4)
        elif form in ("alias", "dedup"):
            cc = coin[cold]
            drawn = deg > k if form == "dedup" else deg > 0
            d, st = deg[drawn, None], start[drawn, None]
            slot = torch.minimum(torch.floor(uc[drawn] * d).long(), d - 1)
            e = (st + slot).reshape(-1)
            take = (cc[drawn].reshape(-1) >= g.prob_table[e])
            if form == "alias" and not torch.equal(torch.where(
                    take, g.alias_table[e], g.indices[e]),
                    out[cold][drawn].reshape(-1)):
                raise AssertionError("cold_traffic: alias positions")
            whole = (deg > 0) & ~drawn
            rows_e = start[whole].repeat_interleave(deg[whole]) + (
                torch.arange(int(deg[whole].sum()), device=dev)
                - torch.repeat_interleave(
                    torch.cumsum(deg[whole], 0) - deg[whole], deg[whole]))
            n_sec += (sectors(e, 4) + sectors(e[take], 4)
                      + sectors(torch.cat([e[~take], rows_e]), 4))
        else:  # prefix
            live = deg > 0
            st, d = start[live, None], deg[live, None]
            pf = g.prob_prefix_table
            total = pf[st + d - 1]
            x = uc[live] * total
            lo = torch.zeros_like(x, dtype=torch.long)
            hi = (d - 1).expand_as(lo).clone()
            read = [(st + d - 1).reshape(-1)]
            while True:
                act = lo < hi
                if not bool(act.any()):
                    break
                mid = (lo + hi) >> 1
                at = (st + mid)[act]
                read.append(at)
                up = torch.zeros_like(act)
                up[act] = pf[at] <= x[act]
                lo = torch.where(up, mid + 1, lo)
                hi = torch.where(act & ~up, mid, hi)
            if not torch.equal(g.indices[st + lo], out[cold][live]):
                raise AssertionError("cold_traffic: prefix positions")
            n_sec += (sectors(torch.cat(read), 4)
                      + sectors((st + lo).reshape(-1), 4))
        hot_rows = int((ok & ~cold).sum())
        hot_picks = int(((out != empty) & ~cold[:, None]).sum())
        u_bytes = (u.numel() + (0 if coin is None else coin.numel())) * 4
        nbytes = (frontier.numel() * 4 + u_bytes + out.numel() * 4
                  + hot_rows * 8 + hot_picks * 4)
        return nbytes, n_sec, hot_rows, int(cold.sum())

    def prefix_design_sectors(frontier, k, u):
        """The distinct 32-byte sectors of host memory that K8b-prefix's
        cold branch reads: each cold row's int64 indptr pair; a row of at
        most 128 entries whole, a longer row its coarse row (the prefix at
        coarse_pos) and each pick's bucket; an index a pick."""
        ok = (frontier >= 0) & (frontier < n_all)
        cold = ok & (frontier >= ncn)
        v = frontier[cold].long()
        start = g.indptr[v].long()
        deg = g.indptr[v + 1].long() - start
        pf = g.prob_prefix_table
        pos = [torch.cat([v, v + 1])]
        short = (deg > 0) & (deg <= 128)
        d, st = deg[short], start[short]
        pos.append(st.repeat_interleave(d) + (
            torch.arange(int(d.sum()), device=dev)
            - torch.repeat_interleave(torch.cumsum(d, 0) - d, d)))
        hub = deg > 128
        d, st = deg[hub, None], start[hub, None]
        j = torch.arange(128, device=dev)[None, :]
        q, r = d // 128, d % 128
        cpos = ((j + 1) * q + ((j + 1) * r + 127) // 128 - 1).clamp(
            max=d - 1)
        pos.append((st + cpos).reshape(-1))
        x = u[cold][hub] * pf[st + d - 1]
        cval = pf[st + cpos]
        jj = (cval[:, None, :] <= x[:, :, None]).sum(-1).clamp(max=127)
        lo = torch.where(jj > 0, cpos.gather(1, (jj - 1).clamp(min=0)) + 1, 0)
        hi = cpos.gather(1, jj)
        n_b = (hi - lo + 1).reshape(-1)
        pos.append((st + lo).reshape(-1).repeat_interleave(n_b) + (
            torch.arange(int(n_b.sum()), device=dev)
            - torch.repeat_interleave(torch.cumsum(n_b, 0) - n_b, n_b)))
        n_sec = sectors(pos[0], 8) + sectors(torch.cat(pos[1:]), 4)
        # an index a pick, at the pick's offset: found by the plain search
        live = deg > 0
        st, d = start[live, None], deg[live, None]
        xs = u[cold][live] * pf[st + d - 1]
        off = torch.zeros_like(xs, dtype=torch.long)
        hi_ = (d - 1).expand_as(off).clone()
        while True:
            act = off < hi_
            if not bool(act.any()):
                break
            mid = (off + hi_) >> 1
            up = pf[st + mid] <= xs
            off = torch.where(act & up, mid + 1, off)
            hi_ = torch.where(act & ~up, mid, hi_)
        return n_sec + sectors((st + off).reshape(-1), 4)

    def walk_tier_traffic(frontier, uw):
        """K9's hot bytes (as walk_traffic counts them, for the walker-steps
        from hot nodes) and the distinct 32-byte sectors of host memory its
        cold steps read (the int64 indptr pair of each cold node stood on,
        and the index each step from a cold node of degree > 0 reads), with
        the hot and cold walker-steps."""
        u_step, u_restart = uw
        ip, ix = g.indptr, g.indices
        seed = frontier[:, None].expand(-1, num_walk)
        cur, hot_on, hot_live, cold_on = seed, 0, 0, 0
        nodes, picks = [], []
        for step in range(walk_len):
            if step:
                cur = torch.where(u_restart[step] < restart, seed, cur)
            ok = (cur >= 0) & (cur < n_all)
            node = torch.where(ok, cur, 0)
            start = ip[node]
            deg = torch.where(ok, ip[node + 1] - start, 0)
            off = torch.minimum(torch.floor(u_step[step] * deg).int(),
                                torch.clamp(deg - 1, min=0))
            nxt = torch.where(deg > 0, ix[torch.where(deg > 0, start + off,
                                                      0)], empty)
            cold = ok & (node >= ncn)
            hot_on += int((ok & ~cold).sum())
            hot_live += int(((deg > 0) & ~cold).sum())
            cold_on += int(cold.sum())
            nodes.append(node[cold])
            picks.append((start + off)[cold & (deg > 0)])
            cur = torch.where(nxt == empty, seed, nxt)
        v = torch.cat(nodes).long()
        n_sec = sectors(torch.cat([v, v + 1]), 8) + sectors(
            torch.cat(picks), 4)
        b = frontier.numel()
        fixed = (b * 4 + (2 * walk_len - 1) * b * num_walk * 4
                 + b * NUM_NEIGHBOR * 8)
        return fixed + hot_on * 8 + hot_live * 4, n_sec, hot_on, cold_on

    def tier_case(name, form, layer, frontier, k, fn, plain, whole, u,
                  coin, replaces, path, per_step, detail="", traffic=None,
                  design=None, requests=None):
        """A tiered call held to its plain version (the cold rows read on
        the host) and to the untiered kernel over the whole CSR on the card
        at the same uniforms, exact; timed beside the untiered call, with
        its bound: the larger of its hot bytes over HBM and its cold
        sectors over PCIe; beside it those sectors over the measured
        ceiling, ``design()``: the sectors its design reads (the bound's
        own where not given), and ``requests()``: the requests to host
        memory that its warp design sends in ``tools/cold_requests.py``'s
        model, printed and not kept.  Its device ms is also timed with L2
        flushed before each launch (``time_flushed_ms``)."""
        got, ref, full = fn(), plain(), whole()
        torch.cuda.synchronize()
        pairs = (list(zip(got, ref, full)) if isinstance(got, tuple)
                 else [(got, ref, full)])
        for a, b, c in pairs:
            assert_close(f"{name} (tiered)", a, b, exact=True)
            if not torch.equal(a, c):
                raise AssertionError(f"{name} (tiered): differs from the "
                                     "untiered kernel over the whole CSR")
        out = got[0] if isinstance(got, tuple) else got
        nbytes, sectors, hot_rows, cold_rows = (
            cold_traffic(frontier, k, form, u, coin, out) if traffic is None
            else traffic())
        hbm_ms = nbytes / HBM_BYTES_PER_S * 1e3
        pcie_ms = sectors * 32 / pcie_rate * 1e3
        record(name, f"xgnn_tpu_torch/csrc/{SOURCES[name]}", replaces,
               f"tiered {TIER_PCT}{detail}, layer {layer}: frontier "
               f"{frontier.shape[0]} ({hot_rows} hot, {cold_rows} cold rows) "
               f"x K={k}, {int((out != empty).sum())} picks",
               max(max_err(a, b) for a, b, _ in pairs), "exact", fn, plain,
               None, None, nbytes=nbytes, flops=0, per_step=per_step,
               path=path, plain_reps=1,
               bound=max((hbm_ms, "bytes"), (pcie_ms, "bytes")))
        untiered_ms = time_ms(torch, whole, host_ahead=True)
        flushed_ms = time_flushed_ms(torch, fn)
        design_sectors = sectors if design is None else design()
        kernels[-1].update(tiered=True, hot_rows=hot_rows,
                           cold_rows=cold_rows, cold_sectors=sectors,
                           hbm_bound_ms=hbm_ms, pcie_bound_ms=pcie_ms,
                           ceiling_ms=sectors / read_rate * 1e3,
                           line_ceiling_ms=sectors / line_rate * 1e3,
                           design_sectors=design_sectors,
                           design_ceiling_ms=design_sectors / read_rate * 1e3,
                           design_line_ceiling_ms=(design_sectors / line_rate
                                                   * 1e3),
                           untiered_device_ms=untiered_ms,
                           flushed_device_ms=flushed_ms)
        print(f"{tag} {name} (tiered) layer {layer}: {cold_rows} cold rows, "
              f"{sectors} sectors from host memory; "
              f"{kernels[-1]['device_ms']:.4f} ms on the card alone "
              f"({flushed_ms:.4f} ms a launch with L2 flushed) against "
              f"the untiered call's {untiered_ms:.4f} ms at the same "
              f"frontier; bound HBM {hbm_ms:.4f} ms, PCIe {pcie_ms:.4f} ms; "
              f"at the measured ceilings {kernels[-1]['ceiling_ms']:.4f} ms "
              f"(32-byte reads) / {kernels[-1]['line_ceiling_ms']:.4f} ms "
              f"(128-byte); the design reads {design_sectors} sectors "
              f"({kernels[-1]['design_ceiling_ms']:.4f} / "
              f"{kernels[-1]['design_line_ceiling_ms']:.4f} ms)"
              + ("" if requests is None else
                 f"; {requests()} requests to host memory in the model of "
                 "tools/cold_requests.py"),
              flush=True)
        return got

    # K2, K8a, K8b (three forms) at the three layers' frontiers of one
    # batch, walked through K3 as the sampler walks it
    frontier = seeds
    num = torch.full((), n, dtype=torch.int32, device=dev)
    for layer, k in enumerate(FANOUT):
        b = frontier.shape[0]
        u = torch.rand((b, k), generator=gen, device=dev)
        coin = torch.rand((b, k), generator=gen, device=dev)
        m = HASH_DEDUP_ROUNDS * k
        um = torch.rand((b, m), generator=gen, device=dev)
        cm = torch.rand((b, m), generator=gen, device=dev)
        f_, uk = frontier, u
        nbr = tier_case(
            "sample_khop", "khop", layer, f_, k,
            lambda: sample_khop0(hot.indptr, hot.indices, f_, k, u=uk,
                                 tier=tier),
            lambda: sample_khop0_plain(hot.indptr, hot.indices, f_, k, u=uk,
                                       tier=tier),
            lambda: sample_khop0(g.indptr, g.indices, f_, k, u=uk),
            uk, None, "xgnn_tpu/ops/sampling.py:144",
            "graphsage_tiered", 3)
        tier_rows[layer] = kernels[-1]["cold_rows"]
        wr, wr_ref = (sample_uniform_wr(hot.indptr, hot.indices, f_, k, u=uk,
                                        tier=tier),
                      sample_uniform_wr_plain(hot.indptr, hot.indices, f_, k,
                                              u=uk, tier=tier))
        torch.cuda.synchronize()
        assert_close("sample_wr (uniform_wr, tiered)", wr, wr_ref,
                     exact=True)
        del wr, wr_ref
        tier_case(
            "sample_wr", "wr", layer, f_, k,
            lambda: sample_khop1(hot.indptr, hot.indices, f_, k, u=uk,
                                 tier=tier),
            lambda: sample_khop1_plain(hot.indptr, hot.indices, f_, k, u=uk,
                                       tier=tier),
            lambda: sample_khop1(g.indptr, g.indices, f_, k, u=uk),
            uk, None, "xgnn_tpu/ops/sampling.py:130",
            "graphsage_khop1_tiered", 3, ", khop1",
            requests=lambda: cold_requests.wr_requests(
                g.indptr, f_, uk, ncn, n_all))
        pa = (hot.indptr, hot.indices, hot.prob_prefix_table, f_, k, None,
              hot.n_max_deg, hot.coarse_cdf)
        tier_case(
            "sample_prefix", "prefix", layer, f_, k,
            lambda: sample_weighted_khop_prefix(*pa, u=uk, tier=tier),
            lambda: sample_weighted_khop_prefix_plain(*pa, u=uk, tier=tier),
            lambda: sample_weighted_khop_prefix(
                g.indptr, g.indices, g.prob_prefix_table, f_, k, None,
                g.n_max_deg, g.coarse_cdf, u=uk),
            uk, None, "xgnn_tpu/ops/sampling.py:339",
            "graphsage_weighted_prefix_tiered", 3,
            design=lambda: prefix_design_sectors(f_, k, uk))
        for dedup, fn, plain, uu, cc in (
                (False, sample_weighted_khop, sample_weighted_khop_plain, u,
                 coin),
                (True, sample_weighted_khop_hash_dedup,
                 sample_weighted_khop_hash_dedup_plain, um, cm)):
            aa = (hot.indptr, hot.indices, hot.prob_table, hot.alias_table,
                  f_, k)
            tier_case(
                "sample_alias", "dedup" if dedup else "alias", layer, f_, k,
                lambda fn=fn, uu=uu, cc=cc: fn(*aa, u=uu, coin=cc, tier=tier),
                lambda plain=plain, uu=uu, cc=cc: plain(*aa, u=uu, coin=cc,
                                                        tier=tier),
                lambda fn=fn, uu=uu, cc=cc: fn(
                    g.indptr, g.indices, g.prob_table, g.alias_table, f_, k,
                    u=uu, coin=cc),
                uu, cc, "xgnn_tpu/ops/sampling.py:"
                + ("248" if dedup else "217"),
                f"weighted_khop{'_hash_dedup' if dedup else ''} (tiered)", 3,
                ", hash_dedup" if dedup else ", weighted_khop")
        if layer == len(FANOUT) - 1:
            break
        out = unique_seeded_split(frontier, nbr.reshape(-1), num,
                                  CAPS[layer + 1], num_node=n_all)
        frontier, num = out[0], torch.clamp(out[1], max=CAPS[layer + 1])
    del u, coin, um, cm, nbr, out, frontier, f_, uk, edge_pos
    # K9 at PinSAGE's two layers: the seeds, then K3's frontier of their
    # picks
    w_b = seeds.shape[0]
    for layer in range(2):
        wf = seeds if layer == 0 else f1
        uw = random_walk.draw_uniforms(WALK["num_random_walk"],
                                       WALK["random_walk_length"],
                                       wf.shape[0], gen, dev)
        got = tier_case(
            "random_walk", "khop", layer, wf, NUM_NEIGHBOR,
            lambda wf=wf, uw=uw: sample_random_walk(
                hot.indptr, hot.indices, wf, NUM_NEIGHBOR, u=uw, tier=tier,
                **WALK),
            lambda wf=wf, uw=uw: sample_random_walk_plain(
                hot.indptr, hot.indices, wf, NUM_NEIGHBOR, u=uw, tier=tier,
                **WALK),
            lambda wf=wf, uw=uw: sample_random_walk(
                g.indptr, g.indices, wf, NUM_NEIGHBOR, u=uw, **WALK),
            uw[0], uw[1], "xgnn_tpu/ops/random_walk.py:38",
            "pinsage_tiered", 2, ", walk W=4 L=3 (rows: hot and cold "
            "walker-steps)",
            traffic=lambda wf=wf, uw=uw: walk_tier_traffic(wf, uw),
            requests=lambda wf=wf, uw=uw: cold_requests.walk_requests(
                g.indptr, g.indices, wf, *uw, WALK["restart_prob"], ncn,
                n_all))
        if layer == 0:
            f1 = unique_seeded_split(
                seeds, got[0].reshape(-1),
                torch.full((), n, dtype=torch.int32, device=dev),
                pin_caps[1], num_node=n_all)[0]
    del f1, got, uw
    print(f"{tag} tiered topology: cold rows of the batch by layer "
          f"{tier_rows}, {sum(tier_rows.values())} a step", flush=True)
    # a whole tiered batch through K2 and K3 equal to the plain path's
    tcfg = dataclasses.replace(cfg, use_dist_graph=True,
                               dist_graph_percentage=TIER_PCT)
    ts = Sampler(hot, tcfg, CAPS, direct_extract=True, tier=tier,
                 num_node=n_all)
    tb = ts.sample(seeds, n, generator(dev, 7))
    assert_plain_batch(ts, tb, sampling, "sample_khop0", sample_khop0_plain,
                       "tiered K2/K3")
    # one batch of each alias form through Sampler.sample
    for st, fn_name, plain in (
            ("weighted_khop", "sample_weighted_khop",
             sample_weighted_khop_plain),
            ("weighted_khop_hash_dedup", "sample_weighted_khop_hash_dedup",
             sample_weighted_khop_hash_dedup_plain)):
        path = f"{st} (tiered)"
        asamp = Sampler(hot, dataclasses.replace(tcfg, sample_type=st),
                        CAPS, direct_extract=True, tier=tier, num_node=n_all)
        _build.LAUNCHES.reset()
        ab = asamp.sample(seeds, n, generator(dev, 7))
        torch.cuda.synchronize()
        counts = _build.LAUNCHES.snapshot()
        want = {"sample_alias": len(FANOUT), "unique_seeded": len(FANOUT) - 1}
        if counts != want:
            raise AssertionError(f"{path}: launch counts {counts} != {want}")
        counts_by_path[path] = counts
        print(f"{tag} {path} batch: "
              f"{sum(int(blk.mask.sum()) for blk in ab.blocks)} edges, "
              f"launches {counts}", flush=True)
        assert_plain_batch(asamp, ab, sampling, fn_name, plain,
                           f"tiered K8b-alias/K3 ({st})")
    del ts, tb, asamp, ab, hot
    tier.csr.close()
    del tier
    g.prob_table = g.alias_table = None
    torch.cuda.empty_cache()

    # the paths: graphsage (its host loop and device_loop), khop1, the
    # weighted prefix (its tables on the dataset's graph) and pinsage, each
    # through Engine.init's own tiered topology
    expected.update({
        "graphsage_tiered": expected["graphsage"],
        "graphsage_khop1_tiered": expected["graphsage_khop1"],
        "graphsage_weighted_prefix_tiered":
            expected["graphsage_weighted_prefix"],
        "pinsage_tiered": expected["pinsage"],
        # the store tiered too: graphsage_cached's kernels
        "graphsage_auto_placement": expected["graphsage_cached"],
    })
    tier_rows_out = {"cold_rows_by_layer": tier_rows, "paths": {}}
    for path, change, base, per_step in (
            ("graphsage_tiered", {}, cfg, edges_per_step),
            ("graphsage_khop1_tiered", dict(sample_type="khop1"), cfg, None),
            ("graphsage_weighted_prefix_tiered",
             dict(sample_type="weighted_khop_prefix"), cfg, None),
            ("pinsage_tiered", {}, pin_cfg, None)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = Engine(ds, dataclasses.replace(
            base, use_dist_graph=True, dist_graph_percentage=TIER_PCT,
            **change)).init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if eng._tier is None or eng.graph.num_node >= eng.sampler.num_node:
            raise AssertionError(f"{path}: the topology did not tier")
        init_items[path] = dict(eng.profiler._init_items, init_s=init_s)
        print(f"{tag} {path} engine init: {init_s:.3f} s (graph load "
              f"{eng.profiler._init_items['graph_load_time']:.3f} s: the "
              f"hot prefix to the card, the whole CSR pinned and mapped); "
              f"hot prefix {eng.graph.num_node} of {eng.sampler.num_node} "
              f"nodes; capacities {eng.sampler.capacities}", flush=True)
        per_step = edges_of(eng.sampler) if per_step is None else per_step
        r = run_epochs(path, eng)
        rate_and_memory(path, r, per_step)
        prof = profiled_epoch(path, eng, 2) or {}
        ref_path = path.replace("_tiered", "")
        ref = host_runs[ref_path]
        row = {"epoch_s": r["time"], "untiered_epoch_s": ref["time"],
               "busy_ms_per_step": prof.get("busy_ms_per_step"),
               "untiered_busy_ms_per_step": (ref.get("profiled") or {}).get(
                   "busy_ms_per_step"),
               "busy_share": prof.get("busy_share"),
               "step_peak_gib": host_runs[path]["step_peak_gib"]}
        tier_rows_out["paths"][path] = row
        print(f"{tag} {path}: counted epoch {r['time']:.3f} s against "
              f"{ref_path}'s {ref['time']:.3f} s; profiled busy "
              f"{row['busy_ms_per_step']} ms a step against "
              f"{row['untiered_busy_ms_per_step']}", flush=True)
        del eng
    # device_loop on the tiered graphsage and pinsage: the cold reads replay
    # inside the captured step; epochs 0 and 1 equal the host loop's bit
    # for bit
    for path, base in (("graphsage_tiered", cfg), ("pinsage_tiered",
                                                   pin_cfg)):
        torch.cuda.empty_cache()
        deng = Engine(ds, dataclasses.replace(
            base, use_dist_graph=True, dist_graph_percentage=TIER_PCT,
            device_loop=True)).init()
        times = []
        for epoch in (0, 1):
            _build.LAUNCHES.reset()
            r = deng.train_epoch(epoch)
            torch.cuda.synchronize()
            times.append(r["time"])
            for key in ("loss", "acc"):
                a = deng.history[epoch][key]
                b = host_runs[path]["hist"][epoch][key]
                if not np.all(np.isfinite(a)) or not np.array_equal(a, b):
                    raise AssertionError(
                        f"{path} device_loop epoch {epoch}: {key} not "
                        f"bit-equal to the host loop's: {list(a)} against "
                        f"{list(b)}")
        if deng._fused is None:
            raise AssertionError(f"{path}: device_loop did not capture")
        tier_rows_out["paths"][path].update(
            device_loop_epoch_s=times[1], device_loop_bit_equal=True)
        print(f"{tag} {path} device_loop: epochs 0 and 1 per-step losses "
              f"and accuracies equal the host loop's bit for bit; counted "
              f"epoch {times[1]:.3f} s against the host loop's "
              f"{host_runs[path]['time']:.3f} s", flush=True)
        del deng
    # auto_placement: the largest budget of these at which the solver
    # tiers the topology; the store tiers too, presampled through the
    # tiered sampler, with its out-of-sample hit estimate
    g.prob_prefix_table = g.coarse_cdf = None
    torch.cuda.empty_cache()
    for budget in (8.0, 4.0, 2.0, 1.5, 1.0, 0.75, 0.5):
        acfg = dataclasses.replace(cfg, auto_placement=True,
                                   hbm_budget_gb=budget)
        solved, plan = resolve_auto_placement(acfg, ds, group_size=1)
        if solved.use_dist_graph and solved.dist_graph_percentage < 1.0:
            break
    else:
        raise AssertionError("auto_placement: no budget tiered the topology")
    t0 = time.perf_counter()
    aeng = Engine(ds, acfg).init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if aeng._tier is None:
        raise AssertionError("graphsage_auto_placement: no tier")
    plan = aeng.placement_plan
    if not aeng._tiered:  # the whole table fits: graphsage's kernels
        expected["graphsage_auto_placement"] = expected["graphsage"]
    print(f"{tag} graphsage_auto_placement at hbm_budget_gb={budget}: "
          f"dist_graph_percentage {aeng.config.dist_graph_percentage}, "
          f"cache_percentage {aeng.config.cache_percentage} (policy "
          f"{aeng.config.cache_policy.value}); plan {plan}; init "
          f"{init_s:.3f} s, presample "
          f"{aeng.init_times.get('presample', 0):.3f} s", flush=True)
    r = run_epochs("graphsage_auto_placement", aeng)
    rate_and_memory("graphsage_auto_placement", r, edges_per_step)
    tier_rows_out["auto_placement"] = {
        "hbm_budget_gb": budget,
        "dist_graph_percentage": aeng.config.dist_graph_percentage,
        "cache_percentage": aeng.config.cache_percentage,
        "expected_topo_hit": plan.expected_topo_hit,
        "expected_feat_hit": plan.expected_feat_hit,
        "epoch_hit_rate": r["hit_rate"], "epoch_s": r["time"]}
    print(f"{tag} graphsage_auto_placement: epoch hit rate "
          f"{r['hit_rate']:.4f} against the presample's out-of-sample "
          f"estimate {plan.expected_feat_hit:.4f}", flush=True)
    del aeng
    print(json.dumps({"tiered_topology": tier_rows_out}), flush=True)

    # ---- 13. dataset files: phase 3's graph written, loaded and trained
    # from; xgnn-convert's tables; the command lines; JAX's host graphs
    torch.cuda.empty_cache()
    files_row = phase_dataset_files(torch, tag, dev, ds, cfg, steps,
                                    expected, host_runs, init_items,
                                    profiled_epoch)
    for path in ("graphsage_alias_files", "graphsage_alias_dedup_files"):
        counts_by_path[path] = files_row["paths"][path]["launches"]
    print(json.dumps({"dataset_files": files_row}), flush=True)

    # ---- 14. the last single-card configurations: GAT under bfloat16, and
    # an F16 feature file trained from and evaluated end to end --------------
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    gcfg = {"gat1": dict(model="gat", num_head=1),
            "gat8": dict(model="gat", num_head=8)}

    def gat16(s):
        """GAT over a 2-byte layer-0 table: its el_dst rows (K1) and K5's
        forward and backward at layer 0 in that type; labels in float32"""
        return {"gather_rows": steps, f"gather_rows_{s}": steps,
                f"attend_fwd_{s}": steps, "attend_fwd": 2 * steps,
                f"attend_bwd_{s}": steps, "attend_bwd": 2 * steps, **sampled}

    expected.update({
        "gat1_bf16": gat16("bf16"), "gat8_bf16": gat16("bf16"),
        # the float32 table cast to bfloat16 every step, as JAX casts it
        "gat1_bf16_compute": gat16("bf16"),
        # the F16 file's float16 table: K1's dst rows, K4's layer-0 mean
        "graphsage_f16_files": {"gather_rows": steps,
                                "gather_rows_f16": steps,
                                "fanout_fwd_f16": steps,
                                "fanout_fwd": 2 * steps,
                                "fanout_bwd": 2 * steps, **sampled},
        "graphsage_f16_widened": expected["graphsage"],
        "gat1_f16_files": gat16("f16"),
        "gat1_f16_widened": expected["gat1"],
        # a float16 cache and host tier: K11 copies the misses' 2-byte rows
        "graphsage_cached_f16_files": {"sample_khop": 3 * steps,
                                       "unique_seeded": 3 * steps,
                                       "tiered_split": steps,
                                       "tiered_direct_f16": steps,
                                       "gather_rows": steps,
                                       "fanout_fwd_f16": steps,
                                       "fanout_fwd": 2 * steps,
                                       "fanout_bwd": 2 * steps},
    })
    seeds, n = next(Shuffler(ds.train_set, BATCH, seed=7).epoch_batches(0))
    seeds = torch.from_numpy(seeds).to(dev)

    def attend16_case(eng, path, heads):
        """K5 over the engine's 2-byte table at layer 0's shape (shared
        mode): the forward and the backward without a table gradient
        bit-equal to the float32 kernels over the same values widened, and
        held to the plain versions at the float32 form's tolerances."""
        t16 = eng.feature_source.feat
        s16 = "bf16" if t16.dtype == torch.bfloat16 else "f16"
        blk = eng.sampler.sample(seeds, n, generator(dev, 7)).blocks[0]
        nb = blk.neigh
        wide = t16.float()
        el, proj = attend_inputs(wide, blk, heads, SHARED)
        if t16.dtype == torch.bfloat16:  # the model rounds wr so
            proj = proj.to(torch.bfloat16).float()
        got = attend_forward(t16, nb, el, proj, SHARED)
        want = attend_forward(wide, nb, el, proj, SHARED)
        ref = attend_forward_plain(t16, nb, el, proj, SHARED)
        torch.cuda.synchronize()
        for what, a, b, c in zip(("out", "m", "s"), got, want, ref):
            assert_close(f"attend_fwd_{s16} {what} against the float32 "
                         "kernel over the widened table", a, b, exact=True)
            assert_close(f"attend_fwd_{s16} {what}", a, c, exact=False)
        fwd_err = max(max_err(a, c) for a, c in zip(got, ref))
        del want, ref
        g_out = torch.randn(got[0].shape, generator=gen, device=dev)
        args = (g_out, t16, nb, el, proj, got[1], got[2], SHARED, False)
        back = attend_backward(*args)
        back_w = attend_backward(g_out, wide, nb, el, proj, got[1], got[2],
                                 SHARED, False)
        back_ref = attend_backward_plain(*args)
        torch.cuda.synchronize()
        for what, a, b in (("g_el_dst", back[1], back_w[1]),
                           ("g_proj", back[2], back_w[2])):
            assert_close(f"attend_bwd_{s16} {what} against the float32 "
                         "kernel over the widened table", a, b, exact=True)
        if not torch.allclose(back[1], back_ref[1], rtol=K5_BWD_TOL,
                              atol=K5_BWD_TOL):
            raise AssertionError(f"attend_bwd_{s16} g_el_dst: kernel "
                                 "disagrees with its plain version (max abs "
                                 f"err {max_err(back[1], back_ref[1])})")
        rel = float((back[2].double() - back_ref[2].double()).norm()
                    / back_ref[2].double().norm())
        if not rel < 1e-5:
            raise AssertionError(f"attend_bwd_{s16} g_proj: relative norm "
                                 f"error {rel} (tolerance 1e-5)")
        bwd_err = max_err(back[1], back_ref[1])
        del back, back_w, back_ref, wide
        picks, valid, per_pick = attend_cost(t16, nb, heads, SHARED)
        rows_read = distinct_rows(nb, valid)
        width = t16.shape[1]
        out_numel = got[0].numel()
        shape = (f"layer 0: {tuple(nb.shape)} picks ({picks} valid, "
                 f"{rows_read} distinct rows) over {tuple(t16.shape)} {s16}, "
                 f"{heads} head(s), shared")
        idx = torch.where(valid, nb, 0).reshape(-1)

        def compose(el_, proj_):
            """the composition of stock ops over the rows widened after
            their gather"""
            d, k = nb.shape
            rows = torch.index_select(t16, 0, idx).float().view(d, k, -1)
            e = F.leaky_relu(el_[:, None, :] + rows @ proj_, 0.2)
            a = torch.nan_to_num(torch.softmax(
                e.masked_fill(~valid[:, :, None], -math.inf), 1))
            return torch.bmm(a.transpose(1, 2), rows)

        other = (nb.numel() * 4 + el.numel() * 4 + proj.numel() * 4
                 + out_numel * 4 + 2 * el.numel() * 4)
        source = (f"xgnn_tpu_torch/csrc/attend.cu (library attend_{s16}: "
                  f"-DXG_ATTEND_ELEM={1 if s16 == 'bf16' else 2})")
        record(f"attend_fwd_{s16}", source, "xgnn_tpu/models/gnn.py:486",
               shape, fwd_err,
               k5_tol + "; bit-equal to the float32 kernel over the widened "
               "table",
               lambda: attend_forward(t16, nb, el, proj, SHARED),
               lambda: attend_forward_plain(t16, nb, el, proj, SHARED),
               lambda: compose(el, proj),
               f"index_select of the {s16} rows, widened -> masked softmax "
               "-> bmm (stock PyTorch ops)",
               nbytes=rows_read * width * 2 + other,
               pick_nbytes=picks * width * 2 + other,
               flops=4 * picks * per_pick, per_step=1, path=path)
        leaves = [el.clone().requires_grad_(True),
                  proj.clone().requires_grad_(True)]
        lib_out = compose(*leaves)
        # g_out, the ids, el_dst, m, s and proj in; g_el_dst and g_proj out
        other = (out_numel * 4 + nb.numel() * 4 + 3 * el.numel() * 4
                 + 2 * proj.numel() * 4 + el.numel() * 4)
        record(f"attend_bwd_{s16}", source, "xgnn_tpu/models/gnn.py:486",
               shape + ", without g_table (layer 0's input)", bwd_err,
               f"g_el_dst rtol/atol {K5_BWD_TOL}; g_proj relative norm "
               "1e-5; bit-equal to the float32 kernel over the widened table",
               lambda: attend_backward(*args),
               lambda: attend_backward_plain(*args),
               lambda: torch.autograd.grad(lib_out, leaves, g_out,
                                           retain_graph=True),
               "torch.autograd.grad of the same composition w.r.t. el_dst "
               "and proj",
               nbytes=rows_read * width * 2 + other,
               pick_nbytes=picks * width * 2 + other,
               # the score, g_out . payload and g_proj: 3 multiply-adds an
               # element
               flops=6 * picks * per_pick, per_step=1, path=path)
        kernels[-1]["g_proj_rel_err"] = rel
        print(f"{tag} {path}: K5 over the {s16} table bit-equal to the "
              "float32 kernels over the widened table, forward and "
              f"backward; g_proj relative norm error {rel:.3e}", flush=True)
        del got, lib_out, leaves, g_out

    # GAT under bfloat16: the table (feat_dtype), and the float32 table cast
    # every step (compute_dtype), beside gat1's and gat8's float32 paths
    for path, f32_path, change in (
            ("gat1_bf16", "gat1", dict(feat_dtype="bfloat16")),
            ("gat8_bf16", "gat8", dict(feat_dtype="bfloat16")),
            ("gat1_bf16_compute", "gat1", dict(compute_dtype="bfloat16"))):
        eng = option_path(path, cfg, {**gcfg[f32_path], **change},
                          edges_per_step, f32_path)
        if "feat_dtype" in change:
            if eng.feature_source.feat.dtype != torch.bfloat16:
                raise AssertionError(f"{path}: a "
                                     f"{eng.feature_source.feat.dtype} table")
            attend16_case(eng, path, eng.config.num_head)
        del eng
    same_losses("gat1_bf16_compute", "gat1_bf16")

    # an F16 directory: phase 3's features rounded to float16, written with
    # the graph into /dev/shm where it has room; deleted at the end
    import contextlib
    import copy
    import io
    import shutil
    import tempfile

    from xgnn_tpu_torch import Dataset, load_dataset, save_dataset
    from xgnn_tpu_torch import constants as xconst
    from xgnn_tpu_torch.checkpoint import CheckpointManager
    from xgnn_tpu_torch.examples import accuracy as accuracy_cli
    from xgnn_tpu_torch.ops.spmm import SEGMENT, spmm_csr_f16_plain

    g = ds.graph
    half = ds.feat.to(dev, torch.float16)
    f16_name = "products_synth_f16"
    need = (4 * (ds.num_node + 1) + 4 * g.num_edge
            + (2 * FEAT_DIM + 12) * ds.num_node)
    shm = (shutil.disk_usage("/dev/shm").free
           if os.path.isdir("/dev/shm") else 0)
    tmp = tempfile.mkdtemp(prefix="xgnn_chip_smoke_f16_",
                           dir="/dev/shm" if shm > need + 2**30 else None)
    f16_dir = os.path.join(tmp, f16_name)
    ckpt16 = os.path.join(tmp, "ckpt")
    f16_row = {"directory": os.path.dirname(tmp), "bytes_needed": need}
    try:
        t0 = time.perf_counter()
        src = Dataset(name=f16_name, num_node=ds.num_node,
                      num_edge=g.num_edge, feat_dim=ds.feat_dim,
                      num_class=ds.num_class, indptr=g.indptr.cpu().numpy(),
                      indices=g.indices.cpu().numpy(), feat=None,
                      label=ds.label.cpu().numpy(),
                      train_set=np.asarray(ds.train_set),
                      valid_set=np.asarray(ds.valid_set),
                      test_set=np.asarray(ds.test_set))
        save_dataset(src, f16_dir)
        half_np = half.cpu().numpy()
        half_np.tofile(os.path.join(f16_dir, xconst.FEAT_FILE))
        meta = os.path.join(f16_dir, xconst.META_FILE)
        with open(meta) as fh:
            text = fh.read()
        with open(meta, "w") as fh:
            fh.write(text.replace(f"{xconst.META_FEAT_DATA_TYPE} F32",
                                  f"{xconst.META_FEAT_DATA_TYPE} F16"))
        del src
        fds = load_dataset(f16_dir)
        if (fds.feat.dtype != np.float16
                or not np.array_equal(np.asarray(fds.feat), half_np)):
            raise AssertionError("F16 directory: the features read back "
                                 "differ from phase 3's rounded")
        f16_row["write_and_load_s"] = time.perf_counter() - t0
        print(f"{tag} F16 directory: phase 3's graph and its features "
              f"rounded to float16 ({half_np.nbytes} bytes against "
              f"{half_np.nbytes * 2} in float32) written and loaded in "
              f"{f16_row['write_and_load_s']:.3f} s under "
              f"{f16_row['directory']}", flush=True)
        del half_np
        # the same graph and values in float32: the widened twin
        wds = copy.copy(ds)
        wds.feat = half.float()
        for path, dataset, change, f32_path in (
                ("graphsage_f16_widened", wds, {}, "graphsage"),
                ("graphsage_f16_files", fds, {}, "graphsage"),
                ("gat1_f16_widened", wds, gcfg["gat1"], "gat1"),
                ("gat1_f16_files", fds, gcfg["gat1"], "gat1")):
            eng = option_path(path, cfg, change, edges_per_step, f32_path,
                              dataset=dataset)
            if path.endswith("_widened"):
                del eng
                continue
            table = eng.feature_source.feat
            if table.dtype != torch.float16:
                raise AssertionError(f"{path}: a {table.dtype} table")
            if path.startswith("gat"):
                attend16_case(eng, path, 1)
                del eng, table
                continue
            CheckpointManager(ckpt16).save(0, (eng.model, eng.opt))
            blk = eng.sampler.sample(seeds, n, generator(dev, 7)).blocks[0]
            ids = blk.dst_ids
            out, ref = gather_rows(table, ids), gather_rows_plain(table, ids)
            torch.cuda.synchronize()
            assert_close("gather_rows_f16", out, ref, exact=True)
            valid = (ids >= 0) & (ids < table.shape[0])
            n_valid = int(valid.sum())
            safe = torch.where(valid, ids, 0)
            width = table.shape[1]
            record("gather_rows_f16", "xgnn_tpu_torch/csrc/gather.cu",
                   "xgnn_tpu/ops/pallas_gather.py:85",
                   f"{ids.shape[0]} ids ({n_valid} valid) x "
                   f"{tuple(table.shape)} f16", max_err(out, ref), "exact",
                   lambda: gather_rows(table, ids),
                   lambda: gather_rows_plain(table, ids),
                   lambda: torch.index_select(table, 0, safe),
                   "torch.index_select on the f16 table, the ids clamped "
                   "into it",
                   nbytes=n_valid * width * 2 + ids.shape[0] * (width * 2 + 4),
                   flops=0, per_step=1, path=path)
            del out, ref, safe, valid
            fwd16_case(table, blk, None, path, True, "")
            del eng, table, blk, ids
        same_losses("graphsage_f16_files", "graphsage_f16_widened")
        same_losses("gat1_f16_files", "gat1_f16_widened")
        del wds

        # the tiered store over the F16 file: a float16 cache and host tier
        eng = option_path("graphsage_cached_f16_files", ccfg, {}, c_edges,
                          "graphsage_cached", dataset=fds)
        store = eng.feature_source
        if (store.cache_feat.dtype != torch.float16
                or store.feat_host.dtype != torch.float16):
            raise AssertionError("graphsage_cached_f16_files: a cache of "
                                 f"{store.cache_feat.dtype}, a host table of "
                                 f"{store.feat_host.dtype}")
        width = store.feat_dim
        hits = {}
        for key, hist in (("f16", eng.history[1]),
                          ("f32", host_runs["graphsage_cached"]["hist"][1])):
            hits[key] = (float(hist["hit"].sum() / (hist["hit"].sum()
                                                    + hist["miss"].sum())),
                         float(np.mean(hist["miss"])))
        f16_row["cached"] = {
            "hit_rate": hits["f16"][0], "f32_hit_rate": hits["f32"][0],
            "miss_bytes_per_step": hits["f16"][1] * width * 2,
            "f32_miss_bytes_per_step": hits["f32"][1] * width * 4}
        cb = eng.sampler.sample(seeds, n, generator(dev, 7))
        c_ids, c_num = cb.input_nodes, cb.num_input
        out, counts = tiered_extract(c_ids, c_num, store.posmap,
                                     store.cache_feat, store.host)
        ref, ref_counts = tiered_extract_plain(c_ids, c_num, store.posmap,
                                               store.cache_feat,
                                               store.feat_host)
        torch.cuda.synchronize()
        assert_close("tiered_extract f16", out, ref, exact=True)
        if not torch.equal(counts, ref_counts):
            raise AssertionError("tiered_extract f16: counts differ")
        del out, ref
        p_out, p_counts, p_pos, p_ids = tiered_split_plain(
            c_ids, c_num, store.posmap, store.cache_feat, store.feat_host)
        misses = int(p_counts[1])
        got = tiered_direct(p_out.clone(), p_ids, p_pos, p_counts,
                            store.host)
        ref = tiered_direct_plain(p_out.clone(), p_ids, p_pos, misses,
                                  store.feat_host)
        torch.cuda.synchronize()
        assert_close("tiered_direct_f16", got, ref, exact=True)
        d_err = max_err(got, ref)
        del got, ref
        d_out = p_out.clone()
        pcie = misses * width * 2  # the host's float16 rows
        d_hbm_ms = (misses * (width * 2 + 8) + 4) / HBM_BYTES_PER_S * 1e3
        pcie_ms = pcie / pcie_rate * 1e3
        record("tiered_direct_f16", "xgnn_tpu_torch/csrc/tiered.cu",
               "xgnn_tpu/store/feature_store.py:111-118 (_combine_kernel) and "
               "217-250 (the host gather, the copy)",
               f"{misses} miss rows of {width} f16 from a ({NUM_NODE}, "
               f"{width}) mapped host table into ({c_ids.numel()}, {width}) "
               "f16", d_err, "exact",
               lambda: tiered_direct(d_out, p_ids, p_pos, p_counts,
                                     store.host),
               lambda: tiered_direct_plain(d_out, p_ids, p_pos, misses,
                                           store.feat_host),
               None, "none: no one PyTorch call reads a mapped host table",
               nbytes=0, flops=0, per_step=1,
               path="graphsage_cached_f16_files", plain_reps=3,
               bound=max((d_hbm_ms, "bytes"), (pcie_ms, "bytes")))
        kernels[-1].update(pcie_bound_ms=pcie_ms, pcie_bytes=pcie,
                           pcie_bytes_per_s=pcie / kernels[-1]["device_ms"]
                           * 1e3)
        f32_direct = [k for k in kernels if k["name"] == "tiered_direct"
                      and k["path"] == "graphsage_cached"]
        f16_row["cached"].update(
            direct_device_ms=kernels[-1]["device_ms"],
            f32_direct_device_ms=(f32_direct[0]["device_ms"]
                                  if f32_direct else None))
        print(f"{tag} graphsage_cached_f16_files epoch 1: hit rate "
              f"{hits['f16'][0]:.6f} against graphsage_cached's "
              f"{hits['f32'][0]:.6f}; miss bytes a step "
              f"{f16_row['cached']['miss_bytes_per_step']:.1f} (2 a value) "
              f"against {f16_row['cached']['f32_miss_bytes_per_step']:.1f}; "
              f"K11's reads {kernels[-1]['device_ms']:.4f} ms on the card "
              f"alone against {f16_row['cached']['f32_direct_device_ms']} "
              "(phase 8's float32 rows)", flush=True)
        del eng, store, cb, c_ids, p_out, p_pos, p_ids, d_out

        # the accuracy command line over the directory, from graphsage_f16_
        # files's checkpoint: K6a's float16 form at layer 0 of each split's
        # full-graph inference
        argv = (["--dataset", f16_name, "--root-path", tmp, "--fanout"]
                + [str(k) for k in FANOUT]
                + ["--num-hidden", str(cfg.num_hidden), "--checkpoint-dir",
                   ckpt16])
        torch.cuda.empty_cache()
        _build.LAUNCHES.reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            accs = accuracy_cli.main(argv)
        torch.cuda.synchronize()
        acc_s = time.perf_counter() - t0
        counts = _build.LAUNCHES.snapshot()
        counts_by_path["inference_f16_files"] = counts
        if counts != {"spmm_csr_f16": 2, "spmm_csr": 4}:
            raise AssertionError(f"accuracy over the F16 directory: "
                                 f"launches {counts}")
        for ln in buf.getvalue().splitlines():
            if ln.startswith("test_result:"):
                print(f"{tag}   {ln}", flush=True)
        if not all(0.0 <= v <= 1.0 for v in accs.values()):
            raise AssertionError(f"accuracy over the F16 directory: {accs}")
        f16_row["accuracy_cli"] = dict(accs, wall_s=acc_s, launches=counts)
        print(f"{tag} accuracy command line over the F16 directory: "
              f"{accs} in {acc_s:.3f} s (the directory loaded, the "
              f"checkpoint restored, two full-graph inferences); launches "
              f"{counts}", flush=True)

        # K6a's float16 form at that layer 0 shape
        indptr, indices = g.indptr, g.indices
        num_edge = indices.numel()
        deg = (indptr[1:] - indptr[:-1]).long()
        in_edges = torch.bincount(indices.long(), minlength=NUM_NODE)
        src_rows = int((in_edges > 0).sum())
        csr_bytes = num_edge * 4 + (NUM_NODE + 1) * 4
        f = half.shape[1]

        def fn():
            return spmm_csr(indptr, indices, half, num_node=NUM_NODE,
                            mean=True)

        def plain():
            return spmm_csr_f16_plain(indptr, indices, half,
                                      num_node=NUM_NODE, mean=True)

        csr_ones = torch.sparse_csr_tensor(
            indptr, indices, torch.ones(num_edge, device=dev),
            (NUM_NODE, NUM_NODE))
        inv_deg = inverse_degree(indptr, NUM_NODE)[:, None]

        def library():
            return (torch.sparse.mm(csr_ones, half.float()) * inv_deg).half()

        out, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError("spmm_csr_f16: two launches differ")

        def ulp16(x):
            """float16's spacing at |x| (2^-24 below its normal range)"""
            return torch.exp2(torch.floor(torch.log2(torch.clamp(
                x.double().abs(), min=2.0 ** -14))) - 10)

        # On the card the plain version sums a segment with index_add_'s
        # atomics, in another order: where the two float32 sums differ in
        # their last bits their float16 roundings may fall apart by an ulp
        # of the sum (at most the row's aggregate of |h|), which the mean
        # scales by 1 / deg; the product's and each addition's roundings
        # may then fall apart by an ulp of the result, for each segment
        nseg = torch.clamp((deg + SEGMENT - 1) // SEGMENT, min=1)[:, None]
        mass = spmm_csr_plain(indptr, indices, half.abs().float(),
                              num_node=NUM_NODE)
        inv = inverse_degree(indptr, NUM_NODE)[:, None].double()
        tol = nseg * (ulp16(mass) * inv
                      + 2 * ulp16(torch.maximum(out.abs(), ref.abs())))
        if not bool(((out.double() - ref.double()).abs() <= tol).all()):
            raise AssertionError("spmm_csr_f16: kernel disagrees with its "
                                 "plain version (max abs err "
                                 f"{max_err(out, ref)})")
        del mass, inv, tol
        # the CPU's plain version sums each segment in CSR order, as the
        # kernel does: bit for bit on every hub row and 20,000 others
        ip = indptr.cpu().long()
        rows = torch.cat([torch.nonzero(deg > SEGMENT)[:, 0].cpu(),
                          torch.randperm(NUM_NODE, generator=torch.Generator(
                              ).manual_seed(14))[:20000]]).unique()
        lens = ip[rows + 1] - ip[rows]
        sub_ip = torch.cat([torch.zeros(1, dtype=torch.long),
                            torch.cumsum(lens, 0)])
        eids = (torch.repeat_interleave(ip[rows] - sub_ip[:-1], lens)
                + torch.arange(int(sub_ip[-1])))
        cpu_ref = spmm_csr_f16_plain(
            sub_ip.to(torch.int32), indices.cpu()[eids], half.cpu(),
            num_node=rows.numel(), mean=True)
        if not torch.equal(out[rows.to(dev)].cpu().view(torch.int16),
                           cpu_ref.view(torch.int16)):
            raise AssertionError("spmm_csr_f16: kernel differs from the "
                                 "CPU's plain version on sampled rows")
        print(f"{tag} spmm_csr_f16: two launches equal bit for bit; "
              f"bit-equal to the CPU's plain version on {rows.numel()} rows "
              f"({int((deg > SEGMENT).sum())} past {SEGMENT} edges) holding "
              f"{int(sub_ip[-1])} edges", flush=True)
        lib_err = max_err(library(), out)
        err = max_err(out, ref)
        del out, again, ref, in_edges, cpu_ref, eids, ip
        record("spmm_csr_f16", "xgnn_tpu_torch/csrc/spmm.cu",
               "xgnn_tpu/ops/spmm.py:374-394 (_bucket_pass_pre) and 437-483 "
               "(spmm_csr_planned) over a float16 h",
               f"mean, inference layer 0 over the F16 file: ({NUM_NODE}, "
               f"{num_edge}) CSR over ({half.shape[0]}, {f}) f16", err,
               "for each segment, an f16 ulp of the row's aggregate of |h| "
               "times 1/deg and two of the result (the card's plain "
               "version sums with atomics); bit-equal to the CPU's plain "
               "version on the rows past 2048 edges and 20,000 others",
               fn, plain, library,
               "torch.sparse.mm(sparse_csr_tensor(indptr, indices, ones), "
               "h.float()) (cuSPARSE) times 1/max(deg, 1), then .half() (one "
               "rounding, not JAX's)",
               nbytes=src_rows * f * 2 + csr_bytes + NUM_NODE * f * 2,
               flops=num_edge * f + NUM_NODE * f, per_step=1,
               path="inference_f16_files",
               pick_nbytes=num_edge * f * 2 + csr_bytes + NUM_NODE * f * 2,
               plain_reps=1)
        kernels[-1]["library_max_abs_err"] = lib_err
        del csr_ones, inv_deg, deg
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del half
    torch.cuda.empty_cache()
    last_rows = {p: option_rows[p] for p in (
        "gat1_bf16", "gat8_bf16", "gat1_bf16_compute", "graphsage_f16_files",
        "graphsage_f16_widened", "gat1_f16_files", "gat1_f16_widened",
        "graphsage_cached_f16_files")}
    last_rows["f16_files"] = f16_row
    last_rows["wall_s"] = time.perf_counter() - t14
    print(f"{tag} phase 14 (the last single-card configurations) wall time "
          f"{last_rows['wall_s']:.3f} s", flush=True)
    print(json.dumps({"last_configs": last_rows}), flush=True)

    # ---- 15. the collocated multi-card engine (XGNN's arch6) at P = 1 -----
    # MultiChipEngine in a world of one over NCCL, at bench width: the
    # partitioned topology (use_dist_graph) and the interleaved store
    # (part_cache, all features on the card), each step's three sampling
    # layers, its features and its labels through the owner exchange
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch.parallel import collocated, dist_topology
    from xgnn_tpu_torch.parallel.exchange import (
        plan_exchange,
        plan_exchange_plain,
    )
    from xgnn_tpu_torch.ops.random_walk import walk_topk, walk_topk_plain

    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    multi_rows, multi_hist = {}, {}
    mcfg = dataclasses.replace(cfg, arch="arch6", num_worker=1,
                               use_dist_graph=True, part_cache=True)
    expected.update({
        "graphsage_multichip": {
            "plan_exchange": 5 * steps, "sample_khop": 3 * steps,
            "unique_seeded": 3 * steps, "gather_rows": 7 * steps,
            "fanout_fwd": 3 * steps, "fanout_bwd": 2 * steps},
        "graphsage_multichip_replicated": {
            "plan_exchange": 2 * steps, "sample_khop": 3 * steps,
            "unique_seeded": 3 * steps, "gather_rows": 4 * steps,
            "fanout_fwd": 3 * steps, "fanout_bwd": 2 * steps},
        "gcn_multichip": {
            "plan_exchange": 5 * steps, "sample_khop": 3 * steps,
            "unique_seeded": 3 * steps, "gather_rows": 6 * steps,
            "pick_multiplicity": 3 * steps, "fanout_fwd": 3 * steps,
            "fanout_bwd": 2 * steps},
        # a walk a layer: three exchanges (K13, K8a and K1's pick each),
        # then K9's count and ranking
        "pinsage_multichip": {
            "plan_exchange": 8 * steps, "sample_wr": 6 * steps,
            "walk_topk": 2 * steps, "unique_seeded": 2 * steps,
            "gather_rows": 10 * steps, "fanout_fwd": 2 * steps,
            "fanout_bwd": steps},
    })

    def multi_epochs(path, eng):
        """A warm-up epoch, then a counted one with the launch counters set
        to 0 just before it and read just after it."""
        for epoch in (0, 1):
            _build.LAUNCHES.reset()
            r = eng.train_epoch(epoch)
            torch.cuda.synchronize()
            counts = _build.LAUNCHES.snapshot()
            print(f"{tag} {path} epoch {epoch} "
                  f"({'warm-up' if epoch == 0 else 'counted'}): "
                  f"{r['time']:.3f} s, {r['steps']} steps, loss "
                  f"{r['loss']:.4f}, acc {r['train_acc']:.4f}, launches "
                  f"{counts}", flush=True)
            if r["steps"] != steps or counts != expected[path]:
                raise AssertionError(f"{path}: {r['steps']} steps, launch "
                                     f"counts {counts} != {expected[path]}")
            if not all(math.isfinite(v) for v in eng.history[epoch]["loss"]):
                raise AssertionError(f"{path} epoch {epoch}: a step loss is "
                                     "not finite")
        counts_by_path[path] = counts
        # the host loop's epochs, for phase 18's device_loop
        multi_hist[path] = {"hist": [eng.history[0], eng.history[1]],
                            "time": r["time"]}
        return {"epoch_s": r["time"], "steps": r["steps"], "loss": r["loss"],
                "train_acc": r["train_acc"], "launches": counts}

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    meng = MultiChipEngine(ds, mcfg).init()
    torch.cuda.synchronize()
    init_multi_s = time.perf_counter() - t0
    print(f"{tag} graphsage_multichip init: {init_multi_s:.3f} s "
          f"({meng.mesh.backend}, world of {meng.mesh.size}); capacities "
          f"{meng.capacities}, exchange segment {meng.seg_cap}", flush=True)
    try:
        # the first step's batch, its loss and gradients held against the
        # single-store Engine's train step on that batch (local-id blocks,
        # the rows extracted by the single store), same weights, same
        # dropout generator; the reduction's weighting makes it not
        # bit-equal
        it = meng._shuffler(ds.train_set, mcfg.seed + 1).epoch_batches(0)
        s_seeds, s_n = meng._next(it)
        gen, dgen_seed = (generator(dev, 151), 152)
        batch = collocated.sample_any(meng.topo, s_seeds, s_n, mcfg,
                                      meng.capacities, meng.seg_cap,
                                      meng.mesh, True, gen)
        blocks, xbuf, labels, of = collocated.exchange_inputs(
            batch, meng.feat_part, meng.lab_part, meng.mesh, meng.seg_cap)
        params = list(meng.model.parameters())
        loss_m, _, grads_m = collocated.lane_loss_and_grads(
            meng.model, params, blocks, xbuf, labels, batch.num_output,
            generator(dev, dgen_seed))
        grads_m, loss_m, _, skip = collocated.reduce_weighted(
            meng.mesh, grads_m, loss_m, torch.zeros(()).to(dev),
            batch.num_output, of)
        single = Engine(ds, dataclasses.replace(cfg)).init()
        single.model.load_state_dict(meng.model.state_dict())
        x1, lab1, _ = (single.feature_source.extract(batch.input_nodes,
                                                      batch.num_input)[0],
                       single.label_source.extract(batch.output_nodes,
                                                   batch.num_output), None)
        loss_s, _, grads_s = collocated.lane_loss_and_grads(
            single.model, list(single.model.parameters()), batch.blocks, x1,
            lab1, batch.num_output, generator(dev, dgen_seed))
        if bool(skip) or not torch.allclose(loss_m, loss_s, rtol=1e-5,
                                            atol=1e-5):
            raise AssertionError(f"graphsage_multichip first step: loss "
                                 f"{float(loss_m)} against the single "
                                 f"store's {float(loss_s)} (skip "
                                 f"{bool(skip)})")
        g_err = max(max_err(a, b) for a, b in zip(grads_m, grads_s))
        for a, b in zip(grads_m, grads_s):
            assert_close("graphsage_multichip first step's gradients", a, b,
                         exact=False)
        print(f"{tag} graphsage_multichip first step against the single "
              f"store's train step on its batch: loss {float(loss_m):.6f} "
              f"against {float(loss_s):.6f}, gradients max abs err "
              f"{g_err:.3e} (rtol/atol {RTOL})", flush=True)
        multi_rows["first_step"] = {"loss": float(loss_m),
                                    "single_store_loss": float(loss_s),
                                    "grad_max_abs_err": g_err}
        del single, x1, lab1, grads_s, grads_m, blocks, xbuf

        # K13-plan at the partitioned layers' frontiers, walked as
        # sample_minibatch_partitioned walks them, against its plain version
        # bit for bit; then at P = 2, 4 and 8 on the layer-2 frontier (the
        # plan needs no collective)
        frontier, num_f = s_seeds, torch.full((), s_n, dtype=torch.int32,
                                              device=dev)
        caps = meng.capacities
        fronts = []
        for layer, k in enumerate(FANOUT):
            seg = max(int(np.ceil(meng.seg_cap * caps[layer] / caps[-1])),
                      128)
            seg = max(min(seg, frontier.shape[0]), 1)
            fronts.append((layer, frontier, seg))
            nbr, _ = dist_topology.sample_layer_partitioned(
                meng.topo, frontier, k, meng.mesh, seg, mcfg.sample_type,
                generator(dev, 160 + layer))
            frontier, num_u, _ = unique_seeded_split(
                frontier, nbr.reshape(-1), num_f, caps[layer + 1],
                num_node=NUM_NODE)
            num_f = torch.clamp(num_u, max=caps[layer + 1])
        cases = [(f"layer {layer}", f, 1, seg) for layer, f, seg in fronts]
        last = fronts[-1][1]
        cases += [(f"layer 2 at P = {p}", last, p,
                   int(np.ceil(last.shape[0] / p * mcfg.exchange_headroom)))
                  for p in (2, 4, 8)]
        for what, f, p, seg in cases:
            got = plan_exchange(f, p, seg)
            want = plan_exchange_plain(f, p, seg)
            for name in ("send", "pick", "overflow"):
                if not torch.equal(getattr(got, name), getattr(want, name)):
                    raise AssertionError(f"plan_exchange {what}: {name} "
                                         "differs from the plain version")
            n = f.shape[0]
            record("plan_exchange", "xgnn_tpu_torch/csrc/exchange.cu",
                   "xgnn_tpu/parallel/exchange.py:49-84 (plan_exchange) and "
                   "the picks of :139-147 and dist_topology.py:304-314",
                   f"{what}: {n} ids into ({p}, {seg})", 0.0,
                   "exact (send, pick, overflow)",
                   lambda: plan_exchange(f, p, seg),
                   lambda: plan_exchange_plain(f, p, seg), None,
                   "none (no single PyTorch call groups requests by owner)",
                   nbytes=n * 4 + p * seg * 4 + n * 4, flops=0, per_step=5,
                   path="graphsage_multichip")
        del fronts, cases, last, frontier, nbr

        r_ms = multi_epochs("graphsage_multichip", meng)
        prof_m = profiled_epoch("graphsage_multichip", meng, 2) or {}
        single_prof = host_runs["graphsage"].get("profiled") or {}
        groups = prof_m.get("group_ms", {})
        nccl_ms = groups.get("NCCL collectives, *nccl*")
        plan_ms = groups.get("K13-plan, *plan_*")
        multi_rows["graphsage_multichip"] = dict(
            r_ms, init_s=init_multi_s,
            busy_ms_per_step=prof_m.get("busy_ms_per_step"),
            busy_share=prof_m.get("busy_share"),
            single_store_busy_ms_per_step=single_prof.get("busy_ms_per_step"),
            nccl_ms_per_step=nccl_ms, plan_exchange_ms_per_step=plan_ms,
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        print(f"{tag} graphsage_multichip: epoch {r_ms['epoch_s']:.3f} s; "
              f"profiled busy {prof_m.get('busy_ms_per_step')} ms a step "
              "against phase 6's graphsage "
              f"{single_prof.get('busy_ms_per_step')}; all_to_all_single and "
              f"all_reduce (NCCL) {nccl_ms} ms a step, K13-plan {plan_ms} "
              f"ms a step; valid acc {meng.evaluate('valid', 3):.4f} over 3 "
              "batches", flush=True)
    finally:
        meng.close()
    del meng

    # the replicated-topology form, and GCN and PinSAGE (the partitioned
    # walk) on the partitioned topology
    for path, change in (
            ("graphsage_multichip_replicated", dict(use_dist_graph=False)),
            ("gcn_multichip", dict(model="gcn")),
            ("pinsage_multichip", dict(
                model="pinsage", sample_type="random_walk",
                fanout=(NUM_NEIGHBOR,) * 2, frontier_capacities=None,
                calibration_batches=2,
                num_random_walk=WALK["num_random_walk"],
                random_walk_length=WALK["random_walk_length"],
                random_walk_restart_prob=WALK["restart_prob"],
                num_neighbor=NUM_NEIGHBOR))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = MultiChipEngine(ds, dataclasses.replace(mcfg, **change)).init()
        try:
            init_s = time.perf_counter() - t0
            row = multi_epochs(path, eng)
            row.update(init_s=init_s, capacities=list(eng.capacities),
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            if path == "pinsage_multichip":
                # K9's count and ranking at the walk's two layers, on the
                # visits of the partitioned walk
                seeds_p, n_p = eng._next(eng._shuffler(
                    ds.train_set, 3).epoch_batches(0))
                f, num_f = seeds_p, torch.full((), n_p, dtype=torch.int32,
                                               device=dev)
                for layer in range(2):
                    seg = max(int(np.ceil(eng.seg_cap * eng.capacities[layer]
                                          / eng.capacities[-1])), 128)
                    visits, _ = dist_topology.walk_visits_partitioned(
                        eng.topo, f, eng.mesh, seg,
                        num_random_walk=WALK["num_random_walk"],
                        random_walk_length=WALK["random_walk_length"],
                        restart_prob=WALK["restart_prob"],
                        generator=generator(dev, 170 + layer))
                    got = walk_topk(visits, f, NUM_NEIGHBOR)
                    want = walk_topk_plain(visits, f, NUM_NEIGHBOR)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(f"walk_topk layer {layer}: "
                                             "differs from the plain version")
                    b, m = visits.shape[0], visits.shape[1] * visits.shape[2]
                    record("walk_topk", "xgnn_tpu_torch/csrc/random_walk.cu",
                           "xgnn_tpu/parallel/dist_topology.py:405-418",
                           f"layer {layer}: {b} seeds x {m} visits, top "
                           f"{NUM_NEIGHBOR}", 0.0, "exact",
                           lambda: walk_topk(visits, f, NUM_NEIGHBOR),
                           lambda: walk_topk_plain(visits, f, NUM_NEIGHBOR),
                           None, None,
                           nbytes=b * m * 4 + b * 4 + b * NUM_NEIGHBOR * 8,
                           flops=b * m * m * 2, per_step=1,
                           path="pinsage_multichip")
                    nbr = got[0]
                    f, num_u, _ = unique_seeded_split(
                        f, nbr.reshape(-1), num_f, eng.capacities[layer + 1],
                        num_node=NUM_NODE)
                    num_f = torch.clamp(num_u, max=eng.capacities[layer + 1])
                del visits, got, want, f
            multi_rows[path] = row
            print(f"{tag} {path}: init {init_s:.3f} s, counted epoch "
                  f"{row['epoch_s']:.3f} s, capacities {row['capacities']}, "
                  f"peak {row['peak_gib']:.3f} GiB", flush=True)
        finally:
            eng.close()
        del eng
    multi_rows["wall_s"] = time.perf_counter() - t15
    print(f"{tag} phase 15 (the collocated multi-card engine at P = 1) wall "
          f"time {multi_rows['wall_s']:.3f} s", flush=True)
    print(json.dumps({"multichip": multi_rows}), flush=True)

    # ---- 16. XGNN's two-phase GGMS at P = 1 --------------------------------
    # MultiChipEngine with phase 8's partial cache (0.2, pre_sample) on the
    # partitioned topology: the cache partitioned over the ranks (XGNN) or
    # replicated on each (SGNN), every row in pinned host memory, the
    # misses read in place by K11; then dynamic_cache over two epochs
    from xgnn_tpu_torch.ops.tiered import (
        MappedHostTable,
        tiered_split_positions,
        tiered_split_positions_plain,
    )
    from xgnn_tpu_torch.store import host_shared

    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    ggms_rows = {}
    gcfg = dataclasses.replace(mcfg, cache_percentage=CACHE_PCT,
                               cache_policy="pre_sample", presample_epoch=1,
                               num_epoch=2)
    ggms_step = {"plan_exchange": 5 * steps, "sample_khop": 3 * steps,
                 "unique_seeded": 3 * steps, "gather_rows": 7 * steps,
                 "tiered_split_positions": steps, "tiered_direct": steps,
                 "fanout_fwd": 3 * steps, "fanout_bwd": 2 * steps}
    expected.update({
        # the layers', the cache positions' and the labels' exchanges; K1
        # for the three layers' picks, the owner's serve of the cache rows
        # and their pick, the labels' serve and pick
        "graphsage_multichip_ggms": ggms_step,
        # K11's split over the whole cache in place of the positions'
        # exchange
        "graphsage_multichip_sgnn": dict(
            {k: v for k, v in ggms_step.items()
             if k != "tiered_split_positions"},
            plan_exchange=4 * steps, gather_rows=5 * steps,
            tiered_split=steps),
        # and the refresh at the epoch's end (num_epoch 3: after epochs 0
        # and 1): the next epoch's first batch sampled and counted at its
        # owner (K13 for the count), the cache built again (K11's all-miss
        # form)
        "graphsage_multichip_dynamic": dict(
            ggms_step, plan_exchange=5 * steps + 4,
            sample_khop=3 * steps + 3, unique_seeded=3 * steps + 3,
            gather_rows=7 * steps + 3, tiered_direct=steps + 1,
            accumulate_freq=1, tiered_split=1),
    })
    cached_hist = host_runs["graphsage_cached"]["hist"][1]
    cached_hit = float(cached_hist["hit"].sum() / (
        cached_hist["hit"].sum() + cached_hist["miss"].sum()))
    cached_groups = (host_runs["graphsage_cached"].get("profiled")
                     or {}).get("group_ms", {})
    k11_groups = ("K11's split, *split_*",
                  "K11's reads in place, *direct_kernel*")
    for path, change in (
            ("graphsage_multichip_ggms", {}),
            ("graphsage_multichip_sgnn", dict(part_cache=False)),
            ("graphsage_multichip_dynamic",
             dict(cache_policy="dynamic_cache", num_epoch=3))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        geng = MultiChipEngine(ds, dataclasses.replace(gcfg, **change)).init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        items = geng.profiler._init_items
        print(f"{tag} {path} init: {init_s:.3f} s (presample "
              f"{items.get('presample_time', 0.0):.3f} s, the table pinned "
              f"and the cache built {items.get('cache_build_time', 0.0):.3f}"
              f" s); {geng.num_cache} rows cached, "
              f"{tuple(geng.cache_part.shape)} on this rank", flush=True)
        ht16 = host_tier_memory({"feat": geng.host})
        if geng.host.shared is None:
            raise AssertionError(f"{path}: the host table is not the "
                                 "host's shared copy")
        print(f"{tag} {path} host tier: {host_tier_text(ht16)}", flush=True)
        posmap0 = geng.posmap.clone()
        try:
            if path == "graphsage_multichip_ggms":
                # one batch's x against the plain versions, and K11's
                # position form at the batch's input frontier
                it = geng._shuffler(ds.train_set,
                                    gcfg.seed + 1).epoch_batches(0)
                g_seeds, g_n = geng._next(it)
                outs = geng._fn_a(geng.topo, geng.posmap, geng.cache_part,
                                  geng.lab_part, geng.host, g_seeds, g_n,
                                  generator(dev, 181))
                gbatch = collocated.sample_any(
                    geng.topo, g_seeds, g_n, gcfg, geng.capacities,
                    geng.seg_cap, geng.mesh, True, generator(dev, 181))
                ids, num_in = gbatch.input_nodes, gbatch.num_input
                ref, ref_counts = tiered_extract_plain(
                    ids, num_in, geng.posmap, geng.cache_part,
                    geng.host.tensor)
                torch.cuda.synchronize()
                got_counts = torch.stack([outs["num_hit"], outs["num_miss"]])
                if not (torch.equal(outs["x"], ref)
                        and torch.equal(got_counts, ref_counts)
                        and not bool(outs["overflow"])):
                    raise AssertionError(
                        "graphsage_multichip_ggms: the two-phase x or its "
                        "counts differ from the plain versions' (max abs "
                        f"err {max_err(outs['x'], ref)}, counts "
                        f"{got_counts.tolist()} against "
                        f"{ref_counts.tolist()})")
                hits, misses = (int(c) for c in ref_counts)
                print(f"{tag} graphsage_multichip_ggms batch: x "
                      f"{tuple(outs['x'].shape)} bit-equal to the plain "
                      f"versions' rows ({hits} hits, {misses} misses of "
                      f"{int(num_in)} inputs)", flush=True)
                del outs
                pos, counts, mpos, mids = tiered_split_positions(
                    ids, num_in, geng.posmap)
                p_pos, p_counts, p_mpos, p_mids = \
                    tiered_split_positions_plain(ids, num_in, geng.posmap)
                torch.cuda.synchronize()
                if not (torch.equal(pos, p_pos) and torch.equal(counts,
                                                                 p_counts)
                        and torch.equal(mpos[:misses], p_mpos[:misses])
                        and torch.equal(mids[:misses], p_mids[:misses])):
                    raise AssertionError("tiered_split_positions: differs "
                                         "from the plain version")
                n_ids = ids.numel()
                record("tiered_split_positions",
                       "xgnn_tpu_torch/csrc/tiered.cu",
                       "xgnn_tpu/parallel/ggms.py:134-203 (cache_split's "
                       "posmap lookup and miss compaction, with "
                       "compact_mask_positions, xgnn_tpu/ops/unique.py:27)",
                       f"{n_ids} ids ({hits + misses} valid: {hits} hits, "
                       f"{misses} misses) over a ({NUM_NODE},) posmap",
                       max_err(pos, p_pos), "exact: positions, miss "
                       "positions and ids, counts",
                       lambda: tiered_split_positions(ids, num_in,
                                                      geng.posmap),
                       lambda: tiered_split_positions_plain(ids, num_in,
                                                            geng.posmap),
                       None, "none: no one PyTorch call looks up and "
                       "compacts",
                       # the ids, a posmap word a valid id, the positions,
                       # the miss list and the counts
                       nbytes=n_ids * 4 + (hits + misses) * 4 + n_ids * 4
                       + misses * 8 + 8, flops=0, per_step=1,
                       path="graphsage_multichip_ggms", plain_reps=3)
                del pos, p_pos, mpos, p_mpos, mids, p_mids
                # K11's whole call (at P = 1 the engine's cache is the
                # whole cache) over an anonymous pinned copy of the table
                # and over the host's shared one, in turns
                anon = MappedHostTable(geng.host.tensor, dev)
                k11_calls = {
                    "anonymous": lambda: tiered_extract(
                        ids, num_in, geng.posmap, geng.cache_part, anon),
                    "shared": lambda: tiered_extract(
                        ids, num_in, geng.posmap, geng.cache_part,
                        geng.host)}
                for which, call in k11_calls.items():
                    got_x, got_c = call()
                    torch.cuda.synchronize()
                    if not (torch.equal(got_x, ref)
                            and torch.equal(got_c, ref_counts)):
                        raise AssertionError(f"K11 over the {which} table "
                                             "differs from the plain version")
                del got_x, got_c, ref
                k11_turns = {k: [] for k in k11_calls}
                for which in ("anonymous", "shared", "shared", "anonymous",
                              "anonymous", "shared"):
                    k11_turns[which].append(time_ms(
                        torch, k11_calls[which], host_ahead=True))
                pages = {k: {f: v for f, v in host_shared.mapping_memory(
                    t.tensor.data_ptr()).items() if f in (
                        "kernelpagesize", "mmupagesize", "anonhugepages",
                        "shmempmdmapped", "filepmdmapped")}
                    for k, t in (("anonymous", anon), ("shared", geng.host))}
                anon.close()
                del anon
                miss_row_bytes = misses * geng.row_bytes
                thp = host_shared.thp_settings()
                k11_tables = {
                    k: {"device_ms": v, "median_ms": sorted(v)[1],
                        "miss_GBps": miss_row_bytes / sorted(v)[1] / 1e6}
                    for k, v in k11_turns.items()}
                print(f"{tag} K11's whole call on graphsage_multichip_ggms's "
                      f"batch ({int(num_in)} inputs, {misses} misses of "
                      f"{geng.row_bytes} bytes), in turns (anonymous, "
                      "shared, shared, anonymous, anonymous, shared): "
                      + "; ".join(
                          f"{k} table {v['median_ms']:.4f} device ms "
                          f"(median of {['%.4f' % t for t in v['device_ms']]}"
                          f"), misses at {v['miss_GBps']:.2f} GB/s"
                          for k, v in k11_tables.items())
                      + f"; transparent huge pages {thp}; the tables' "
                      f"pages (smaps, bytes) {pages}", flush=True)
                ggms_k11_tables = {"tables": k11_tables, "thp": thp,
                                   "pages": pages, "misses": misses}
                del gbatch, ids
            row = multi_epochs(path, geng)
            hists = [geng.history[e] for e in (0, 1)]
            rates = [float(h["hit"].sum() / (h["hit"].sum()
                                             + h["miss"].sum()))
                     for h in hists]
            if not all(0.0 < r < 1.0 for r in rates):
                raise AssertionError(f"{path}: hit rates {rates}")
            if path == "graphsage_multichip_dynamic":
                # the refresh after epoch 0 ranked the cache by epoch 1's
                # first batch, the one after epoch 1 by epoch 2's
                moved = int((geng.posmap != posmap0).sum())
                print(f"{tag} {path}: the refreshes after epochs 0 and 1 "
                      f"moved {moved} posmap entries; hit rate "
                      f"{rates[0]:.6f} before the first (the presample's "
                      f"ranking), {rates[1]:.6f} after it", flush=True)
                if not moved:
                    raise AssertionError(f"{path}: the refresh left posmap "
                                         "as it was")
                row["posmap_moved"] = moved
            del posmap0
            prof_g = profiled_epoch(path, geng, 2) or {}
            groups = prof_g.get("group_ms", {})
            row.update(
                init_s=init_s, presample_s=items.get("presample_time"),
                cache_build_s=items.get("cache_build_time"),
                host_tier=ht16,
                hit_rate_epochs=rates, graphsage_cached_hit_rate=cached_hit,
                miss_bytes_per_step=mean(hists[1]["miss"])
                * geng.row_bytes,
                busy_ms_per_step=prof_g.get("busy_ms_per_step"),
                busy_share=prof_g.get("busy_share"),
                graphsage_cached_busy_ms_per_step=(
                    host_runs["graphsage_cached"].get("profiled")
                    or {}).get("busy_ms_per_step"),
                k11_ms_per_step=[groups.get(g) for g in k11_groups],
                graphsage_cached_k11_ms_per_step=[cached_groups.get(g)
                                                  for g in k11_groups],
                plan_exchange_ms_per_step=groups.get("K13-plan, *plan_*"),
                nccl_ms_per_step=groups.get("NCCL collectives, *nccl*"),
                peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            if path == "graphsage_multichip_ggms":
                row["k11_anonymous_and_shared"] = ggms_k11_tables
            ggms_rows[path] = row
            print(f"{tag} {path}: counted epoch {row['epoch_s']:.3f} s; "
                  f"profiled busy {row['busy_ms_per_step']} ms a step "
                  f"against graphsage_cached's "
                  f"{row['graphsage_cached_busy_ms_per_step']}; hit rate "
                  f"{rates[0]:.6f} (epoch 0), {rates[1]:.6f} (epoch 1) "
                  f"against graphsage_cached's {cached_hit:.6f}; miss bytes "
                  f"{row['miss_bytes_per_step']:.1f} a step; device ms a "
                  f"step: K11's split {row['k11_ms_per_step'][0]}, its reads "
                  f"{row['k11_ms_per_step'][1]} (graphsage_cached "
                  f"{row['graphsage_cached_k11_ms_per_step']}), K13 "
                  f"{row['plan_exchange_ms_per_step']}, NCCL "
                  f"{row['nccl_ms_per_step']}; peak {row['peak_gib']:.3f} "
                  "GiB", flush=True)
        finally:
            geng.close()
        del geng
    ggms_rows["wall_s"] = time.perf_counter() - t16
    print(f"{tag} phase 16 (the two-phase GGMS at P = 1) wall time "
          f"{ggms_rows['wall_s']:.3f} s", flush=True)
    print(json.dumps({"ggms": ggms_rows}), flush=True)

    # ---- 17. the host cold tier under the partitioned topology, and the
    # exact presample_static over the cards, at P = 1 ----------------------
    # MultiChipEngine with use_dist_graph at phase 12's 0.85: the hot
    # prefix partitioned (one part at P = 1), the whole CSR pinned and
    # mapped, the cold rows drawn on the requesting rank by the samplers'
    # cold form (K2's and K8a's, no device CSR read) and merged in the
    # select that masks the response's EMPTY picks; then presample_static
    # with cache 0.2: the exact closure over the partitioned topology (K12b's
    # partitioned form and a reduce by owner a layer), over the replicated
    # one (the single store's K12b, one reduce), and with the cold tier (the
    # wide khop0 through the tiered presample step)
    from xgnn_tpu_torch.ops.presample import (
        closure_known,
        closure_parts,
        closure_parts_plain,
    )
    from xgnn_tpu_torch.ops.sampling import sample_cold, sample_cold_plain

    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    cold17 = {}
    tcfg = dataclasses.replace(mcfg, dist_graph_percentage=TIER_PCT)
    pin_mcfg = dataclasses.replace(
        mcfg, model="pinsage", sample_type="random_walk",
        fanout=(NUM_NEIGHBOR,) * 2, frontier_capacities=None,
        calibration_batches=2, num_random_walk=WALK["num_random_walk"],
        random_walk_length=WALK["random_walk_length"],
        random_walk_restart_prob=WALK["restart_prob"],
        num_neighbor=NUM_NEIGHBOR, dist_graph_percentage=TIER_PCT)
    expected.update({
        # the untiered paths' kernels and one cold launch a layer (a walk
        # step)
        "graphsage_multichip_tiered": dict(
            counts_by_path["graphsage_multichip"],
            sample_khop_cold=3 * steps),
        "pinsage_multichip_tiered": dict(
            counts_by_path["pinsage_multichip"], sample_wr_cold=6 * steps),
        "graphsage_multichip_ggms_static": counts_by_path[
            "graphsage_multichip_ggms"],
        # the replicated topology's sampling (no layer exchange)
        "graphsage_multichip_ggms_static_replicated": dict(
            counts_by_path["graphsage_multichip_ggms"],
            plan_exchange=2 * steps, gather_rows=4 * steps),
        "graphsage_multichip_ggms_static_tiered": dict(
            counts_by_path["graphsage_multichip_ggms"],
            sample_khop_cold=3 * steps),
    })
    edge_pos = torch.arange(g.num_edge, dtype=torch.int32, device=dev)

    def cold_case(name, form, what, frontier, k, tier17, u, per_step, path,
                  replaces):
        """The cold form at a main-path frontier against its plain version
        (exact), timed, with its bound: the larger of its in-order bytes
        (the frontier, u and the output) over HBM and the distinct 32-byte
        sectors of host memory its cold rows read over PCIe; beside it
        those sectors over the measured ceilings."""
        got = sample_cold(form, tier17, frontier, k, u=u)
        ref = sample_cold_plain(form, tier17, frontier, k, u=u)
        torch.cuda.synchronize()
        assert_close(f"{name} {what}", got, ref, exact=True)
        _, n_sec, _, cold_rows = cold_traffic(
            frontier, k, "khop" if form == "khop" else "wr", u, None, got)
        nbytes = frontier.numel() * 4 + u.numel() * 4 + got.numel() * 4
        hbm_ms = nbytes / HBM_BYTES_PER_S * 1e3
        pcie_ms = n_sec * 32 / PCIE_BYTES_PER_S * 1e3
        source = SOURCES[name.replace("_cold", "")]
        record(name, f"xgnn_tpu_torch/csrc/{source}",
               replaces, f"cold form, {what}: frontier {frontier.shape[0]} "
               f"({cold_rows} cold rows) x K={k}, "
               f"{int((got != empty).sum())} picks", 0.0, "exact",
               lambda: sample_cold(form, tier17, frontier, k, u=u),
               lambda: sample_cold_plain(form, tier17, frontier, k, u=u),
               None, "none: no PyTorch call reads mapped host memory in place",
               nbytes=nbytes, flops=0, per_step=per_step, path=path,
               plain_reps=1, bound=max((hbm_ms, "bytes"), (pcie_ms, "bytes")))
        kernels[-1].update(cold_rows=cold_rows, cold_sectors=n_sec,
                           hbm_bound_ms=hbm_ms, pcie_bound_ms=pcie_ms,
                           ceiling_ms=n_sec / read_rate * 1e3,
                           line_ceiling_ms=n_sec / line_rate * 1e3)
        print(f"{tag} {name} {what}: {cold_rows} cold rows, {n_sec} sectors "
              f"from host memory; {kernels[-1]['device_ms']:.4f} ms on the "
              f"card alone; bound PCIe {pcie_ms:.4f} ms, HBM {hbm_ms:.4f} ms;"
              f" at the measured ceilings {kernels[-1]['ceiling_ms']:.4f} ms "
              f"(32-byte reads) / {kernels[-1]['line_ceiling_ms']:.4f} ms "
              "(128-byte)", flush=True)
        return got, cold_rows

    def engine_host_tier(path, eng):
        """The engine's host tier (the table, the cold tier's CSR), which
        must be the host's shared copy, printed and returned."""
        arrays = dict({} if eng.host is None else {"feat": eng.host},
                      **({} if eng.tier is None else eng.tier.csr.arrays))
        if any(a.shared is None for a in arrays.values()):
            raise AssertionError(f"{path}: the host tier is not the host's "
                                 "shared copy")
        ht = host_tier_memory(arrays)
        print(f"{tag} {path} host tier: {host_tier_text(ht)}", flush=True)
        return ht

    def tiered_row(path, eng, init_s, ref_path):
        row = multi_epochs(path, eng)
        prof17 = profiled_epoch(path, eng, 2) or {}
        groups = prof17.get("group_ms", {})
        # the cold form's launches: the tiered builds (kTiered true)
        cold_ms = {n: v for n, v in (prof17.get("sampler_ms") or {}).items()
                   if "true>" in n}
        ref = multi_rows[ref_path]
        row.update(
            init_s=init_s, capacities=list(eng.capacities),
            busy_ms_per_step=prof17.get("busy_ms_per_step"),
            busy_share=prof17.get("busy_share"),
            cold_launch_ms=cold_ms,
            untiered_busy_ms_per_step=ref.get("busy_ms_per_step"),
            untiered_epoch_s=ref.get("epoch_s"),
            nccl_ms_per_step=groups.get("NCCL collectives, *nccl*"),
            plan_exchange_ms_per_step=groups.get("K13-plan, *plan_*"),
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        return row

    # graphsage_multichip_tiered: bench.py's XGNN_BENCH_DIST_GRAPH=1
    # XGNN_BENCH_DIST_PCT=0.85 run
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    teng = MultiChipEngine(ds, tcfg).init()
    torch.cuda.synchronize()
    init_t = time.perf_counter() - t0
    try:
        got_ncn = None if teng.tier is None else teng.tier.num_cache_node
        if got_ncn != ncn:
            raise AssertionError("graphsage_multichip_tiered: hot prefix "
                                 f"{got_ncn} against phase 12's {ncn}")
        print(f"{tag} graphsage_multichip_tiered init: {init_t:.3f} s (the "
              f"hot prefix {ncn} of {n_all} nodes partitioned, the whole CSR "
              "pinned and mapped); capacities "
              f"{teng.capacities}, exchange segment {teng.seg_cap}",
              flush=True)
        # one batch through the tiered layers: K13-plan with the hot mask
        # and the cold form at each layer's frontier, against their plain
        # versions; the cold rows a layer
        it = teng._shuffler(ds.train_set, tcfg.seed + 1).epoch_batches(0)
        s_seeds, s_n = teng._next(it)
        frontier, num_f = s_seeds, torch.full((), s_n, dtype=torch.int32,
                                              device=dev)
        caps, cold_by_layer = teng.capacities, []
        for layer, k in enumerate(FANOUT):
            seg = max(int(np.ceil(teng.seg_cap * caps[layer] / caps[-1])),
                      128)
            seg = max(min(seg, frontier.shape[0]), 1)
            f_ = frontier
            got = plan_exchange(f_, 1, seg, ncn)
            want = plan_exchange_plain(f_, 1, seg, hot_limit=ncn)
            for name in ("send", "pick", "overflow"):
                if not torch.equal(getattr(got, name), getattr(want, name)):
                    raise AssertionError(f"plan_exchange (hot_limit) layer "
                                         f"{layer}: {name} differs")
            n = f_.shape[0]
            record("plan_exchange", "xgnn_tpu_torch/csrc/exchange.cu",
                   "xgnn_tpu/parallel/dist_topology.py:285-291 (the hot "
                   "mask) and exchange.py:49-84 (plan_exchange)",
                   f"hot_limit {ncn}, layer {layer}: {n} ids into (1, {seg})",
                   0.0, "exact (send, pick, overflow)",
                   lambda: plan_exchange(f_, 1, seg, ncn),
                   lambda: plan_exchange_plain(f_, 1, seg, hot_limit=ncn),
                   None, "none (no single PyTorch call groups requests by "
                   "owner)", nbytes=n * 4 + seg * 4 + n * 4, flops=0,
                   per_step=5, path="graphsage_multichip_tiered")
            u = torch.rand((n, k), generator=generator(dev, 190 + layer),
                           device=dev)
            _, cold_rows = cold_case(
                "sample_khop_cold", "khop", f"layer {layer}", f_, k,
                teng.tier, u, 1, "graphsage_multichip_tiered",
                "xgnn_tpu/parallel/dist_topology.py:315-330 with "
                "xgnn_tpu/parallel/ggms.py:264-487 (the cold rows' host "
                "callback)")
            cold_by_layer.append(cold_rows)
            nbr, _ = dist_topology.sample_layer_partitioned(
                teng.topo, f_, k, teng.mesh, seg, tcfg.sample_type,
                generator(dev, 195 + layer))
            frontier, num_u, _ = unique_seeded_split(
                f_, nbr.reshape(-1), num_f, caps[layer + 1],
                num_node=NUM_NODE)
            num_f = torch.clamp(num_u, max=caps[layer + 1])
        del got, want, nbr, frontier, u
        ht17 = engine_host_tier("graphsage_multichip_tiered", teng)
        row = tiered_row("graphsage_multichip_tiered", teng, init_t,
                         "graphsage_multichip")
        row["host_tier"] = ht17
        sec = [k["cold_sectors"] for k in kernels
               if k["name"] == "sample_khop_cold"]
        row.update(cold_rows_by_layer=cold_by_layer,
                   cold_sectors_by_layer=sec,
                   cold_pcie_bound_ms=[s * 32 / PCIE_BYTES_PER_S * 1e3
                                       for s in sec],
                   cold_ceiling_ms=[s / read_rate * 1e3 for s in sec],
                   cold_line_ceiling_ms=[s / line_rate * 1e3 for s in sec],
                   graphsage_tiered=tier_rows_out["paths"].get(
                       "graphsage_tiered"))
        cold17["graphsage_multichip_tiered"] = row
        print(f"{tag} graphsage_multichip_tiered: counted epoch "
              f"{row['epoch_s']:.3f} s (graphsage_multichip "
              f"{row['untiered_epoch_s']:.3f} s, graphsage_tiered "
              f"{(row['graphsage_tiered'] or {}).get('epoch_s')} s); busy "
              f"{row['busy_ms_per_step']} ms a step (graphsage_multichip "
              f"{row['untiered_busy_ms_per_step']}, graphsage_tiered "
              f"{(row['graphsage_tiered'] or {}).get('busy_ms_per_step')}); "
              f"cold rows by layer {cold_by_layer}; the cold launches "
              f"{row['cold_launch_ms']}", flush=True)
    finally:
        teng.close()
    del teng

    # pinsage_multichip_tiered: the partitioned walk, a walker on a cold
    # node stepping from the host CSR on its own rank
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    peng = MultiChipEngine(ds, pin_mcfg).init()
    init_p = time.perf_counter() - t0
    try:
        seeds_p, n_p = peng._next(peng._shuffler(ds.train_set,
                                                 3).epoch_batches(0))
        w = WALK["num_random_walk"]
        b = seeds_p.shape[0]
        # the walk's step 0 (a fanout-W draw over the seeds) and step 1
        # (fanout 1 over the B * W walkers where step 0 left them) at
        # layer 0
        seg = max(int(np.ceil(peng.seg_cap * peng.capacities[0]
                              / peng.capacities[-1])), 128)
        visits, _ = dist_topology.walk_visits_partitioned(
            peng.topo, seeds_p, peng.mesh, seg, num_random_walk=w,
            random_walk_length=1, restart_prob=WALK["restart_prob"],
            generator=generator(dev, 196))
        seed2d = seeds_p[:, None].expand(b, w)
        walkers = torch.where(visits[:, :, 0] == empty, seed2d,
                              visits[:, :, 0]).reshape(-1).contiguous()
        del visits, seed2d
        cold_walk = []
        for what, f_, k in (("walk step 0, fanout W", seeds_p, w),
                            ("walk step 1, fanout 1", walkers, 1)):
            u = torch.rand((f_.shape[0], k), generator=generator(dev, 197),
                           device=dev)
            cold_walk.append(cold_case(
                "sample_wr_cold", "uniform_wr", what, f_, k, peng.tier, u,
                3, "pinsage_multichip_tiered",
                "xgnn_tpu/parallel/dist_topology.py:334-430 (the walk's "
                "steps) with ggms.py:264-487 (the cold rows' host "
                "callback)")[1])
        ht17 = engine_host_tier("pinsage_multichip_tiered", peng)
        row = tiered_row("pinsage_multichip_tiered", peng, init_p,
                         "pinsage_multichip")
        row["host_tier"] = ht17
        pin_tiered = tier_rows_out["paths"].get("pinsage_tiered") or {}
        row.update(cold_rows_walk_layer0=cold_walk,
                   pinsage_tiered_busy_ms_per_step=pin_tiered.get(
                       "busy_ms_per_step"),
                   pinsage_busy_ms_per_step=pin_tiered.get(
                       "untiered_busy_ms_per_step"))
        cold17["pinsage_multichip_tiered"] = row
        print(f"{tag} pinsage_multichip_tiered: counted epoch "
              f"{row['epoch_s']:.3f} s (pinsage_multichip "
              f"{row['untiered_epoch_s']:.3f} s); busy "
              f"{row['busy_ms_per_step']} ms a step (pinsage_tiered "
              f"{row['pinsage_tiered_busy_ms_per_step']}, pinsage "
              f"{row['pinsage_busy_ms_per_step']}); the cold launches "
              f"{row['cold_launch_ms']}", flush=True)
    finally:
        peng.close()
    del peng

    def closure_rows(path, parts, lanes, label):
        """K12b's partitioned form over ``len(parts)`` parts (each part's
        local CSR on the card), a lane each of ``lanes`` (``(seeds, n)``
        batches), its layers and the count: part 0's calls checked against
        the plain version (out, levels, known set) and recorded."""
        p = len(parts)
        rows = parts[0][0].shape[0] - 1
        recv = [torch.zeros((p, rows + 1), dtype=torch.uint8, device=dev)
                for _ in range(p)]
        for lane, (sd, n_) in enumerate(lanes):
            ids = sd[:n_].long()
            for r in range(p):
                own = ids[ids % p == r]
                recv[r][lane, own // p] = 1
        recv = [t[:, :rows].contiguous() for t in recv]
        level = [torch.zeros((p, rows), dtype=torch.uint8, device=dev)
                 for _ in range(p)]
        known = [closure_known(rows, p, dev) for _ in range(p)]
        ip0, ix0 = parts[0]
        deg0 = (ip0[1:] - ip0[:-1]).long()
        layers = len(FANOUT)
        for tag_l in range(1, layers + 2):
            last = tag_l == layers + 1
            lv0, rc0, kn0 = level[0].clone(), recv[0], known[0].clone()
            cnt = (torch.zeros(rows, dtype=torch.int32, device=dev)
                   if last else None)
            outs = [closure_parts(ip_, ix_, level[r], recv[r], tag_l,
                                  NUM_NODE, r, known[r],
                                  counts=cnt if r == 0 else (
                                      torch.zeros(rows, dtype=torch.int32,
                                                  device=dev)
                                      if last else None))
                    for r, (ip_, ix_) in enumerate(parts)]
            l_ref, k_ref = lv0.clone(), kn0.clone()
            ref = closure_parts_plain(
                ip0, ix0, l_ref, rc0, tag_l, NUM_NODE, 0, k_ref,
                counts=None if cnt is None else torch.zeros_like(cnt))
            torch.cuda.synchronize()
            if not (torch.equal(outs[0], ref) and torch.equal(level[0], l_ref)
                    and torch.equal(known[0], k_ref)):
                raise AssertionError(f"closure_parts ({label}) layer "
                                     f"{tag_l}: differs from the plain "
                                     "version")
            front = (l_ref == tag_l).any(0)
            edges = int(deg0[front].sum())
            nbytes = (rows * p * 3 + known[0].numel() * 8
                      + (rows * 8 if last else int(front.sum()) * 8
                         + edges * 4 + rows * p * p))

            def again(lv0=lv0, rc0=rc0, kn0=kn0, tag_l=tag_l, last=last):
                return closure_parts(
                    ip0, ix0, lv0.clone(), rc0, tag_l, NUM_NODE, 0,
                    kn0.clone(),
                    counts=torch.zeros(rows, dtype=torch.int32, device=dev)
                    if last else None)

            def again_plain(lv0=lv0, rc0=rc0, kn0=kn0, tag_l=tag_l,
                            last=last):
                return closure_parts_plain(
                    ip0, ix0, lv0.clone(), rc0, tag_l, NUM_NODE, 0,
                    kn0.clone(),
                    counts=torch.zeros(rows, dtype=torch.int32, device=dev)
                    if last else None)

            sent = 0 if last else int(ref.sum())
            record("closure_parts", "xgnn_tpu_torch/csrc/presample.cu",
                   "xgnn_tpu/parallel/collocated.py:741-884 "
                   "(make_presample_static_exact_step's partitioned "
                   "closure)",
                   f"{label}, " + ("count" if last else f"layer {tag_l}")
                   + f": {rows} rows, {int(front.sum())} reached rows' "
                   f"{edges} edges, {sent} marks sent", 0.0, "exact",
                   again, again_plain, None,
                   "none: no PyTorch call closes a graph", nbytes=nbytes,
                   flops=0, per_step=layers + 1, path=path + "_init",
                   plain_reps=1)
            if not last:
                recv = [(sum(o[w].to(torch.int32) for o in outs) > 0).to(
                    torch.uint8) for w in range(p)]
        del level, recv, known, outs, ref, l_ref, k_ref, deg0

    # presample_static with a partial cache: the exact closure over the
    # partitioned and the replicated topologies, its counts held to the
    # single store's static_exact_ranking over the engine's presample
    # batches, and the wide-khop approximation under the cold tier
    scfg = dataclasses.replace(gcfg, cache_policy="presample_static")
    single_cfg = dataclasses.replace(scfg, seed=scfg.seed ^ 0x5EED)
    want_counts = static_exact_ranking(ds.graph, ds.train_set, single_cfg,
                                       NUM_NODE, dev)
    for path, change in (
            ("graphsage_multichip_ggms_static", {}),
            ("graphsage_multichip_ggms_static_replicated",
             dict(use_dist_graph=False)),
            ("graphsage_multichip_ggms_static_tiered",
             dict(dist_graph_percentage=TIER_PCT))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.LAUNCHES.reset()
        t0 = time.perf_counter()
        seng = MultiChipEngine(ds, dataclasses.replace(scfg, **change)).init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        counts_by_path[path + "_init"] = _build.LAUNCHES.snapshot()
        items = seng.profiler._init_items
        try:
            row = {"init_s": init_s, "presample_s": items.get(
                "presample_time"), "init_launches": counts_by_path[
                    path + "_init"], "presample_static_ranking_s": static_s,
                "cache_build_s": items.get("cache_build_time"),
                "host_tier": engine_host_tier(path, seng)}
            if seng.tier is None:
                # the engine's ranking pass again, timed: its counts against
                # the single store's over the same batches, bit for bit
                fn = seng._freq_step()
                freq = seng._zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                seng._presample_batches(fn, freq, 0, lambda step: 0)
                torch.cuda.synchronize()
                rank_s = time.perf_counter() - t0
                got_counts = seng._full_counts(freq)
                if not np.array_equal(got_counts, want_counts):
                    raise AssertionError(
                        f"{path}: the exact counts differ from "
                        "static_exact_ranking's over the same batches "
                        f"({int((got_counts != want_counts).sum())} nodes)")
                row.update(ranking_s=rank_s, counts_bit_equal=True,
                           nodes_counted=int((got_counts > 0).sum()))
                print(f"{tag} {path}: ranking {rank_s:.4f} s over "
                      f"{steps} batches (phase 8's single-store "
                      f"presample_static ranking {static_s:.3f} s; the "
                      "partitioned form before its known set: 0.089 s on "
                      "an NVIDIA H100 80GB HBM3 at 700 W); counts "
                      "bit-equal to static_exact_ranking's over the same "
                      f"batches ({int(got_counts.sum())} in all)",
                      flush=True)
                if path == "graphsage_multichip_ggms_static":
                    # K12b's partitioned form at each layer of a closure,
                    # against its plain version: at P = 1 on the engine's
                    # part (the first batch), and over 4 lanes on part 0 of
                    # a 4-way partition (four batches as lanes: one rank's
                    # work at P = 4), every part run so that the reduce by
                    # owner is summed here, the known set carried
                    it = seng._shuffler(ds.train_set,
                                        scfg.seed ^ 0x5EED).epoch_batches(0)
                    lanes4 = [seng._next(it) for _ in range(4)]
                    topo17 = seng.topo
                    closure_rows(path, [(topo17.indptr, topo17.indices)],
                                 lanes4[:1], "P = 1")
                    ip64 = ds.graph.indptr.long()
                    parts4 = [dist_topology.partition_part(
                        ip64, ds.graph.indices, 4, r) for r in range(4)]
                    del ip64
                    closure_rows(path, [(t.indptr, t.indices)
                                        for t in parts4], lanes4,
                                 "4 lanes, part 0 of 4")
                    del parts4, lanes4
            row.update(multi_epochs(path, seng))
            hists = [seng.history[e] for e in (0, 1)]
            rates = [float(h["hit"].sum() / (h["hit"].sum()
                                             + h["miss"].sum()))
                     for h in hists]
            row.update(hit_rate_epochs=rates, num_cache=seng.num_cache,
                       peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            if path.endswith("_tiered"):
                row["exact_hit_rate_epochs"] = cold17[
                    "graphsage_multichip_ggms_static"]["hit_rate_epochs"]
            if path == "graphsage_multichip_ggms_static":
                prof_s = profiled_epoch(path, seng, 2) or {}
                row.update(busy_ms_per_step=prof_s.get("busy_ms_per_step"),
                           ggms_pre_sample_hit_rate=ggms_rows[
                               "graphsage_multichip_ggms"][
                                   "hit_rate_epochs"])
            cold17[path] = row
            print(f"{tag} {path}: init {init_s:.3f} s (presample "
                  f"{row['presample_s']:.3f} s), launches in init "
                  f"{row['init_launches']}; hit rate {rates[0]:.6f} (epoch "
                  f"0), {rates[1]:.6f} (epoch 1)"
                  + (f" against the exact ranking's "
                     f"{row['exact_hit_rate_epochs']}"
                     if path.endswith("_tiered") else "")
                  + f"; counted epoch {row['epoch_s']:.3f} s", flush=True)
        finally:
            seng.close()
        del seng
    if not counts_by_path["graphsage_multichip_ggms_static_init"].get(
            "closure_parts"):
        raise AssertionError("graphsage_multichip_ggms_static: no "
                             "closure_parts launch in its ranking")
    cold17["wall_s"] = time.perf_counter() - t17
    print(f"{tag} phase 17 (the cold tier under the partitioned topology and "
          f"the exact presample_static at P = 1) wall time "
          f"{cold17['wall_s']:.3f} s", flush=True)
    print(json.dumps({"dist_cold": cold17}), flush=True)

    # ---- 18. the multi-card device_loop at P = 1 ----------------------------
    # MultiChipEngine(device_loop=True): the rank's fused step (sampling
    # through the owner exchange, K1's serve and pick, the training step
    # and the gradients' all_reduce) captured once in a CUDA graph, its
    # NCCL collectives inside, and replayed once a step; against phases 15
    # and 17's host loops on the same configurations, step for step
    t18 = time.perf_counter()
    dl18 = {}
    pin_mc = dataclasses.replace(pin_mcfg, dist_graph_percentage=1.0)
    for path, mc in (("graphsage_multichip", mcfg),
                     ("graphsage_multichip_tiered", tcfg),
                     ("pinsage_multichip", pin_mc)):
        name = f"{path}_device_loop"
        host = multi_hist[path]
        per_step = {k: n // steps for k, n in expected[path].items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        eng = MultiChipEngine(ds, dataclasses.replace(
            mc, device_loop=True)).init()
        init_s = time.perf_counter() - t0
        try:
            results = []
            for epoch in (0, 1):
                _build.LAUNCHES.reset()
                results.append(eng.train_epoch(epoch))
                torch.cuda.synchronize()
                counts = _build.LAUNCHES.snapshot()
                print(f"{tag} {name} epoch {epoch} ("
                      f"{'capture, then replays' if epoch == 0 else 'counted'}"
                      f"): {results[-1]['time']:.6f} s, loss "
                      f"{results[-1]['loss']:.4f}, wrapper calls {counts}",
                      flush=True)
                # the capture's warm-up step and the captured step call the
                # wrappers; a replay calls none
                want = ({k: 2 * n for k, n in per_step.items()}
                        if epoch == 0 else {})
                if counts != want:
                    raise AssertionError(f"{name} epoch {epoch}: wrapper "
                                         f"calls {counts} != {want}")
            fused = eng._fused
            if fused is None or fused.graph is None:
                raise AssertionError(f"{name}: no captured step")
            capture_s = eng.profiler._init_items["device_loop_capture_time"]
            for epoch in (0, 1):
                h, d = host["hist"][epoch], eng.history[epoch]
                for key in ("loss", "acc"):
                    if not np.all(np.isfinite(d[key])):
                        raise AssertionError(f"{name} epoch {epoch}: {key} "
                                             "not finite")
                    if not np.array_equal(d[key], h[key]):
                        raise AssertionError(
                            f"{name} epoch {epoch}: {key} differs from the "
                            f"host loop's: {list(d[key])} against "
                            f"{list(h[key])}")
            card_ms, host_ms = replays_queued(torch, dev, fused, [
                eng._generator_seeds(1, i) for i in range(fused.steps)])
            # the hand kernels of a profiled epoch of replays against those
            # of a profiled host-loop epoch on the same engine (by name from
            # the profiler's records).  A multi-card session lost 1 to 3
            # records of its first step's kernels in every one of three
            # pairs (seen on an H100, torch 2.11), so the counts must agree
            # by name
            # within LOST_RECORDS, and a pair that does not is measured
            # again, twice at most
            def agree(a, b):
                return bool(a) and a.keys() == b.keys() and all(
                    abs(a[k] - b[k]) <= LOST_RECORDS for k in a)

            for attempt in range(3):
                eng.config.device_loop = False
                eager = profiled_epoch(f"{name} as the host loop", eng,
                                       10 + attempt) or {}
                eng.config.device_loop = True
                prof = profiled_epoch(name, eng, 2 + attempt) or {}
                if agree(eager.get("hand_kernel_launches"),
                         prof.get("hand_kernel_launches") or {}):
                    break
                print(f"{tag} {name}: the replays launched "
                      f"{prof.get('hand_kernel_launches')} hand kernels by "
                      "the profiler's records, the eager steps "
                      f"{eager.get('hand_kernel_launches')} (attempt "
                      f"{attempt + 1} of 3)", flush=True)
            else:
                raise AssertionError(f"{name}: the replays' hand-kernel "
                                     "launches differ from the eager steps' "
                                     "in three pairs of profiled epochs")
            nccl = "NCCL collectives, *nccl*"
            row = {
                "init_s": init_s, "capture_s": capture_s,
                "device_loop_epoch_s": results[1]["time"],
                "host_loop_epoch_s": host["time"],
                "losses_bit_equal_epochs": [0, 1],
                "host_ms_per_replay": host_ms,
                "card_alone_ms_per_step": card_ms / steps,
                "busy_ms_per_step": prof.get("busy_ms_per_step"),
                "busy_share": prof.get("busy_share"),
                "host_loop_busy_ms_per_step": eager.get("busy_ms_per_step"),
                "host_loop_busy_share": eager.get("busy_share"),
                "nccl_ms_per_step": prof.get("group_ms", {}).get(nccl),
                "host_loop_nccl_ms_per_step": eager.get(
                    "group_ms", {}).get(nccl),
                "dtod_per_step": prof.get("dtod_per_step"),
                "host_loop_dtod_per_step": eager.get("dtod_per_step"),
                "wrapper_calls_per_step": per_step,
                "hand_kernel_launches": prof.get("hand_kernel_launches"),
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            }
            # the collectives are in the graph: at P = 1 NCCL runs its
            # all_to_all as device-to-device copies and its all_reduce as
            # a kernel or a copy, so the replays must show them where the
            # eager steps do
            if ((row["host_loop_dtod_per_step"] or 0) > 0
                    and not row["dtod_per_step"]
                    and not row["nccl_ms_per_step"]):
                raise AssertionError(f"{name}: no NCCL kernel and no "
                                     "device-to-device copy in the replays, "
                                     f"{row['host_loop_dtod_per_step']} "
                                     "copies a step in the eager steps")
            dl18[name] = row
            print(f"{tag} {name}: capture {capture_s:.3f} s; counted epoch "
                  f"{results[1]['time']:.6f} s against the host loop's "
                  f"{host['time']:.6f} s (phase 15/17, the same seeds); "
                  "per-step losses and accuracies of epochs 0 and 1 equal "
                  "the host loop's bit for bit; host "
                  f"{host_ms:.4f} ms a step to queue a replay; card alone "
                  f"{card_ms / steps:.3f} ms a step; profiled busy "
                  f"{row['busy_ms_per_step']} ms a step, share "
                  f"{row['busy_share']} (host loop "
                  f"{row['host_loop_busy_ms_per_step']}, "
                  f"{row['host_loop_busy_share']}); NCCL kernels "
                  f"{row['nccl_ms_per_step']} ms a step and "
                  f"{row['dtod_per_step']} device-to-device copies a step "
                  f"(host loop {row['host_loop_nccl_ms_per_step']}, "
                  f"{row['host_loop_dtod_per_step']}); hand kernels by the "
                  f"profiler's records {row['hand_kernel_launches']}; peak "
                  f"{row['peak_gib']:.3f} GiB", flush=True)
        finally:
            eng.close()
        del eng, fused
    dl18["graphsage_single_store_busy_ms_per_step"] = (
        host_runs["graphsage"].get("profiled") or {}).get("busy_ms_per_step")
    dl18["graphsage_multichip_host_loop_busy_ms_per_step"] = multi_rows[
        "graphsage_multichip"].get("busy_ms_per_step")
    dl18["wall_s"] = time.perf_counter() - t18
    print(f"{tag} phase 18 (the multi-card device_loop at P = 1) wall time "
          f"{dl18['wall_s']:.3f} s", flush=True)
    print(json.dumps({"multichip_device_loop": dl18}), flush=True)

    # ---- 19. the disaggregated engine (arch5), role-degenerate -------------
    # DisaggregatedEngine with 1 sampler and 1 trainer sharing the card
    # (bench.py's XGNN_BENCH_ARCH5=1): the sampler's batch (every layer
    # deduped) handed to the trainer on the Prefetcher's side stream, the
    # trainer's store (the whole table through K1, or the cache 0.2 ranked
    # by pre_sample with K11's reads of the misses) and its labels (K1)
    from xgnn_tpu_torch.engine.disagg_engine import DisaggregatedEngine

    t19 = time.perf_counter()
    a19 = {}
    acfg = dataclasses.replace(cfg, arch="arch5", num_sample_worker=1,
                               num_train_worker=1)
    expected.update({
        "graphsage_arch5": {"sample_khop": 3 * steps,
                            "unique_seeded": 3 * steps,
                            "gather_rows": 2 * steps,
                            "fanout_fwd": 3 * steps,
                            "fanout_bwd": 2 * steps},
        "graphsage_arch5_cached": expected["graphsage_cached"],
    })
    for path, change, ref in (
            ("graphsage_arch5", {}, "graphsage"),
            ("graphsage_arch5_cached", dict(cache_percentage=CACHE_PCT,
                                            cache_policy="pre_sample"),
             "graphsage_cached")):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.LAUNCHES.reset()
        t0 = time.perf_counter()
        aeng = DisaggregatedEngine(ds, dataclasses.replace(acfg, **change))
        aeng.init()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        counts_by_path[f"{path}_init"] = _build.LAUNCHES.snapshot()
        try:
            if aeng.sample_devices[0] != aeng.train_devices[0]:
                raise AssertionError(f"{path}: the roles do not share the "
                                     "card")
            r = None
            for epoch in (0, 1):
                _build.LAUNCHES.reset()
                r = aeng.train_epoch(epoch)
                torch.cuda.synchronize()
                counts = _build.LAUNCHES.snapshot()
                print(f"{tag} {path} epoch {epoch} "
                      f"({'warm-up' if epoch == 0 else 'counted'}, "
                      f"pipelined): {r['time']:.3f} s, {r['steps']} steps, "
                      f"loss {r['loss']:.4f}, acc {r['train_acc']:.4f}, hit "
                      f"rate {r['hit_rate']:.6f}, launches {counts}",
                      flush=True)
                if r["steps"] != steps or counts != expected[path]:
                    raise AssertionError(f"{path}: {r['steps']} steps, "
                                         f"launch counts {counts} != "
                                         f"{expected[path]}")
                if not np.all(np.isfinite(aeng.history[epoch]["loss"])):
                    raise AssertionError(f"{path} epoch {epoch}: a step "
                                         "loss is not finite")
            counts_by_path[path] = counts
            ht19 = None
            if aeng._host_table is not None:
                # one table for every trainer (one trainer here)
                if any(src.host.tensor.data_ptr()
                       != aeng._host_table.tensor.data_ptr()
                       for src in aeng.feature_sources):
                    raise AssertionError(f"{path}: a trainer's store reads "
                                         "another host table")
                ht19 = host_tier_memory({"feat": aeng._host_table})
                print(f"{tag} {path} host table: {host_tier_text(ht19)}",
                      flush=True)
            prof = profiled_epoch(path, aeng, 2) or {}
            ref_prof = host_runs[ref].get("profiled") or {}
            acc = aeng.evaluate("valid", 3)
            row = {
                "init_s": init_s, "init_launches": counts_by_path[
                    f"{path}_init"],
                "epoch_s": r["time"], "steps": r["steps"],
                "loss": r["loss"], "train_acc": r["train_acc"],
                "hit_rate": r["hit_rate"], "launches": counts,
                "busy_ms_per_step": prof.get("busy_ms_per_step"),
                "busy_share": prof.get("busy_share"),
                "group_ms": prof.get("group_ms"),
                "valid_acc_3_batches": acc, "host_tier": ht19,
                "k11_ms_per_step": [(prof.get("group_ms") or {}).get(g)
                                    for g in k11_groups],
                "cache_build_s": aeng.profiler._init_items.get(
                    "cache_build_time"),
                "single_store_path": ref,
                "single_store_epoch_s": host_runs[ref]["time"],
                "single_store_busy_ms_per_step": ref_prof.get(
                    "busy_ms_per_step"),
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            }
            a19[path] = row
            print(f"{tag} {path}: init {init_s:.3f} s (launches "
                  f"{row['init_launches']}); counted epoch {r['time']:.3f} s "
                  f"against {ref}'s {host_runs[ref]['time']:.3f} s; profiled "
                  f"busy {row['busy_ms_per_step']} ms a step (share "
                  f"{row['busy_share']}) against {ref}'s "
                  f"{row['single_store_busy_ms_per_step']}; launches "
                  f"{counts}; hit rate {r['hit_rate']:.6f}; K11's split and "
                  f"reads {row['k11_ms_per_step']} device ms a step; valid "
                  f"acc {acc:.4f} over 3 batches; peak {row['peak_gib']:.3f} "
                  "GiB", flush=True)
        finally:
            aeng.close()
        del aeng
    a19["wall_s"] = time.perf_counter() - t19
    print(f"{tag} phase 19 (the disaggregated engine, role-degenerate) wall "
          f"time {a19['wall_s']:.3f} s", flush=True)
    print(json.dumps({"arch5": a19}), flush=True)

    # ---- 20. the multi-card placement solve at P = 1 -----------------------
    # MultiChipEngine with auto_placement for a group of one card: phase
    # 12's budgets, the largest at which the solver picks a partial cache
    # and a cold tier, so the two-phase GGMS and the host cold tier are its
    # choice; beside phase 17's graphsage_multichip_tiered
    t20 = time.perf_counter()
    a20 = {}
    path = "graphsage_multichip_auto_placement"
    for budget in (8.0, 4.0, 2.0, 1.5, 1.0, 0.75, 0.5):
        pcfg = dataclasses.replace(mcfg, auto_placement=True,
                                   hbm_budget_gb=budget)
        solved, _ = resolve_auto_placement(pcfg, ds, group_size=1)
        if (solved.use_dist_graph and solved.dist_graph_percentage < 1.0
                and 0.0 < solved.cache_percentage < 1.0):
            break
    else:
        raise AssertionError(f"{path}: no budget gave a partial cache and a "
                             "cold tier")
    # the two-phase store's kernels over the partitioned topology and one
    # cold launch a layer (as graphsage_multichip_ggms_static_tiered's)
    expected[path] = dict(counts_by_path["graphsage_multichip_ggms"],
                          sample_khop_cold=3 * steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    peng20 = MultiChipEngine(ds, pcfg).init()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    try:
        pc, plan = peng20.config, peng20.placement_plan
        if plan is None or peng20.tier is None or not peng20.two_phase:
            raise AssertionError(f"{path}: the solved store is not the "
                                 "two-phase GGMS over a cold tier")
        solved_fields = {"use_dist_graph": pc.use_dist_graph,
                         "dist_graph_percentage": pc.dist_graph_percentage,
                         "cache_percentage": pc.cache_percentage}
        if solved_fields != {k: getattr(solved, k) for k in solved_fields}:
            raise AssertionError(f"{path}: the engine solved "
                                 f"{solved_fields}, the solver alone "
                                 f"{solved}")
        print(f"{tag} {path} at hbm_budget_gb={budget}: solved "
              f"{solved_fields} (policy {pc.cache_policy.value}); plan "
              f"{plan}; init {init_s:.3f} s (hot prefix "
              f"{peng20.tier.num_cache_node} of {n_all} nodes, "
              f"{peng20.num_cache} rows cached); capacities "
              f"{peng20.capacities}", flush=True)
        ht20 = engine_host_tier(path, peng20)
        row = multi_epochs(path, peng20)
        prof20 = profiled_epoch(path, peng20, 2) or {}
        groups20 = prof20.get("group_ms", {})
        rates = [float(h["hit"].sum() / (h["hit"].sum() + h["miss"].sum()))
                 for h in (peng20.history[0], peng20.history[1])]
        ref = cold17["graphsage_multichip_tiered"]
        row.update(
            hbm_budget_gb=budget, init_s=init_s, host_tier=ht20,
            cache_build_s=peng20.profiler._init_items.get(
                "cache_build_time"), **solved_fields,
            cache_policy=pc.cache_policy.value,
            num_cache_node=peng20.tier.num_cache_node,
            num_cache=peng20.num_cache,
            expected_topo_hit=plan.expected_topo_hit,
            expected_feat_hit=plan.expected_feat_hit,
            plan_topology_bytes=plan.topology_bytes,
            plan_cache_bytes=plan.cache_bytes, hit_rate_epochs=rates,
            busy_ms_per_step=prof20.get("busy_ms_per_step"),
            busy_share=prof20.get("busy_share"),
            k11_split_ms_per_step=groups20.get("K11's split, *split_*"),
            k11_reads_ms_per_step=groups20.get(
                "K11's reads in place, *direct_kernel*"),
            tiered_path="graphsage_multichip_tiered",
            tiered_epoch_s=ref["epoch_s"],
            tiered_busy_ms_per_step=ref.get("busy_ms_per_step"),
            peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        a20[path] = row
        print(f"{tag} {path}: counted epoch {row['epoch_s']:.3f} s against "
              f"graphsage_multichip_tiered's {ref['epoch_s']:.3f} s; busy "
              f"{row['busy_ms_per_step']} ms a step against "
              f"{ref.get('busy_ms_per_step')}; hit rate {rates[0]:.6f} "
              f"(epoch 0), {rates[1]:.6f} (epoch 1) against the plan's "
              f"{plan.expected_feat_hit:.4f}; K11's split "
              f"{row['k11_split_ms_per_step']} and reads "
              f"{row['k11_reads_ms_per_step']} device ms a step; peak "
              f"{row['peak_gib']:.3f} GiB", flush=True)
    finally:
        peng20.close()
    del peng20
    a20["wall_s"] = time.perf_counter() - t20
    print(f"{tag} phase 20 (the multi-card placement solve at P = 1) wall "
          f"time {a20['wall_s']:.3f} s", flush=True)
    print(json.dumps({"auto_placement_multichip": a20}), flush=True)

    for k in kernels:
        k["launches"] = counts_by_path[k["path"]].get(k["name"], 0)
        if k["path"] == "graphsage_cached_init":
            # the cache build again at each refresh of the dynamic cache
            k["refresh_launches"] = (
                counts_by_path["graphsage_dynamic"][k["name"]] - steps)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
