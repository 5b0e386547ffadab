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
   multiplicity) at the three layers, exact; K4's sum form as GCN runs it,
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
   but graphsage_khop1 runs one profiled pipelined epoch (the device's busy
   time per step, its time by kernel, and the elementwise divisions').
7. Weighted sampling: the weighted products dataset through
   ``make_device_dataset(weighted=True)`` (timed; its prefix table and
   coarse CDF are 496 MB and 1.25 GB), its graph, features, labels and
   split equal to phase 3's, which it then replaces, every prefix row
   nondecreasing, and its tables close to the same functions run again
   (each timed; the coarse CDF exactly, the sums within 1e-6); K8b-prefix at the three layers' frontiers of
   one batch, walked through K3, exact, with the bytes of the rows it reads
   whole and of a coarse row for every live row; the whole batch equal to
   the plain path's; then GraphSAGE 3x256 on weighted_khop_prefix (the
   path ``graphsage_weighted_prefix``: warm-up, counted and profiled epochs
   as in 6), and the prefix tables freed.  Then alias tables for the same
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
   batch).  Then the path ``graphsage_cached``: warm-up, counted,
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
   both bounds (distinct rows once; ``per_pick_bound_ms`` a row a pick),
   the plain version and the library (cuSPARSE's ``torch.sparse.mm`` of
   a CSR of ones; for K6b a composition of torch ops), beside the same
   call over the graph without its hub rows and with every row on the
   rows kernel (no hub kernel).  The inference's device time and each K6
   call's come from CUDA events with the inference queued while the card
   sleeps (the card's time alone).

Each kernel is timed twice: ``ms`` back to back (the wrapper's host time
included, where the host is the slower) and ``device_ms`` with the host
ahead of the card (the card's time alone).  ``bound_ms`` reads each input
once: a gather over picks (K4 forward, K5) counts each distinct table row
of this batch once, and ``per_pick_bound_ms`` beside it a row per valid
pick; K4's mean form moves the sum form's bytes.  K4's mean-form
``library_ms`` is two calls, ``F.embedding_bag`` and the division.

Prints the inference's JSON line, the kernels' JSON line, then the card's
line (nvidia-smi's name and power limit), then the result line.
Exits non-zero with no result line when there is no CUDA device.
"""

import dataclasses
import json
import math
import os
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
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = ATOL = 1e-5
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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
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
    from xgnn_tpu_torch.sampler import Sampler, default_capacities
    from xgnn_tpu_torch.store.presample import static_exact_ranking
    from xgnn_tpu_torch.synthetic import build_alias_tables
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
                             train_frac=0.08, seed=0, name="products_synth")
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    print(f"{tag} graph: {ds.num_node} nodes, {ds.num_edge} edges, built in "
          f"{graph_s:.3f} s", flush=True)
    cfg = RunConfig(**BENCH_CONFIG)
    t0 = time.perf_counter()
    engine = Engine(ds, cfg).init()
    torch.cuda.synchronize()
    print(f"{tag} engine init: {time.perf_counter() - t0:.3f} s; "
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

    # K7 at each layer: the multiplicity of every pick over the block
    for layer, (blk, rows) in enumerate(((b0, feat.shape[0]),
                                         (b1, b0.dst_cap),
                                         (b2, b1.dst_cap))):
        nb = blk.neigh
        out, ref = pick_multiplicity(nb, rows), pick_multiplicity_plain(nb,
                                                                        rows)
        torch.cuda.synchronize()
        assert_close("pick_multiplicity", out, ref, exact=True)
        valid = (nb >= 0) & (nb < rows)
        spare = torch.where(valid, nb, rows).reshape(-1).long()
        record("pick_multiplicity", "xgnn_tpu_torch/csrc/degree.cu",
               "xgnn_tpu/ops/degree.py:31",
               f"layer {layer}: {tuple(nb.shape)} picks ({int(valid.sum())} "
               f"valid) over {rows} rows", max_err(out, ref), "exact",
               lambda: pick_multiplicity(nb, rows),
               lambda: pick_multiplicity_plain(nb, rows),
               lambda: torch.bincount(spare, minlength=rows + 1)[spare],
               "torch.bincount(ids, minlength=N + 1)[ids] on the ids with "
               "the invalid ones moved to bin N",
               # the ids in, the counts out
               nbytes=nb.numel() * 8, flops=0, per_step=3, path="gcn")
        del out, ref, spare

    # K4 as GCNConv runs it: per-pick weights rsqrt(max(cnt, 1)) from K7;
    # forward aggregate first at layers 0 and 1 and transform first at
    # layer 2 (over the 47-wide transformed table: float lanes), backward
    # at layers 1 and 2 without a prefix gradient
    h2t = torch.randn((b1.dst_cap, NUM_CLASS), generator=gen, device=dev)
    for layer, (h, blk) in enumerate(((feat, b0), (h1, b1), (h2t, b2))):
        cnt = pick_multiplicity(blk.neigh, h.shape[0])
        w = torch.rsqrt(torch.clamp(cnt.to(torch.float32), min=1.0))
        fwd_case(h, blk, 3, weights=w, path="gcn")
        if layer:
            bwd_case(h, blk, weights=w, with_dst=False, path="gcn",
                     mean=False)
        del cnt, w

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
    small = make_device_dataset(3000, 12000, 32, 6, seed=1, device=dev)
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
    mean = lambda v: sum(v) / max(len(v), 1)

    def run_epochs(path, eng):
        """A warm-up epoch, then a counted one with the launch counters set
        to 0 just before it and read just after it."""
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
        stage = eng.history[1]["stages"]
        print(f"{tag} {path} epoch 1 host enqueue per step: sample "
              f"{mean(stage['sample']) * 1e3:.3f} ms, extract "
              f"{mean(stage['extract']) * 1e3:.3f} ms, train "
              f"{mean(stage['train']) * 1e3:.3f} ms", flush=True)
        return r

    def profiled_epoch(path, eng, epoch):
        """Device busy share over one more pipelined epoch, from the
        profiler's device events (the union of their intervals over the
        epoch's wall time), and device ms per step by kernel."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.train_epoch(epoch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if not all(math.isfinite(v) for v in eng.history[epoch]["loss"]):
            raise AssertionError(f"{path} epoch {epoch}: a step loss is not "
                                 "finite")
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if not spans:
            print(f"{tag} {path} device busy share: not measured (the "
                  "profiler recorded no device events)", flush=True)
            return
        busy_us, reach, by_name = 0.0, -math.inf, {}
        for start, end, name in spans:
            busy_us += max(0.0, end - max(start, reach))
            reach = max(reach, end)
            by_name[name] = by_name.get(name, 0.0) + (end - start)
        print(f"{tag} {path} epoch {epoch} (profiled, pipelined): "
              f"{wall_us / 1e3:.1f} ms wall, device busy "
              f"{busy_us / 1e3:.1f} ms ({busy_us / 1e3 / steps:.3f} ms per "
              f"step), busy share {busy_us / wall_us:.3f}, {len(spans)} "
              "device events; device ms per step by kernel:", flush=True)
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:16]:
            print(f"{tag}   {us / 1e3 / steps:9.3f}  {name[:120]}", flush=True)
        groups = (
            ("*fill*", lambda n: "fill" in n),
            ("*add*", lambda n: "add" in n),
            ("K4's segmented backward, *bwd_* but not *attend* (GAT: K5's "
             "g_table sum)", lambda n: "bwd_" in n and "attend" not in n),
            ("K5, *attend* and *proj_reduce*",
             lambda n: "attend" in n or "proj_reduce" in n),
            ("K7, *hist_kernel* and *gather_kernel*",
             lambda n: "hist_kernel" in n or "gather_kernel" in n),
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
        )
        for what, match in groups:
            hits = [(name, end - start) for start, end, name in spans
                    if match(name.lower())]
            us = sum(t for _, t in hits)
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
    profiled_epoch("graphsage", engine, 3)
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
        profiled_epoch(path, eng, 2)
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
    profiled_epoch("pinsage", pin_engine, 2)
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
        if path == "mlp":
            profiled_epoch(path, eng, 2)
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
                              weighted=True)
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
        reads, at most the row, one index a pick, the output), what the
        kept design reads of the rows of at most 128 entries, what a coarse
        row for every live row would read, and the rows past 128."""
        ok = (frontier >= 0) & (frontier < wgraph.num_node)
        node = torch.where(ok, frontier, 0).long()
        deg = torch.where(ok, wgraph.indptr[node + 1] - wgraph.indptr[node],
                          0).double()
        d = deg[deg > 0]
        search = torch.minimum(d, k * (torch.ceil(torch.log2(d)) + 1))
        live = d.numel()
        nbytes = (frontier.numel() * 4 + int(ok.sum()) * 8 + live * k * 4
                  + int(search.sum()) * 4 + int((out != empty).sum()) * 4
                  + out.numel() * 4)
        return (nbytes, int(d[d <= 128].sum()) * 4, live * 512,
                int((d > 128).sum()))

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
        nbytes, direct_b, coarse_b, hubs = prefix_traffic(frontier, k, got)
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
                           coarse_row_bytes=coarse_b)
        print(f"{tag} sample_prefix layer {layer}: rows of <= 128 entries "
              f"read whole {direct_b} bytes, a coarse row for every live row "
              f"{coarse_b} bytes", flush=True)
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
    profiled_epoch("graphsage_weighted_prefix", weng, 2)
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

    def alias_phase(g, graph_name, caps, batch_seeds):
        """K8b-alias with and without dedup at the three frontiers of one
        batch walked through K3 by the draws without dedup, exact; then one
        batch through Sampler.sample for each alias form, its launches
        counted, equal to the plain path's"""
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
                       flops=0, per_step=3, path=paths[dedup])
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
    alias_phase(wgraph, "products graph", CAPS, seeds)
    del wds, wgraph
    torch.cuda.empty_cache()

    # K8b-alias on a graph of 2^16 nodes at products' mean degree, its alias
    # tables built on the host by the port's build_alias_tables (bit-equal
    # to the JAX package's); its 40 MB of tables fit the card's 50 MB L2
    t0 = time.perf_counter()
    sg = make_device_dataset(ALIAS_NODES, ALIAS_DRAWS, 8, NUM_CLASS, seed=3,
                             train_frac=0.2, device=dev)
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
    # read and written; the kernel streams every marked row's indices again
    # each layer
    reach = marked[-1]
    need = (bseeds.numel() * 4 + int(reach.sum()) * 8
            + int(deg[reach].sum()) * 4 + NUM_NODE * 8)
    streamed = sum(int(deg[m].sum()) for m in marked)
    record("closure_expand", "xgnn_tpu_torch/csrc/presample.cu",
           "xgnn_tpu/store/presample.py:69-83 (expand inside "
           "static_exact_ranking)",
           f"{n} seeds, {len(FANOUT)} layers over ({NUM_NODE}, "
           f"{indices.numel()}) CSR: {int(got.sum())} nodes reached, "
           f"{int(reach.sum())} rows within {len(FANOUT) - 1} hops; "
           f"{streamed} edges streamed", max_err(got, ref), "exact",
           lambda: closure_expand(indptr, indices, bseeds, len(FANOUT), zero),
           lambda: closure_expand_plain(indptr, indices, bseeds, len(FANOUT),
                                        zero),
           None, "none: no one PyTorch call expands a CSR mask",
           nbytes=need, flops=0, per_step=1, path="presample_static",
           plain_reps=3)
    kernels[-1]["edges_streamed"] = streamed
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
          f"{static_s:.3f} s, {int((static > 0).sum())} nodes reached, "
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
    profiled_epoch("graphsage_cached", ceng, 3)
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
    src_rows = int((torch.bincount(edge_cols, minlength=NUM_NODE) > 0).sum())
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
                           **hub_split(fn_on, f"gat_aggregate_csr ({heads}, "
                                              f"{d})"))
        print(f"{tag} gat_aggregate_csr ({heads}, {d}): two launches equal "
              f"bit for bit; per-pick bound "
              f"{kernels[-1]['per_pick_bound_ms']:.4f} ms; the "
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
