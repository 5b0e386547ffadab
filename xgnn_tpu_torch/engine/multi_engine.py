"""The collocated multi-card engine (XGNN's arch6): one rank a card.

The port of ``xgnn_tpu/engine/multi_engine.py``'s ``MultiChipEngine``:
the topology replicated on every rank or partitioned over them
(``use_dist_graph``: the whole CSR on the cards, or, with
``dist_graph_percentage < 1``, its hot node-id prefix, the prefix whose
edges are that share of all edges, clamped so that each part's offsets fit
int32, with the whole CSR pinned and mapped from host memory, one copy a
host that the host's ranks share, where the requesting rank draws its cold
rows: XGNN's Global GNN Memory Store over the cards and host memory), the
labels interleaved over the ranks' devices, and one step a batch shard a
rank
(``parallel/collocated.py``).  The features are either all on the cards,
interleaved (``cache_percentage`` 0 or >= 1: JAX's all-device store, the
fused step), or XGNN's two-phase GGMS (``0 < cache_percentage < 1``,
``parallel/ggms.py``): the hottest rows of ``cache_policy``'s ranking
cached on the cards, partitioned over the ranks (``part_cache``) or
replicated on each (SGNN), and every row in pinned host memory, where K11
reads the misses in place.  The host tier (that table and the cold tier's
CSR) is one copy a host (``store/host_shared.py``): the host's first rank
writes it into a file under ``/dev/shm`` that every rank of the host maps
and registers for its card, as JAX's one process a host holds it once.
Each rank is a process with its own
:class:`~xgnn_tpu_torch.parallel.mesh.Mesh`; at P = 1 the engine makes a
world of one in the caller's process.

As in JAX: ``init`` partitions the topology and interleaves the labels
(each rank builds its own part on its device), and calibrates the frontier
capacities from ``calibration_batches`` warm-up batches through the
presample step, every rank's sizes max-reduced, with ``ALLOC_SCALE``
headroom; the exchange segment is ``min(max(ceil(cap[-1] / P *
exchange_headroom), 128), cap[-1])``.  For the two-phase store it then
counts ``presample_epoch`` epochs of inputs at the tightened shapes (the
calibration batches' counts are thrown away), each at its owner, for the
frequency policies' ranking (``presample_static``: every node within L
hops of each batch's seeds, exactly, over the whole topology on the
cards; with a cold tier, which holds edges that no card has, the wide
khop0 of ``static_presample_config`` through the tiered step instead);
``dynamic_cache`` counts the next epoch's
first ``calibration_batches`` batches again at each refresh (gated by
``barriered_epoch``) and rebuilds the cache.  ``train_epoch`` shuffles
with ``Shuffler(num_worker=num_worker, worker_id=rank, seed=seed + 1)``
and every rank takes ``max(num_local_step)`` steps (an exhausted rank
trains on an empty shard, weighing nothing), so the collectives meet.  A
step that overflowed anywhere was skipped on every rank; after the epoch
the ranks, which all read the same reduced flags, grow every capacity
twofold and replay those steps with their own seeds and generators, so no
batch is lost.  ``evaluate`` counts each valid (or test) node once, summed over
the ranks, an overflowed batch again at transient grown capacities.  ``run`` trains ``num_epoch``
epochs with the accuracy report and checkpoints (written by rank 0), and
rank 0 prints the ``test_result:`` lines.  The two-phase store's hit rate
is over every rank and step of an epoch, pulled once an epoch with the
other metrics.  Unlike JAX's two-phase step it has no miss bucket, so no
step is skipped for its misses.

``sanity_check`` (or ``XGNN_SANITY_CHECK``) adds each step's batch
violation flags, max-reduced over the ranks on the device, to the epoch's
one pull; a set flag raises JAX's ``sanity check failed: [...]`` on every
rank.  The node-access log (``profiler.enable_node_access_log()`` on every
rank, or ``XGNN_LOG_NODE_ACCESS``) gathers each step's input nodes of every
rank to rank 0, which logs them rank by rank, as JAX logs its lanes, and
writes the ``node_access*.txt`` files at the end of ``run``.

``device_loop`` (JAX's gate: the fused store and no node-access log, on
every topology, the host cold tier's mapped reads included) runs an epoch
as the rank's fused step captured once in a CUDA graph and replayed once a
step (``fused.py``), its NCCL collectives inside the graph; on the CPU the
same step runs from the same buffers, once a step.  The replays draw the
host loop's uniforms and masks, so the losses are the host loop's bit for
bit.  An ineligible configuration warns once and takes the host loop.  An
overflowed step is skipped on every rank on the device; after the epoch
the ranks grow their capacities, drop the graph and replay those steps
through the host loop, and the next epoch captures again.

DCN groups (``num_dcn_groups > 1``, JAX's hierarchical mesh): the
``num_worker`` ranks fall into ``num_dcn_groups`` groups of ``G =
num_worker // num_dcn_groups`` consecutive ranks (``mesh.make_mesh_2d``),
and every store (the topology's parts, the labels, the features or the
cache) is interleaved over the group's ``G`` parts, rank ``r`` holding
part ``r % G``, and repeated in every group.  The batches span every rank
(``Shuffler(num_worker=num_worker, worker_id=r)``, JAX's group-major
lanes), the exchanges and the exchange segment stay in the group, and the
gradients, the metrics, the flags, the overflow skip and replay and the
node-access log span every rank; the presample's counts are summed over
the groups.  On GPUs a group is one NVLink island and the copies lie
across nodes.  ``auto_placement`` solves the store's split for a group of
``G`` cards (``store/placement.resolve_auto_placement``, JAX's
``multi_engine.py:131-140``) from ``hbm_budget_gb`` or, where it is unset,
the rank's card's memory; every rank solves it, rank 0's fields are
broadcast, and a rank whose plan differs raises (cards of unequal memory:
give ``hbm_budget_gb``).  The solved configuration is ``config`` and the
plan ``placement_plan``.  The disaggregated engine (arch5) is
``disagg_engine.DisaggregatedEngine``; as JAX's, this engine does not read
``arch``.  Unlike JAX's, the cold tier has no ``cold_cap``: nothing
overflows for its rows, and the capacities' growth leaves it as it is.
"""

from __future__ import annotations

import contextlib
import io
import logging
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from .. import profiler as P
from ..checkpoint import CheckpointManager
from ..config import WEIGHTED, CachePolicy, RunConfig
from ..dataset import host_array
from ..device import feature_dtype, generator, resolve, seed_of, to_tensor
from ..models import build_model
from ..ops import sanity
from ..ops.tiered import MappedHostTable
from ..parallel.collocated import (
    make_collocated_train_step,
    make_combine_train_step,
    make_eval_step,
    make_fused_eval_step,
    make_presample_static_exact_step,
    make_presample_step,
    make_sample_split_step,
)
from ..parallel.dist_topology import partition_part
from ..parallel.exchange import interleaved_part
from ..parallel.ggms import build_cache
from ..parallel.mesh import Mesh, make_mesh, make_mesh_2d
from ..sampler import _layer_fanouts, default_capacities
from ..store.feature_store import HBMFeatureSource
from ..store.placement import resolve_auto_placement
from ..store.presample import static_presample_config
from ..store.ranking import FREQUENCY_POLICIES, build_ranking
from ..store.topology import (
    MappedHostCSR,
    Tier,
    clamp_num_cache_node_int32,
    compute_num_cache_node,
)
from ..train import Adam
from ..types import Graph
from .engine import (
    _CALIBRATE,
    _DROPOUT,
    _EVALUATE,
    _SAMPLE,
    _align_up,
    _nanmean,
)
from .fused import FusedEpoch
from .shuffler import Shuffler

EMPTY = C.EMPTY_KEY
_SEED_CALIBRATE = 0x5EED  # the JAX engine's presample shuffle: seed ^ it
_PRESAMPLE = 0x9A3  # the JAX engine's presample key: seed ^ it


def _in_place(a) -> torch.Tensor:
    """``a`` as a tensor over the same memory, where it lies: a host array
    is not copied (a read-only memory map is only read), its uint32 ids
    viewed as int32."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.as_tensor(a)


def _array(ds, name: str):
    g = getattr(ds, "graph", None)
    if g is not None and getattr(g, name, None) is not None:
        return getattr(g, name)
    return getattr(ds, name, None)


class MultiChipEngine:
    """Data-parallel training over ``config.num_worker`` ranks, this
    process being one of them (``mesh``, the world's), or a world of one
    on ``device`` (the card by default).  ``self.world`` is the world's
    mesh and ``self.mesh`` this rank's DCN group's (the world's where there
    is one group); ``rank`` is the world rank, ``part`` the rank's part of
    the ``num_parts`` in its group."""

    _MAX_GROWTHS = 4

    def __init__(self, dataset, config: RunConfig, device=None,
                 mesh: Optional[Mesh] = None):
        size = 1 if mesh is None else mesh.size
        if size != config.num_worker:
            raise ValueError(f"num_worker={config.num_worker}, and the mesh "
                             f"has {size} ranks")
        groups = config.num_dcn_groups
        if groups < 1 or config.num_worker % groups:
            raise ValueError(f"num_worker={config.num_worker} is not a "
                             f"multiple of num_dcn_groups={groups}")
        dev = mesh.device if mesh is not None else resolve(device)
        self.placement_plan = None
        if config.auto_placement:
            # the store's split for a group's cards (XGNN's PartitionSolver:
            # the stores shard over a group, the groups repeat them)
            config, self.placement_plan = resolve_auto_placement(
                config, dataset, group_size=config.num_worker // groups,
                device=dev)
        self.ds = dataset
        self.config = config
        self.world = mesh if mesh is not None else make_mesh(dev)
        self.mesh = make_mesh_2d(groups, self.world)
        self.device = self.world.device
        self.rank, self.num_lanes = self.world.rank, self.world.size
        self.part, self.num_parts = self.mesh.rank, self.mesh.size
        bf16 = config.feat_dtype == "bfloat16" or (
            feature_dtype(dataset.feat) == torch.float16
            and config.compute_dtype == "bfloat16")
        self.feat_dtype = torch.bfloat16 if bf16 else None
        # XGNN's two-phase GGMS iff a partial cache is asked for: 0 means no
        # cache knob and >= 1 that every row fits, both the fused store
        self.two_phase = 0.0 < config.cache_percentage < 1.0
        self.host: Optional[MappedHostTable] = None
        self.tier: Optional[Tier] = None  # the topology's host cold tier
        self.profiler = P.Profiler()
        self.history: dict = {}
        self.model = None
        self.opt: Optional[Adam] = None
        self._fused: Optional[FusedEpoch] = None
        self._fused_warned = False
        self._emit_access = False
        if config.auto_placement:
            self._agree_on_placement()

    def _agree_on_placement(self):
        """Rank 0's solved fields broadcast to every rank, which raises
        where its own plan differs (its card's memory size does)."""
        cfg, prof = self.config, self.profiler
        mine = torch.tensor([float(cfg.use_dist_graph),
                             cfg.dist_graph_percentage,
                             cfg.cache_percentage], dtype=torch.float64,
                            device=self.device)
        first = mine.clone()
        dist.broadcast(first, src=0, group=self.world.group)
        if not torch.equal(first, mine):
            raise RuntimeError(
                f"auto_placement: rank {self.rank} solved (use_dist_graph, "
                f"dist_graph_percentage, cache_percentage) = "
                f"{mine.tolist()}, rank 0 {first.tolist()}: the cards' "
                "memory sizes differ; give hbm_budget_gb")
        prof.log_init("auto_dist_graph_percentage", cfg.dist_graph_percentage)
        prof.log_init("auto_cache_percentage", cfg.cache_percentage)

    # ------------------------------------------------------------------ init
    def init(self):
        cfg, prof, dev = self.config, self.profiler, self.device
        p, part = self.num_parts, self.part
        t0 = time.perf_counter()
        weighted = cfg.sample_type in WEIGHTED
        if cfg.use_dist_graph:
            self.topo = self._partition(weighted)
        else:
            if int(_array(self.ds, "indptr")[-1]) >= 2**31:
                raise ValueError(
                    f"the graph has {int(_array(self.ds, 'indptr')[-1])} "
                    "edges (>= 2^31): the cards' offsets are int32; run "
                    "with use_dist_graph (each part's offsets are rebased, "
                    "and the host tier serves any clamped remainder)")
            g = getattr(self.ds, "graph", None)
            self.topo = (g if g is not None and g.indptr.device == dev
                         else Graph.from_dataset(self.ds, dev,
                                                 weighted=weighted))
        label = to_tensor(self.ds.label, dev, torch.int32)
        self.lab_part = interleaved_part(label, p, part).reshape(-1, 1)
        prof.log_init("graph_load_time", time.perf_counter() - t0)
        prof.log_mem_usage("graph_load", dev)
        t0 = time.perf_counter()
        self.capacities = [int(c) for c in (
            cfg.frontier_capacities or default_capacities(
                cfg.batch_size, _layer_fanouts(cfg), self.ds.num_node))]
        self._derive_exchange_caps()
        freq = self._presample_and_calibrate()
        prof.log_init("presample_time", time.perf_counter() - t0)
        t0 = time.perf_counter()
        feat = self.ds.feat
        if not isinstance(feat, torch.Tensor):
            feat = np.asarray(feat)
        if self.two_phase:
            # the host's one pinned, mapped copy of the whole table, shared
            # by the host's ranks
            self.host = MappedHostTable(feat, mesh=self.world)
            self._build_feature_cache(build_ranking(self.ds, cfg, freq))
        else:
            self.feat_part = HBMFeatureSource(
                interleaved_part(feat, p, part), dev, self.feat_dtype).feat
            self.num_cache = self.ds.num_node
        prof.log_init("cache_build_time", time.perf_counter() - t0)
        prof.log_mem_usage("cache_build", dev)
        t0 = time.perf_counter()
        self.model = build_model(cfg, self.ds.feat_dim, self.ds.num_class)
        self.model.to(dev)
        # the replicated state starts equal on every rank
        with torch.no_grad():
            for t in self.model.parameters():
                dist.broadcast(t, src=0)
        self.opt = Adam(list(self.model.parameters()), cfg.lr,
                        weight_decay=cfg.weight_decay)
        self._build_step_fns()
        prof.log_init("model_init_time", time.perf_counter() - t0)
        prof.log_mem_usage("model_init", dev)
        return self

    def _partition(self, weighted: bool):
        """This rank's part of the partitioned topology: the hot prefix
        (``dist_graph_percentage`` of the edges, clamped so that every
        part's offsets fit int32), and, where it is not the whole graph,
        the host cold tier: the whole CSR (and a weighted type's tables)
        in the host's one shared copy, pinned and mapped for this rank's
        card.  With a tier the part is
        cut from the arrays where they lie, so the cold edges never reach
        the card."""
        cfg, dev, p = self.config, self.device, self.num_parts
        names = ("prob_table", "alias_table", "prob_prefix_table")
        arrays = {n: _array(self.ds, n) if weighted else None for n in names}
        indptr = host_array(_array(self.ds, "indptr"))
        if indptr.dtype == np.uint32:
            indptr = indptr.astype(np.int64)
        num_node = len(indptr) - 1
        ncn = num_node
        if cfg.dist_graph_percentage < 1.0:
            ncn = compute_num_cache_node(indptr, cfg.dist_graph_percentage)
        ncn = clamp_num_cache_node_int32(indptr, ncn, p)
        indices = _array(self.ds, "indices")
        if ncn < num_node:
            self.tier = Tier(ncn, MappedHostCSR(
                indptr, host_array(indices), mesh=self.world,
                **{n: None if a is None else host_array(a)
                   for n, a in arrays.items()}))
            # the cold edges stay on the host: the part is cut there, from
            # the caller's arrays in place (a memory map too)
            on = _in_place
        else:
            on = lambda a: to_tensor(a, dev)
        topo = partition_part(
            to_tensor(indptr, dev), on(indices).to(torch.int32),
            p, self.part, ncn, *(None if a is None else on(a)
                                 for a in arrays.values()))
        topo.tier = self.tier
        return topo

    def _derive_exchange_caps(self):
        """A rank's segment for each peer: the even split of the last
        frontier with headroom, never more than the frontier itself."""
        cap = self.capacities[-1]
        self.seg_cap = min(max(int(np.ceil(
            cap / self.num_parts * self.config.exchange_headroom)), 128), cap)

    def _presample_step(self):
        return make_presample_step(self.config, self.mesh, self.capacities,
                                   self.seg_cap, self.config.use_dist_graph)

    def _freq_step(self):
        """The step that counts the cache's ranking (JAX's ``freq_fn``):
        ``presample_static`` runs the exact closure where the whole
        topology is on the cards, else (a cold tier holds edges no card
        has) the wide khop0 of ``static_presample_config`` through the
        tiered presample step, at its own capacities; every other policy
        runs the presample step."""
        cfg = self.config
        if cfg.cache_policy != CachePolicy.PRE_SAMPLE_STATIC:
            return self._presample_step()
        if self.tier is None:
            return make_presample_static_exact_step(
                cfg, self.mesh, self.ds.num_node, self.capacities[0],
                cfg.use_dist_graph)
        scfg = static_presample_config(cfg)
        scaps = default_capacities(cfg.batch_size, _layer_fanouts(scfg),
                                   self.ds.num_node)
        seg = max(int(np.ceil(scaps[-1] / self.num_parts
                              * cfg.exchange_headroom)), 128)
        return make_presample_step(scfg, self.mesh, scaps, seg,
                                   cfg.use_dist_graph)

    def _presample_batches(self, fn, freq, epoch: int, seed_of_step,
                           num_steps: Optional[int] = None) -> list:
        """Count ``epoch``'s presample batches (``Shuffler(seed ^ 0x5EED)``,
        at most ``num_steps``) into ``freq``; their max-reduced frontier
        sizes, on the device."""
        cfg = self.config
        seed = cfg.seed ^ _SEED_CALIBRATE
        total = self._num_steps(self.ds.train_set, seed)
        if num_steps is not None:
            total = min(total, num_steps)
        it = self._shuffler(self.ds.train_set, seed).epoch_batches(epoch)
        sizes = []
        for step in range(total):
            seeds, n = self._next(it)
            gen = generator(self.device, seed_of_step(step))
            sizes.append(fn(freq, self.topo, seeds, n, gen)[1])
        return sizes

    def _presample_and_calibrate(self) -> Optional[np.ndarray]:
        """Tighten the frontier capacities from ``calibration_batches``
        warm-up batches (their sizes max-reduced over the ranks and the
        batches, scaled by ALLOC_SCALE), then, for the two-phase store's
        frequency policies, count ``presample_epoch`` epochs at the tight
        shapes (the warm-up's counts thrown away) and return every node's
        access count, the same on every rank."""
        cfg = self.config
        need_freq = self.two_phase and cfg.cache_policy in FREQUENCY_POLICIES
        need_calib = (cfg.frontier_capacities is None
                      and cfg.calibration_batches > 0)
        if not (need_freq or need_calib):
            return None
        freq = self._zero_counts()
        if need_calib:
            sizes = self._presample_batches(
                self._presample_step(), freq, 0,
                lambda step: seed_of(cfg.seed, _CALIBRATE, step, self.rank),
                max(cfg.calibration_batches, 1))
            observed = torch.stack(sizes).amax(0).cpu().tolist()
            self.capacities = [self.capacities[0]] + [
                _align_up(int(s * C.ALLOC_SCALE), self.ds.num_node)
                for s in observed[1:]]
            self._derive_exchange_caps()
            self.profiler.log_init("calibrated_input_cap",
                                   self.capacities[-1])
            if not need_freq:
                return None
            freq.zero_()
        fn = self._freq_step()
        for epoch in range(max(cfg.presample_epoch, 1)):
            self._presample_batches(
                fn, freq, epoch,
                lambda step: seed_of(cfg.seed, _PRESAMPLE, epoch, step,
                                     self.rank))
        return self._full_counts(freq)

    def _zero_counts(self) -> torch.Tensor:
        """This rank's interleaved share of the access counts."""
        rows = -(-self.ds.num_node // self.num_parts)
        return torch.zeros(rows, dtype=torch.int32, device=self.device)

    def _full_counts(self, freq: torch.Tensor) -> np.ndarray:
        """Every node's count, on every rank: part ``w``'s share at ``w::P``
        (JAX's ``full[w::P] = parts[w]``), summed over every rank, so the
        shares of one part in the DCN groups add up (JAX's sum over the
        group axis)."""
        p = self.num_parts
        full = torch.zeros(freq.shape[0] * p, dtype=torch.int32,
                           device=self.device)
        full[self.part::p] = freq
        self.world.all_reduce(full)
        return full[:self.ds.num_node].cpu().numpy()

    def _build_feature_cache(self, ranking: np.ndarray):
        """The position map and this rank's cache rows from a
        hottest-first ranking: position ``p`` on part ``p % P`` of each
        group at row ``p // P`` (``part_cache``), or the whole cache on
        every rank."""
        cfg = self.config
        parts = self.num_parts if cfg.part_cache else 1
        self.posmap, self.cache_part, self.num_cache = build_cache(
            self.host, ranking, cfg.cache_percentage, parts,
            self.part if cfg.part_cache else 0, self.device, self.feat_dtype)

    def _dynamic_refresh(self, next_epoch: int):
        """Rank the cache anew by the access counts of the next epoch's
        first ``calibration_batches`` batches, sampled with that epoch's own
        generators, and rebuild it (JAX's refresh, the reference's
        ``GPUDynamicCacheManager::ReplaceCache``)."""
        cfg = self.config
        fn = self._presample_step()
        freq = self._zero_counts()
        it = self._shuffler(self.ds.train_set,
                            cfg.seed + 1).epoch_batches(next_epoch)
        for step in range(max(cfg.calibration_batches, 1)):
            seeds, n = self._next(it)
            fn(freq, self.topo, seeds, n,
               self._generators(next_epoch, step)[0])
        full = self._full_counts(freq)
        self._build_feature_cache(
            np.argsort(-full.astype(np.int64), kind="stable").astype(
                np.int32))

    def _build_step_fns(self):
        cfg = self.config
        if self.two_phase:
            self._fn_a = make_sample_split_step(
                cfg, self.mesh, self.capacities, self.seg_cap,
                cfg.use_dist_graph, cfg.part_cache)
            self._fn_b = make_combine_train_step(self.model, self.opt, cfg,
                                                 self.mesh)
            self._fn_eval = make_eval_step(self.model, self.mesh)
            return
        # the node-access log's frontier, as the flag stood at the build
        # (train_epoch builds again where it changed)
        self._emit_access = self.profiler._log_node_access
        self.step_fn = make_collocated_train_step(
            self.model, self.opt, cfg, self.mesh, self.capacities,
            self.seg_cap, cfg.use_dist_graph, self._emit_access)
        self._fn_eval = make_fused_eval_step(
            self.model, cfg, self.mesh, self.capacities, self.seg_cap,
            cfg.use_dist_graph)

    # ----------------------------------------------------------------- steps
    def _shuffler(self, nodes, seed: int, worker: Optional[int] = None):
        """Lane ``worker``'s (this rank's) shard: the batches span every
        rank of the world, group-major as JAX's lanes."""
        return Shuffler(nodes, self.config.batch_size,
                        num_worker=self.num_lanes,
                        worker_id=self.rank if worker is None else worker,
                        seed=seed)

    def _num_steps(self, nodes, seed: int) -> int:
        """Steps every rank takes: the longest shard's."""
        return max(self._shuffler(nodes, seed, w).num_local_step
                   for w in range(self.num_lanes))

    def _next(self, it):
        """This rank's next shard of seeds on the device, EMPTY when its
        shard is exhausted."""
        seeds, n = next(it, (None, 0))
        if seeds is None:
            seeds = np.full(self.config.batch_size, EMPTY, C.ID_DTYPE)
        return self._on_device(seeds), n

    def _on_device(self, seeds: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(seeds)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True)

    def _generators(self, epoch: int, step: int):
        return tuple(generator(self.device, s)
                     for s in self._generator_seeds(epoch, step))

    def _generator_seeds(self, epoch: int, step: int) -> tuple:
        """The (sampling, dropout) seeds of a training step on this rank."""
        cfg, r = self.config, self.rank
        return (seed_of(cfg.seed, _SAMPLE, epoch, step, r),
                seed_of(cfg.seed, _DROPOUT, epoch, step, r))

    def _sample_split(self, fn_a, seeds, n, gen) -> dict:
        return fn_a(self.topo, self.posmap, self.cache_part, self.lab_part,
                    self.host, seeds, n, gen)

    def _log_access(self, input_nodes: torch.Tensor, num_input):
        """Every rank's input nodes gathered to rank 0, which logs them in
        rank order (JAX logs its lanes so); every rank takes part."""
        every = self.world.all_gather(input_nodes)
        nums = self.world.all_gather(
            torch.as_tensor(num_input, device=self.device)
            .to(torch.int32).reshape(1))
        if self.rank == 0:
            every, nums = every.cpu().numpy(), nums.cpu().numpy()
            for w in range(self.num_lanes):
                self.profiler.log_node_access(every[w, :int(nums[w, 0])])

    def _run_one_step(self, seeds, n, epoch: int, step: int,
                      log_access: bool = False) -> dict:
        """One training step; with ``log_access`` its input nodes go to
        the node-access log (not on a replay, as in JAX)."""
        gen, dgen = self._generators(epoch, step)
        if self.two_phase:
            outs = self._sample_split(self._fn_a, seeds, n, gen)
            if log_access:
                self._log_access(outs["input_nodes"], outs["num_input"])
            return self._fn_b(outs, dgen)
        m = self.step_fn(self.topo, self.feat_part, self.lab_part, seeds,
                         n, gen, dgen)
        ids = m.pop("input_nodes", None)
        if log_access and ids is not None:
            self._log_access(ids, m["num_input"])
        return m

    def _stat_keys(self) -> tuple:
        keys = ("loss", "acc", "overflow", "num_input")
        if self.two_phase:
            keys += ("num_hit", "num_miss")
        if self.config.sanity_check:
            keys += ("sanity",)
        return keys

    # ------------------------------------------------------ device_loop
    def _fused_ok(self) -> bool:
        """``device_loop``'s gate, JAX's (``multi_engine.py:850-857``): the
        fused store, and no node-access log (it pulls every step)."""
        return not self.two_phase and not self.profiler._log_node_access

    def _fused_step(self, seeds, num_valid, sample_gen, dropout_gen):
        """``device_loop``'s step (``fused.py``): the rank's fused step;
        its stats column in ``_stat_keys`` order."""
        m = self.step_fn(self.topo, self.feat_part, self.lab_part, seeds,
                         num_valid, sample_gen, dropout_gen)
        return torch.stack([m[k].float().reshape(())
                            for k in self._stat_keys()])

    def _train_epoch_fused(self, epoch: int) -> dict:
        """The ``device_loop`` epoch: the captured step replayed once a
        step (captured at the first such epoch, and again after an
        overflow grew the capacities), the host loop's seeds and
        generators step for step."""
        cfg, prof = self.config, self.profiler
        seed = cfg.seed + 1
        num_steps = self._num_steps(self.ds.train_set, seed)
        it = self._shuffler(self.ds.train_set, seed).epoch_batches(epoch)
        seeds = np.full((num_steps, cfg.batch_size), EMPTY, C.ID_DTYPE)
        num_valid = np.zeros(num_steps, np.int32)
        for s in range(num_steps):
            b_seeds, num_valid[s] = next(it, (None, 0))
            if b_seeds is not None:
                seeds[s] = b_seeds
        if self._fused is None or self._fused.steps != num_steps:
            mode = "thread_local" if self.mesh.backend == "nccl" else \
                "global"
            self._fused = FusedEpoch(self, num_steps, len(self._stat_keys()),
                                     capture_error_mode=mode)
            prof.log_init("device_loop_capture_time", self._fused.capture_s)
        t_epoch = time.perf_counter()
        # ONE device-to-host pull for the epoch's metrics
        stats = self._fused.run(seeds, num_valid, [
            self._generator_seeds(epoch, s) for s in range(num_steps)])
        records = [(seeds[s], int(num_valid[s]), s)
                   for s in range(num_steps)]
        return self._finish_epoch(epoch, stats.astype(np.float64), records,
                                  t_epoch)

    # ------------------------------------------------------------ epochs
    def train_epoch(self, epoch: int) -> dict:
        cfg, prof = self.config, self.profiler
        if not self.two_phase and self._emit_access != prof._log_node_access:
            self._build_step_fns()  # the log was turned on or off
        if cfg.device_loop:
            if self._fused_ok():
                return self._train_epoch_fused(epoch)
            if not self._fused_warned:
                self._fused_warned = True
                logging.getLogger(__name__).warning(
                    "device_loop requested but ineligible (needs all-HBM "
                    "features, no per-step host instrumentation); using the "
                    "host-driven loop")
        seed = cfg.seed + 1
        num_steps = self._num_steps(self.ds.train_set, seed)
        it = self._shuffler(self.ds.train_set, seed).epoch_batches(epoch)
        log_access = prof._log_node_access
        metrics, records = [], []
        t_epoch = t_prev = time.perf_counter()
        for step in range(num_steps):
            seeds, n = self._next(it)
            records.append((seeds, n, step))
            if cfg.dump_trace:
                prof.trace_begin(epoch, step, "train")
            metrics.append(self._run_one_step(seeds, n, epoch, step,
                                              log_access))
            if cfg.dump_trace:
                metrics[-1]["loss"].item()
                prof.trace_end(epoch, step, "train")
            now = time.perf_counter()
            # sample, exchange and train are one step on the stream: its
            # host time is logged as train time, as JAX logs its fused
            # program's
            prof.log_step(epoch, step, P.L1_TRAIN_TIME, now - t_prev)
            t_prev = now
        # float64: the counts of an epoch and its ranks sum exactly
        stats = torch.stack([torch.stack([m[k].double() for m in metrics])
                             for k in self._stat_keys()])
        if self.two_phase:
            # the hits and misses of every rank and step
            total = stats[4:6].sum(1)
            self.world.all_reduce(total)
            stats = torch.cat([stats, total[:, None].expand(2, num_steps)])
        # ONE device-to-host pull for the epoch's metrics
        return self._finish_epoch(epoch, stats.cpu().numpy(), records,
                                  t_epoch)

    def _finish_epoch(self, epoch: int, stats: np.ndarray, records: list,
                      t_epoch: float) -> dict:
        """The epoch's metrics from its pulled stats (``_stat_keys``' rows,
        then the two-phase store's summed hits and misses): the history,
        the sanity check, the overflowed steps' replay and the dynamic
        cache's refresh.  ``records`` are each step's ``(seeds, n, step)``,
        the seeds on the device or a host array."""
        cfg, prof = self.config, self.profiler
        keys = self._stat_keys()
        row = {k: stats[i] for i, k in enumerate(keys)}
        num_steps = len(records)
        loss_v, acc_v, over_v, nin_v = (row[k] for k in keys[:4])
        self.history[epoch] = {"loss": loss_v, "acc": acc_v,
                               "overflow": over_v, "num_input": nin_v}
        for step, v in enumerate(nin_v):
            prof.log_step(epoch, step, P.L1_NUM_NODE, float(v))
        hit_rate = 1.0
        if self.two_phase:
            hit_v, miss_v = row["num_hit"], row["num_miss"]
            hits, misses = stats[len(keys):, 0]
            self.history[epoch].update(hit=hit_v, miss=miss_v)
            hit_rate = float(hits / max(hits + misses, 1.0))
            prof.log_step(epoch, 0, P.L2_CACHE_HIT_RATE, hit_rate)
            for step, m in enumerate(miss_v):
                prof.log_step(epoch, step, P.L1_MISS_BYTES,
                              float(m) * self.row_bytes)
        if cfg.sanity_check:
            flags = int(row["sanity"].max())
            if flags:
                raise RuntimeError(
                    f"sanity check failed: {sanity.explain(flags)}")
        extra_losses, extra_accs = [], []
        n_over = int(over_v.sum())
        if n_over:
            print(f"warning: {n_over} steps hit exchange/frontier capacity "
                  f"in epoch {epoch}; growing capacities and replaying them")
            prof.log_step(epoch, 0, P.L3_OVERFLOW_RETRY, float(n_over))
            self._replay_overflowed(epoch, [records[i] for i in
                                            np.nonzero(over_v)[0]],
                                    extra_losses, extra_accs)
        dt = time.perf_counter() - t_epoch
        prof.log_epoch_add(epoch, "epoch_time", dt)
        refresh = (cfg.barriered_epoch in (-1, 0)
                   or epoch == cfg.barriered_epoch)
        if (self.two_phase and cfg.cache_policy == CachePolicy.DYNAMIC
                and refresh and epoch + 1 < cfg.num_epoch):
            self._dynamic_refresh(epoch + 1)
        return {
            "epoch": epoch,
            "loss": _nanmean(np.concatenate([loss_v, extra_losses])),
            "train_acc": _nanmean(np.concatenate([acc_v, extra_accs])),
            "time": dt, "steps": num_steps, "hit_rate": hit_rate,
            "contributed_steps": int(np.isfinite(loss_v).sum())
            + len(extra_losses),
        }

    @property
    def row_bytes(self) -> int:
        """A host row's bytes, what a miss moves over PCIe."""
        return self.ds.feat_dim * self.host.tensor.element_size()

    def _grow_capacities(self):
        """Every static capacity doubled, the step functions rebuilt (the
        single store's Sampler.grow)."""
        self.capacities = [self.capacities[0]] + [
            _align_up(int(c * 2), self.ds.num_node)
            for c in self.capacities[1:]]
        self.seg_cap *= 2
        self._build_step_fns()
        self._fused = None  # the capacities changed: capture again

    def _replay_overflowed(self, epoch: int, todo: list, losses_out: list,
                           accs_out: list):
        """Each overflowed step again with its seeds and generators at grown
        capacities, until none overflows: every batch gives one update."""
        attempts = 0
        while todo and attempts < self._MAX_GROWTHS:
            attempts += 1
            self._grow_capacities()
            print(f"replaying {len(todo)} overflowed steps at grown "
                  f"capacities {self.capacities}")
            still = []
            for seeds, n, step in todo:
                if isinstance(seeds, np.ndarray):  # a device_loop epoch's
                    seeds = self._on_device(seeds)
                m = self._run_one_step(seeds, n, epoch, step)
                if bool(m["overflow"]):
                    still.append((seeds, n, step))
                else:
                    losses_out.append(float(m["loss"]))
                    accs_out.append(float(m["acc"]))
            todo = still
        if todo:
            raise RuntimeError(f"{len(todo)} steps still overflow after "
                               f"{attempts} capacity growths (capacities "
                               f"{self.capacities})")

    # ------------------------------------------------------------- evaluate
    def _transient_eval_fn(self, scale: int):
        """An eval step at grown capacities that leaves the training step's
        untouched (an eval outlier must not reshape the training path): the
        fused eval step, or the two-phase store's sample-and-split step."""
        cfg = self.config
        caps = [self.capacities[0]] + [
            _align_up(int(c * scale), self.ds.num_node)
            for c in self.capacities[1:]]
        if self.two_phase:
            return make_sample_split_step(cfg, self.mesh, caps,
                                          self.seg_cap * scale,
                                          cfg.use_dist_graph, cfg.part_cache)
        return make_fused_eval_step(self.model, cfg, self.mesh, caps,
                                    self.seg_cap * scale, cfg.use_dist_graph)

    def evaluate(self, split: str = "valid",
                 max_batches: Optional[int] = None) -> float:
        """The sampled accuracy over the valid (or test) nodes, each counted
        once over all ranks: batches of ``Shuffler(nodes, num_worker=P,
        seed=0)``, batch ``i`` of rank ``r`` sampled from ``seed_of(123, i,
        r)``, the forward without dropout."""
        nodes = self.ds.valid_set if split == "valid" else self.ds.test_set
        if len(nodes) == 0:
            return float("nan")
        num_steps = self._num_steps(nodes, 0)
        if max_batches is not None:
            num_steps = min(num_steps, max_batches)
        it = self._shuffler(nodes, 0).epoch_batches(0)
        bs = self.config.batch_size
        issued = sum(min(max(sh._shard_size - s * bs, 0), bs)
                     for sh in (self._shuffler(nodes, 0, w)
                                for w in range(self.num_lanes))
                     for s in range(num_steps))

        def eval_one(seeds, n, step, fn):
            g = generator(self.device, seed_of(_EVALUATE, step, self.rank))
            if self.two_phase:
                return self._fn_eval(self._sample_split(fn, seeds, n, g))
            return fn(self.topo, self.feat_part, self.lab_part, seeds, n, g)

        first = self._fn_a if self.two_phase else self._fn_eval
        batches, outs = [], []
        for step in range(num_steps):
            seeds, n = self._next(it)
            batches.append((seeds, n, step))
            outs.append(torch.stack(eval_one(seeds, n, step,
                                             first)).float())
        vals = torch.stack(outs).cpu().numpy()  # one pull: correct, total, of
        correct, total = float(vals[:, 0].sum()), float(vals[:, 1].sum())
        retry = [b for b, v in zip(batches, vals) if v[2] > 0]
        attempts = 0
        while retry and attempts < self._MAX_GROWTHS:
            attempts += 1
            print(f"re-running {len(retry)} overflowed eval batches through "
                  f"a transient {2 ** attempts}x-capacity eval step")
            fn = self._transient_eval_fn(2 ** attempts)
            still = []
            for seeds, n, step in retry:
                c, t, of = eval_one(seeds, n, step, fn)
                if bool(of):
                    still.append((seeds, n, step))
                else:
                    correct += float(c)
                    total += float(t)
            retry = still
        if retry:
            raise RuntimeError(f"{len(retry)} eval batches still overflow "
                               f"after {attempts} capacity growths")
        # every issued node counted exactly once
        assert int(total) == issued, (total, issued)
        return correct / total if total else float("nan")

    # ------------------------------------------------------------------- run
    def run(self) -> dict:
        """``init``, then ``num_epoch`` epochs (resumed from
        ``checkpoint_dir``'s newest checkpoint where there is one), the
        valid accuracy every ``report_acc`` epochs and a checkpoint every
        ``checkpoint_every`` (rank 0 writes it); rank 0 writes the trace
        and the node-access files and prints the ``test_result:`` lines."""
        cfg = self.config
        self.init()
        ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir \
            else None
        start_epoch = 0
        if ckpt:
            state, extra = ckpt.restore((self.model, self.opt))
            if state is not None:
                start_epoch = (extra or {}).get("epoch", -1) + 1
                if self.rank == 0:
                    print(f"resumed from checkpoint at epoch {start_epoch}")
        results = []
        for epoch in range(start_epoch, cfg.num_epoch):
            r = self.train_epoch(epoch)
            if cfg.report_acc and epoch % max(cfg.report_acc, 1) == 0:
                r["valid_acc"] = self.evaluate("valid")
            results.append(r)
            if ckpt and (epoch + 1) % cfg.checkpoint_every == 0:
                if self.rank == 0:
                    ckpt.save(epoch, (self.model, self.opt),
                              extra={"epoch": epoch})
                dist.barrier()
        if cfg.dump_trace and self.rank == 0:
            self.profiler.dump_trace("xgnn_trace.json")
            print("trace dumped to xgnn_trace.json")
        if self.profiler._log_node_access and self.rank == 0:
            # rank 0 logged every rank's input nodes
            prof, deg = self.profiler, self.ds.degrees
            prof.dump_node_access("node_access.txt", in_degrees=deg,
                                  out_degrees=deg)
            prof.dump_node_access_frequency("node_access_frequency.txt",
                                            self.ds.num_node)
            prof.dump_node_access_similarity("node_access_similarity.txt")
            opt = prof.optimal_cache_hit_rate(
                max(cfg.cache_percentage, 0.0), self.ds.num_node)
            print(f"test_result:optimal_cache_hit_rate={opt:.6f}")
        extra = {"final_train_acc": results[-1]["train_acc"] if results
                 else 0.0,
                 "cache_hit_rate": results[-1]["hit_rate"] if results
                 else 1.0}
        quiet = (contextlib.nullcontext() if self.rank == 0
                 else contextlib.redirect_stdout(io.StringIO()))
        with quiet:
            out = self.profiler.test_results(extra=extra)
        return {"epochs": results, "test_results": out}

    def close(self):
        """Unmap the host table and the cold tier's CSR, and end the
        process group where this engine made it (a world of one)."""
        if self.host is not None:
            self.host.close()
        if self.tier is not None:
            self.tier.csr.close()
        self.world.close()

