"""The training engine: init, calibration, the epoch loops, evaluation and
``run``.

The port of ``xgnn_tpu/engine/engine.py``'s single-store ``Engine``: the
whole feature table on the device (in ``feat_dtype``) with direct extract,
or, for a ``cache_percentage`` in (0, 1), the tiered store (a ranked hot-row cache on
the device, the table in pinned host memory, the ranking from
``cache_policy``, presampled at init where the policy needs it) with
non-direct extract; a pipelined host loop; and the sampled evaluation.  Per step nothing waits on
the device; the overflow flags, losses, accuracies and the store's hit and
miss counts come to the host in one pull per epoch, and an overflow grows
the sampler's capacities for the next epoch (the overflowed steps were
skipped on the device).  ``dynamic_cache`` counts accesses on the device
every step and refreshes the cache at epoch ends.  ``history[epoch]`` keeps
each step's loss, accuracy, overflow flag, hits and misses and the host
time of each stage.

The dataset may be a directory that ``load_dataset`` mapped: its
read-only arrays are copied once, to the card or into the tiered stores'
pinned memory; a uint32 ``indptr`` (2^31 edges or more) only the tiered
topology takes; the weighted samplers read the files' tables and the
static cache policies their ranking files.  A float16 feature table (an
``F16`` file) stays float16 on the card and in the tiered store's host
tier and cache, as JAX keeps it, at half the bytes of float32; the model
does no float16 arithmetic (JAX's ``GNN`` casts its input to
``compute_dtype`` first), so the kernels widen its rows exactly where JAX
widens the table.  Under ``feat_dtype`` "bfloat16" the table is rounded
to bfloat16, and under ``compute_dtype`` "bfloat16" alone it is rounded
once at init, which gives the values of JAX's per-step ``astype``.

``profiler`` is wired as the JAX engine wires it: init times and memory,
each step's stage times, input nodes, hit rate and miss bytes, the
overflow retries, ``dump_trace``'s spans, the node-access log and
``sanity_check`` in ``_produce``.  ``device_loop`` runs an epoch as one
captured step replayed once a step (``fused.py``) where JAX's gate allows
it (the whole table on the device, no per-step host instrumentation, no
dynamic cache); otherwise it warns once and takes the host loop, as the
JAX engine does.  ``run`` trains ``num_epoch`` epochs with the accuracy
report, checkpoints and resume, and prints the ``test_result:`` lines.

``use_dist_graph`` with ``dist_graph_percentage < 1`` is the tiered
topology (``sampler.make_tiered_topology``): the hot CSR prefix on the
device, the whole CSR pinned and mapped in host memory, and the samplers'
kernels reading the cold rows in place.  ``auto_placement`` first solves
the store's split from the device memory and the degree skew
(``store/placement.py``, JAX's ``group_size=1``).  A presample on a tiered
topology samples through the tiered sampler (``presample_static`` through
its wide khop0, ``static_presample_config``), and with a placement plan
sets ``placement_plan.expected_feat_hit`` out of sample, as JAX does.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from .. import profiler as P
from ..checkpoint import CheckpointManager
from ..config import WEIGHTED, CachePolicy, RunConfig
from ..device import feature_dtype, generator, resolve, seed_of
from ..models import build_model
from ..ops import sanity
from ..ops.presample import accumulate_freq
from ..sampler import Sampler, make_tiered_topology
from ..store.feature_store import (
    DynamicTieredFeatureSource,
    HBMFeatureSource,
    LabelSource,
    TieredFeatureSource,
)
from ..store.placement import resolve_auto_placement
from ..store.presample import (
    presample_ranking,
    static_exact_ranking,
    static_presample_config,
)
from ..store.ranking import FREQUENCY_POLICIES, build_ranking
from ..train import Adam, eval_step, train_step
from ..types import Graph
from .fused import FusedEpoch
from .pipeline import Prefetcher
from .shuffler import Shuffler

# stream tags mixed into the seeds, as the JAX engine xors its keys
_SAMPLE, _DROPOUT, _CALIBRATE = 0x5A3F1E, 0xD20F00, 0xCA11B
_EVALUATE = 123  # the JAX engine's evaluation key


def _nanmean(v) -> float:
    v = np.asarray(v)
    return float(np.nanmean(v)) if np.isfinite(v).any() else float("nan")


def _align_up(n: int, num_node: int) -> int:
    a = C.CAPACITY_ALIGN
    return min(
        int(np.ceil(max(num_node, 1) / a)) * a, int(np.ceil(max(n, 1) / a)) * a
    )


class Engine:
    def __init__(self, dataset, config: RunConfig, device=None,
                 feat_dtype: Optional[torch.dtype] = None):
        self.ds = dataset
        self.config = config
        self.device = resolve(device)
        # the device table's type is the config's feat_dtype (None keeps
        # the dataset's); the argument, kept for the JAX engine's signature,
        # may only repeat it, so RunConfig's checks cannot be bypassed
        want = getattr(torch, config.feat_dtype)
        if feat_dtype is not None and feat_dtype != want:
            raise ValueError(f"feat_dtype={feat_dtype} differs from the "
                             f"config's feat_dtype={config.feat_dtype!r}: "
                             "set RunConfig.feat_dtype")
        # None keeps the dataset's float32 or float16; an F16 table under
        # bfloat16 compute is rounded once here in place of every step
        bf16 = want == torch.bfloat16 or (
            feature_dtype(dataset.feat) == torch.float16
            and config.compute_dtype == "bfloat16")
        self.feat_dtype = torch.bfloat16 if bf16 else None
        self.graph: Optional[Graph] = None
        self.sampler: Optional[Sampler] = None
        # the tiered topology's cold side and the whole graph's node count
        self._tier = None
        self._full_num_node: Optional[int] = None
        self.placement_plan = None
        self.feature_source = None
        self.label_source = None
        self.model = None
        self.opt: Optional[Adam] = None
        self.history: dict = {}
        # host seconds of the init stages (presample, cache build)
        self.init_times: dict = {}
        self.profiler = P.Profiler()
        self._dyn_freq: Optional[torch.Tensor] = None
        self._fused: Optional[FusedEpoch] = None
        self._fused_warned = False

    # ------------------------------------------------------------------ init
    def init(self):
        prof = self.profiler
        if self.config.auto_placement:
            # the store's split solved from the device memory and the degree
            # skew; this engine owns one card's store (group_size=1)
            self.config, self.placement_plan = resolve_auto_placement(
                self.config, self.ds, group_size=1, device=self.device)
            prof.log_init("auto_dist_graph_percentage",
                          self.config.dist_graph_percentage)
            prof.log_init("auto_cache_percentage",
                          self.config.cache_percentage)
        cfg = self.config
        t0 = time.perf_counter()
        weighted = cfg.sample_type in WEIGHTED
        if cfg.use_dist_graph and cfg.dist_graph_percentage < 1.0:
            # the tiered topology (the reference's single-GPU large-graph
            # mode, evaluation/large_graph --use-dist-graph 0.85): the hot
            # prefix on the device, the whole CSR mapped from host memory
            g = getattr(self.ds, "graph", None)
            src = g if g is not None else self.ds
            table = (lambda name: getattr(src, name, None)
                     if weighted else None)
            self.graph, self._tier, self._full_num_node = (
                make_tiered_topology(
                    src.indptr, src.indices, cfg.dist_graph_percentage,
                    cfg.sample_type, prob_table=table("prob_table"),
                    alias_table=table("alias_table"),
                    prob_prefix_table=table("prob_prefix_table"),
                    device=self.device))
        elif getattr(self.ds, "graph", None) is not None:
            self.graph = self.ds.graph
        else:
            self.graph = Graph.from_dataset(self.ds, self.device,
                                            weighted=weighted)
        prof.log_init("graph_load_time", time.perf_counter() - t0)
        prof.log_mem_usage("graph_load", self.device)
        t0 = time.perf_counter()
        # direct extract: the last sampled layer keeps global ids and the
        # first GNN layer reads the feature table itself; the tiered store
        # extracts the last layer's deduplicated ids instead
        self._direct = cfg.gpu_extract and not self._tiered
        self.sampler = Sampler(self.graph, cfg, direct_extract=self._direct,
                               tier=self._tier,
                               num_node=self._full_num_node)
        self._calibrate()
        prof.log_init("sampler_build_time", time.perf_counter() - t0)
        t0 = time.perf_counter()
        self._build_feature_source()
        self.label_source = LabelSource(self.ds.label, self.device)
        prof.log_init("cache_build_time", time.perf_counter() - t0)
        prof.log_mem_usage("cache_build", self.device)
        t0 = time.perf_counter()
        self.model = build_model(cfg, self.ds.feat_dim, self.ds.num_class)
        self.model.to(self.device)
        self.opt = Adam(list(self.model.parameters()), cfg.lr,
                        weight_decay=cfg.weight_decay)
        prof.log_init("model_init_time", time.perf_counter() - t0)
        prof.log_mem_usage("model_init", self.device)
        return self

    def _calibrate(self):
        """Tighten the frontier capacities from warm-up batches, with
        ALLOC_SCALE headroom."""
        cfg = self.config
        if cfg.frontier_capacities is not None or cfg.calibration_batches <= 0:
            return
        shuffler = Shuffler(self.ds.train_set, cfg.batch_size, seed=cfg.seed)
        observed = [0] * (len(self.sampler.fanouts) + 1)
        for i, (seeds, n) in enumerate(shuffler.epoch_batches(0)):
            if i >= cfg.calibration_batches:
                break
            gen = generator(self.device, seed_of(cfg.seed, _CALIBRATE, i))
            batch = self.sampler.sample(self._to_device(seeds), n, gen)
            sizes = [int(b.num_src) for b in batch.blocks]  # outer..inner
            for layer, size in enumerate(reversed(sizes)):
                observed[layer + 1] = max(observed[layer + 1], size)
        caps = [self.sampler.capacities[0]] + [
            _align_up(int(s * C.ALLOC_SCALE), self.sampler.num_node)
            for s in observed[1:]
        ]
        self.sampler = Sampler(self.graph, cfg, caps,
                               direct_extract=self._direct,
                               tier=self.sampler.tier,
                               num_node=self.sampler.num_node)
        self.profiler.log_init("calibrated_input_cap", caps[-1])

    @property
    def _tiered(self) -> bool:
        return 0.0 < self.config.cache_percentage < 1.0

    def _build_feature_source(self):
        """The whole table on the device, or the tiered store with the
        ranking of ``cache_policy`` (presampled here where it needs access
        counts).  The features go to pinned host memory once."""
        cfg = self.config
        if not self._tiered:
            self.feature_source = HBMFeatureSource(self.ds.feat, self.device,
                                                   self.feat_dtype)
            return
        access_freq = None
        num_node = self.sampler.num_node  # the whole graph's
        if cfg.cache_policy in FREQUENCY_POLICIES:
            t0 = time.perf_counter()
            static = cfg.cache_policy == CachePolicy.PRE_SAMPLE_STATIC
            if static and self._tier is None:
                # the exact all-neighbour closure over the whole topology
                access_freq = static_exact_ranking(
                    self.graph, self.ds.train_set, cfg, num_node,
                    self.device)
            else:
                sampler = self.sampler
                if static:
                    # a tiered topology: the wide-khop0 approximation (exact
                    # for rows of degree <= presample_static_fanout) through
                    # the tiered sampler
                    sampler = Sampler(self.graph,
                                      static_presample_config(cfg),
                                      tier=self._tier, num_node=num_node)
                access_freq, freq_a, freq_b = presample_ranking(
                    sampler, self.ds.train_set, cfg, num_node, self.device,
                    halves=True)
            self.init_times["presample"] = time.perf_counter() - t0
            self.profiler.log_init("presample_time",
                                   self.init_times["presample"])
            if self.placement_plan is not None:
                self.placement_plan.expected_feat_hit = self._expected_hit(
                    access_freq, None if static else (freq_a, freq_b))
        ranking = build_ranking(self.ds, cfg, access_freq)
        t0 = time.perf_counter()
        cls = (DynamicTieredFeatureSource
               if cfg.cache_policy == CachePolicy.DYNAMIC
               else TieredFeatureSource)
        self.feature_source = cls(self.ds.feat, ranking,
                                  cfg.cache_percentage, self.device,
                                  self.feat_dtype)
        self._sync()
        self.init_times["cache_build"] = time.perf_counter() - t0
        if cfg.cache_policy == CachePolicy.DYNAMIC:
            self._dyn_freq = torch.zeros(num_node, dtype=torch.int32,
                                         device=self.device)

    def _expected_hit(self, access_freq, halves) -> float:
        """The feature cache's expected hit rate, as the JAX engine
        estimates it for the placement plan: the degree proxy the plan was
        solved with over-weights hubs, so it is measured on the presample.
        ``halves`` (the even and the odd batches' counts): rank by one,
        score the other (out of sample); None (``presample_static``,
        whose closure JAX takes as the access distribution itself): the
        counts' own top share."""
        k = int(len(access_freq) * self.config.cache_percentage)
        if halves is None:
            w = np.sort(np.asarray(access_freq, np.float64))[::-1]
            return float(w[:k].sum() / max(w.sum(), 1.0))
        fa, fb = (np.asarray(h, np.float64) for h in halves)
        order = np.argsort(-fa, kind="stable")
        return float(fb[order][:k].sum() / max(fb.sum(), 1.0))

    def _to_device(self, seeds: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(seeds)
        if self.device.type != "cuda":
            return host.to(self.device)
        # from pinned memory the copy is queued on the stream; from pageable
        # memory it would wait for the stream's earlier work
        return host.pin_memory().to(self.device, non_blocking=True)

    # ----------------------------------------------------------------- steps
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _extract(self, batch):
        """A step's feature rows (under direct extract the table itself)
        and labels, with the store's hit counts."""
        if self._direct:
            x, info = self.feature_source.feat, {"hit_rate": 1.0,
                                                 "miss_bytes": 0}
        else:
            x, info = self.feature_source.extract(batch.input_nodes,
                                                  batch.num_input)
        labels = self.label_source.extract(batch.output_nodes,
                                           batch.num_output)
        return x, labels, info

    def _train(self, batch, x, labels, gen) -> dict:
        """A step's forward, backward and Adam, skipped on the device when
        the batch overflowed."""
        return train_step(self.model, self.opt, batch.blocks, x, labels,
                          batch.num_output, gen, batch.overflow)

    def _fused_step(self, seeds, num_valid, sample_gen, dropout_gen):
        """``device_loop``'s step (``fused.py``): sample, extract, train;
        its stats column (loss, accuracy, overflow, input nodes)."""
        batch = self.sampler.sample(seeds, num_valid, sample_gen)
        x, labels, _ = self._extract(batch)
        m = self._train(batch, x, labels, dropout_gen)
        return torch.stack([m["loss"], m["acc"], batch.overflow.float(),
                            batch.num_input.float()])

    def _produce(self, item, sync: bool = False):
        """Sample + extract for one step (in the prefetch thread when
        pipelining).  Returns host times of the two stages: on a CUDA
        device they measure the enqueue, unless ``sync`` waits for each
        stage's device work.  With ``sanity_check`` the batch's violation
        flags come to the host and a violation raises; with the node-access
        log its input nodes come to the host."""
        (seeds, num_valid), seed, (epoch, step) = item
        cfg, prof = self.config, self.profiler
        if cfg.dump_trace:
            prof.trace_begin(epoch, step, "sample")
        t0 = time.perf_counter()
        gen = generator(self.device, seed)
        batch = self.sampler.sample(self._to_device(seeds), num_valid, gen)
        if cfg.sanity_check:
            flags = int(sanity.check_batch(batch))
            if flags:
                raise RuntimeError(
                    f"sanity check failed: {sanity.explain(flags)}")
        if prof._log_node_access:
            prof.log_node_access(
                batch.input_nodes[:int(batch.num_input)].cpu().numpy())
        if self._dyn_freq is not None:
            accumulate_freq(self._dyn_freq, batch.input_nodes,
                            batch.num_input)
        if sync:
            self._sync()
        t1 = time.perf_counter()
        if cfg.dump_trace:
            prof.trace_end(epoch, step, "sample")
            prof.trace_begin(epoch, step, "copy")
        x, labels, info = self._extract(batch)
        if sync:
            self._sync()
        t2 = time.perf_counter()
        if cfg.dump_trace:
            prof.trace_end(epoch, step, "copy")
        return batch, x, labels, info, (t1 - t0, t2 - t1)

    def _fused_ok(self) -> bool:
        """``device_loop``'s gate, the JAX engine's: the captured step must
        be device work alone, so the whole table on the device and no
        per-step host instrumentation."""
        return (isinstance(self.feature_source, HBMFeatureSource)
                and not self.config.dump_trace
                and not self.config.sanity_check
                and not self.profiler._log_node_access
                and self._dyn_freq is None)

    def _train_epoch_fused(self, epoch: int) -> dict:
        """The ``device_loop`` epoch: the captured step replayed once a
        step (captured at the first such epoch, and again after an
        overflow grew the sampler)."""
        cfg, prof = self.config, self.profiler
        shuffler = Shuffler(self.ds.train_set, cfg.batch_size,
                            seed=cfg.seed + 1, num_worker=1)
        steps = shuffler.num_local_step
        seeds = np.empty((steps, cfg.batch_size), C.ID_DTYPE)
        num_valid = np.empty((steps,), np.int32)
        for s, (b_seeds, n) in enumerate(shuffler.epoch_batches(epoch)):
            seeds[s], num_valid[s] = b_seeds, n
        gen_seeds = [(seed_of(cfg.seed, _SAMPLE, epoch, s),
                      seed_of(cfg.seed, _DROPOUT, epoch, s))
                     for s in range(steps)]
        if self._fused is None or self._fused.steps != steps:
            self._fused = FusedEpoch(self, steps)
            prof.log_init("device_loop_capture_time", self._fused.capture_s)
        t0 = time.perf_counter()
        # ONE device-to-host pull for the epoch's metrics
        loss_v, acc_v, over_v, nin_v = self._fused.run(seeds, num_valid,
                                                       gen_seeds)
        dt = time.perf_counter() - t0
        self.history[epoch] = {"loss": loss_v, "acc": acc_v,
                               "overflow": over_v, "num_input": nin_v}
        for s in range(steps):
            prof.log_step(epoch, s, P.L1_NUM_NODE, float(nin_v[s]))
        n_over = int(over_v.sum())
        if n_over:
            print(f"warning: {n_over} batches overflowed capacity in epoch "
                  f"{epoch}")
            prof.log_step(epoch, 0, P.L3_OVERFLOW_RETRY, float(n_over))
            self.sampler = self.sampler.grow()
            self._fused = None  # capacities changed: capture again
        loss = _nanmean(loss_v)
        acc = _nanmean(np.where(np.isnan(loss_v), np.nan, acc_v))
        prof.log_epoch_add(epoch, "epoch_time", dt)
        return {"epoch": epoch, "loss": loss, "train_acc": acc, "time": dt}

    def train_epoch(self, epoch: int) -> dict:
        cfg, prof = self.config, self.profiler
        if cfg.device_loop:
            if self._fused_ok():
                return self._train_epoch_fused(epoch)
            if not self._fused_warned:
                self._fused_warned = True
                logging.getLogger(__name__).warning(
                    "device_loop requested but ineligible (needs all-HBM "
                    "features, no per-step host instrumentation); using the "
                    "host-driven loop")
        shuffler = Shuffler(self.ds.train_set, cfg.batch_size,
                            seed=cfg.seed + 1, num_worker=1)

        def work():
            for step, step_item in enumerate(shuffler.epoch_batches(epoch)):
                yield (step_item, seed_of(cfg.seed, _SAMPLE, epoch, step),
                       (epoch, step))

        stream = (
            Prefetcher(work(), self._produce, depth=cfg.prefetch_depth,
                       device=self.device)
            if cfg.pipeline
            # unpipelined, each stage's host time covers its device work
            else (self._produce(item, sync=True) for item in work())
        )
        losses, accs, overflows, num_inputs = [], [], [], []
        hits, misses = [], []
        stages = {"sample": [], "extract": [], "train": []}
        t_epoch = time.perf_counter()
        try:
            for step, (batch, x, labels, info, (t_sample, t_extract)) in (
                enumerate(stream)
            ):
                if cfg.dump_trace:
                    prof.trace_begin(epoch, step, "train")
                t0 = time.perf_counter()
                gen = generator(self.device,
                                seed_of(cfg.seed, _DROPOUT, epoch, step))
                metrics = self._train(batch, x, labels, gen)
                if not cfg.pipeline:
                    self._sync()
                t_train = time.perf_counter() - t0
                if cfg.dump_trace:
                    prof.trace_end(epoch, step, "train")
                prof.log_step(epoch, step, P.L1_SAMPLE_TIME, t_sample)
                prof.log_step(epoch, step, P.L1_COPY_TIME, t_extract)
                prof.log_step(epoch, step, P.L1_TRAIN_TIME, t_train)
                if info.get("hit_rate") is not None:
                    prof.log_step(epoch, step, P.L2_CACHE_HIT_RATE,
                                  info["hit_rate"])
                    prof.log_step(epoch, step, P.L1_MISS_BYTES,
                                  info["miss_bytes"])
                stages["sample"].append(t_sample)
                stages["extract"].append(t_extract)
                stages["train"].append(t_train)
                losses.append(metrics["loss"])
                accs.append(metrics["acc"])
                overflows.append(batch.overflow)
                num_inputs.append(batch.num_input)
                if "num_hit" in info:
                    hits.append(info["num_hit"])
                    misses.append(info["num_miss"])
        finally:
            # stop the producer even if training raised: it must not go on
            # queueing device work after the consumer is gone
            if isinstance(stream, Prefetcher):
                stream.close()
        hit_rate = float("nan")
        if losses:
            # ONE device-to-host pull for the epoch's metrics
            # counts below 2^24 a step: exact in float32
            cols = [torch.stack(losses).float(), torch.stack(accs).float(),
                    torch.stack(overflows).float(),
                    torch.stack(num_inputs).float()]
            if hits:
                cols += [torch.stack(hits).float(),
                         torch.stack(misses).float()]
            stats = torch.stack(cols).cpu().numpy()
            loss_v, acc_v, over_v, nin_v = stats[:4]
            self.history[epoch] = {"loss": loss_v, "acc": acc_v,
                                   "overflow": over_v, "num_input": nin_v,
                                   "stages": stages}
            if hits:
                hit_v, miss_v = stats[4], stats[5]
                self.history[epoch].update(hit=hit_v, miss=miss_v)
                total = hit_v.sum() + miss_v.sum()
                hit_rate = float(hit_v.sum() / max(total, 1.0))
                prof.log_step(epoch, 0, P.L2_CACHE_HIT_RATE, hit_rate)
                row_bytes = self.feature_source.row_bytes
                for step, m in enumerate(miss_v):
                    prof.log_step(epoch, step, P.L1_MISS_BYTES,
                                  float(m) * row_bytes)
            for step, n in enumerate(nin_v):
                prof.log_step(epoch, step, P.L1_NUM_NODE, float(n))
            if over_v.sum():
                print(f"warning: {int(over_v.sum())} batches overflowed "
                      f"capacity in epoch {epoch}")
                prof.log_step(epoch, 0, P.L3_OVERFLOW_RETRY,
                              float(over_v.sum()))
                self.sampler = self.sampler.grow()
            loss = _nanmean(loss_v)
            acc = _nanmean(np.where(np.isnan(loss_v), np.nan, acc_v))
        else:
            loss = acc = float("nan")
        dt = time.perf_counter() - t_epoch
        prof.log_epoch_add(epoch, "epoch_time", dt)
        refresh = (cfg.barriered_epoch in (-1, 0)
                   or epoch == cfg.barriered_epoch)
        if self._dyn_freq is not None and refresh:
            # the dynamic cache takes the hottest rows by the running access
            # counts (the top-k and the rebuild stay on the device)
            k = self.feature_source.num_cache
            if k > 0:
                top = torch.topk(self._dyn_freq, k).indices.to(torch.int32)
                self.feature_source.refresh(top)
        return {
            "epoch": epoch, "loss": loss, "train_acc": acc, "time": dt,
            "hit_rate": hit_rate,
        }

    def evaluate(self, split: str = "valid",
                 max_batches: Optional[int] = None) -> float:
        """The sampled accuracy over the valid (or test) nodes: batches of
        ``batch_size`` in the order ``Shuffler(nodes, seed=0)`` gives them,
        batch ``i`` sampled from ``seed_of(123, i)``, the forward without
        dropout, and the batches' accuracies averaged with their node
        counts as weights, pulled to the host once."""
        nodes = self.ds.valid_set if split == "valid" else self.ds.test_set
        if len(nodes) == 0:
            return float("nan")
        shuffler = Shuffler(nodes, self.config.batch_size, seed=0)
        accs, weights = [], []
        for i, (seeds, n) in enumerate(shuffler.epoch_batches(0)):
            if max_batches is not None and i >= max_batches:
                break
            batch, x, labels, _, _ = self._produce(
                ((seeds, n), seed_of(_EVALUATE, i), (-1, i)))
            accs.append(eval_step(self.model, batch.blocks, x, labels,
                                  batch.num_output))
            weights.append(n)
        accs = torch.stack(accs).float().cpu().numpy()
        return float(np.average(accs, weights=weights))

    # ------------------------------------------------------------------- run
    def run(self) -> dict:
        """``init``, then epochs up to ``num_epoch``: resumed from the
        newest checkpoint of ``checkpoint_dir`` where there is one, the
        valid accuracy every ``report_acc`` epochs, a checkpoint every
        ``checkpoint_every``; then the trace (``dump_trace``), the
        node-access files and the ``test_result:`` lines, into the working
        directory and stdout as the JAX engine writes them."""
        cfg = self.config
        self.init()
        ckpt = None
        start_epoch = 0
        if cfg.checkpoint_dir:
            ckpt = CheckpointManager(cfg.checkpoint_dir)
            state, extra = ckpt.restore((self.model, self.opt))
            if state is not None:
                start_epoch = (extra or {}).get("epoch", -1) + 1
                print(f"resumed from checkpoint at epoch {start_epoch}")
        results = []
        for epoch in range(start_epoch, cfg.num_epoch):
            r = self.train_epoch(epoch)
            results.append(r)
            if cfg.report_acc and epoch % max(cfg.report_acc, 1) == 0:
                r["valid_acc"] = self.evaluate("valid")
            if ckpt and (epoch + 1) % cfg.checkpoint_every == 0:
                ckpt.save(epoch, (self.model, self.opt),
                          extra={"epoch": epoch})
        if ckpt:
            ckpt.close()
        if cfg.dump_trace:
            path = "xgnn_trace.json"
            self.profiler.dump_trace(path)
            print(f"trace dumped to {path}")
        if self.profiler._log_node_access:
            deg = self.ds.degrees
            self.profiler.dump_node_access(
                "node_access.txt", in_degrees=deg, out_degrees=deg)
            self.profiler.dump_node_access_frequency(
                "node_access_frequency.txt", self.ds.num_node)
            self.profiler.dump_node_access_similarity(
                "node_access_similarity.txt")
            opt = self.profiler.optimal_cache_hit_rate(
                max(cfg.cache_percentage, 0.0), self.ds.num_node)
            print(f"test_result:optimal_cache_hit_rate={opt:.6f}")
        out = self.profiler.test_results(extra={
            "final_train_acc": results[-1]["train_acc"] if results else 0.0})
        return {"epochs": results, "test_results": out}
