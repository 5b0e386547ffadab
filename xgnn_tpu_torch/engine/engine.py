"""The training engine: init, calibration and the host epoch loop.

The port of ``xgnn_tpu/engine/engine.py``'s single-store ``Engine``: the
whole feature table on the device with direct extract, or, for a
``cache_percentage`` in (0, 1), the tiered store (a ranked hot-row cache on
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
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..config import WEIGHTED, CachePolicy, RunConfig
from ..device import generator, resolve, seed_of
from ..models import build_model
from ..ops.presample import accumulate_freq
from ..sampler import Sampler
from ..store.feature_store import (
    DynamicTieredFeatureSource,
    HBMFeatureSource,
    LabelSource,
    TieredFeatureSource,
)
from ..store.presample import presample_ranking, static_exact_ranking
from ..store.ranking import FREQUENCY_POLICIES, build_ranking
from ..train import Adam, eval_step, train_step
from ..types import Graph
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
    def __init__(self, dataset, config: RunConfig, device=None):
        self.ds = dataset
        self.config = config
        self.device = resolve(device)
        self.graph: Optional[Graph] = None
        self.sampler: Optional[Sampler] = None
        self.feature_source = None
        self.label_source = None
        self.model = None
        self.opt: Optional[Adam] = None
        self.history: dict = {}
        # host seconds of the init stages (presample, cache build)
        self.init_times: dict = {}
        self._dyn_freq: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------ init
    def init(self):
        cfg = self.config
        if getattr(self.ds, "graph", None) is not None:
            self.graph = self.ds.graph
        else:
            self.graph = Graph.from_dataset(
                self.ds, self.device, weighted=cfg.sample_type in WEIGHTED)
        # direct extract: the last sampled layer keeps global ids and the
        # first GNN layer reads the feature table itself; the tiered store
        # extracts the last layer's deduplicated ids instead
        self._direct = cfg.gpu_extract and not self._tiered
        self.sampler = Sampler(self.graph, cfg, direct_extract=self._direct)
        self._calibrate()
        self._build_feature_source()
        self.label_source = LabelSource(self.ds.label, self.device)
        self.model = build_model(cfg, self.ds.feat_dim, self.ds.num_class)
        self.model.to(self.device)
        self.opt = Adam(list(self.model.parameters()), cfg.lr)
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
                               direct_extract=self._direct)

    @property
    def _tiered(self) -> bool:
        return 0.0 < self.config.cache_percentage < 1.0

    def _build_feature_source(self):
        """The whole table on the device, or the tiered store with the
        ranking of ``cache_policy`` (presampled here where it needs access
        counts).  The features go to pinned host memory once."""
        cfg = self.config
        if not self._tiered:
            self.feature_source = HBMFeatureSource(self.ds.feat, self.device)
            return
        access_freq = None
        if cfg.cache_policy in FREQUENCY_POLICIES:
            t0 = time.perf_counter()
            if cfg.cache_policy == CachePolicy.PRE_SAMPLE_STATIC:
                # the exact all-neighbour closure over the whole topology
                access_freq = static_exact_ranking(
                    self.graph, self.ds.train_set, cfg, self.graph.num_node,
                    self.device)
            else:
                access_freq = presample_ranking(
                    self.sampler, self.ds.train_set, cfg,
                    self.sampler.num_node, self.device)
            self.init_times["presample"] = time.perf_counter() - t0
        ranking = build_ranking(self.ds, cfg, access_freq)
        t0 = time.perf_counter()
        cls = (DynamicTieredFeatureSource
               if cfg.cache_policy == CachePolicy.DYNAMIC
               else TieredFeatureSource)
        self.feature_source = cls(self.ds.feat, ranking,
                                  cfg.cache_percentage, self.device)
        self._sync()
        self.init_times["cache_build"] = time.perf_counter() - t0
        if cfg.cache_policy == CachePolicy.DYNAMIC:
            self._dyn_freq = torch.zeros(self.graph.num_node,
                                         dtype=torch.int32,
                                         device=self.device)

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

    def _produce(self, item, sync: bool = False):
        """Sample + extract for one step (in the prefetch thread when
        pipelining).  Returns host times of the two stages: on a CUDA
        device they measure the enqueue, unless ``sync`` waits for each
        stage's device work."""
        (seeds, num_valid), seed, _ = item
        t0 = time.perf_counter()
        gen = generator(self.device, seed)
        batch = self.sampler.sample(self._to_device(seeds), num_valid, gen)
        if self._dyn_freq is not None:
            accumulate_freq(self._dyn_freq, batch.input_nodes,
                            batch.num_input)
        if sync:
            self._sync()
        t1 = time.perf_counter()
        if self._direct:
            x, info = self.feature_source.feat, {"hit_rate": 1.0,
                                                 "miss_bytes": 0}
        else:
            x, info = self.feature_source.extract(batch.input_nodes,
                                                  batch.num_input)
        labels = self.label_source.extract(batch.output_nodes,
                                           batch.num_output)
        if sync:
            self._sync()
        t2 = time.perf_counter()
        return batch, x, labels, info, (t1 - t0, t2 - t1)

    def train_epoch(self, epoch: int) -> dict:
        cfg = self.config
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
        losses, accs, overflows, hits, misses = [], [], [], [], []
        stages = {"sample": [], "extract": [], "train": []}
        t_epoch = time.perf_counter()
        try:
            for step, (batch, x, labels, info, (t_sample, t_extract)) in (
                enumerate(stream)
            ):
                t0 = time.perf_counter()
                gen = generator(self.device,
                                seed_of(cfg.seed, _DROPOUT, epoch, step))
                metrics = train_step(
                    self.model, self.opt, batch.blocks, x, labels,
                    batch.num_output, gen, batch.overflow,
                )
                if not cfg.pipeline:
                    self._sync()
                stages["sample"].append(t_sample)
                stages["extract"].append(t_extract)
                stages["train"].append(time.perf_counter() - t0)
                losses.append(metrics["loss"])
                accs.append(metrics["acc"])
                overflows.append(batch.overflow)
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
            cols = [torch.stack(losses).float(), torch.stack(accs).float(),
                    torch.stack(overflows).float()]
            if hits:
                # counts below 2^24 a step: exact in float32
                cols += [torch.stack(hits).float(),
                         torch.stack(misses).float()]
            stats = torch.stack(cols).cpu().numpy()
            loss_v, acc_v, over_v = stats[:3]
            self.history[epoch] = {"loss": loss_v, "acc": acc_v,
                                   "overflow": over_v, "stages": stages}
            if hits:
                hit_v, miss_v = stats[3], stats[4]
                self.history[epoch].update(hit=hit_v, miss=miss_v)
                total = hit_v.sum() + miss_v.sum()
                hit_rate = float(hit_v.sum() / max(total, 1.0))
            if over_v.sum():
                print(f"warning: {int(over_v.sum())} batches overflowed "
                      f"capacity in epoch {epoch}")
                self.sampler = self.sampler.grow()
            loss = _nanmean(loss_v)
            acc = _nanmean(np.where(np.isnan(loss_v), np.nan, acc_v))
        else:
            loss = acc = float("nan")
        dt = time.perf_counter() - t_epoch
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
