"""The training engine: init, calibration and the host epoch loop.

The port of ``xgnn_tpu/engine/engine.py``'s single-store ``Engine`` on the
main path: the whole feature table on the device, direct extract, and a
pipelined host loop.  Per step nothing waits on the device; the overflow
flags, losses and accuracies come to the host in one pull per epoch, and an
overflow grows the sampler's capacities for the next epoch (the overflowed
steps were skipped on the device).  ``history[epoch]`` keeps each step's
loss, accuracy and overflow flag and the host time of each stage.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..config import RunConfig
from ..device import generator, resolve, seed_of
from ..models import build_model
from ..sampler import Sampler
from ..store.feature_store import HBMFeatureSource, LabelSource
from ..train import Adam, train_step
from ..types import Graph
from .pipeline import Prefetcher
from .shuffler import Shuffler

# stream tags mixed into the seeds, as the JAX engine xors its keys
_SAMPLE, _DROPOUT, _CALIBRATE = 0x5A3F1E, 0xD20F00, 0xCA11B


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

    # ------------------------------------------------------------------ init
    def init(self):
        cfg = self.config
        if getattr(self.ds, "graph", None) is not None:
            self.graph = self.ds.graph
        else:
            self.graph = Graph.from_dataset(self.ds, self.device)
        # direct extract: the last sampled layer keeps global ids and the
        # first GNN layer reads the feature table itself
        self._direct = cfg.gpu_extract
        self.sampler = Sampler(self.graph, cfg, direct_extract=self._direct)
        self._calibrate()
        self.feature_source = HBMFeatureSource(self.ds.feat, self.device)
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
        losses, accs, overflows = [], [], []
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
        finally:
            # stop the producer even if training raised: it must not go on
            # queueing device work after the consumer is gone
            if isinstance(stream, Prefetcher):
                stream.close()
        if losses:
            # ONE device-to-host pull for the epoch's metrics
            stats = torch.stack([
                torch.stack(losses).float(),
                torch.stack(accs).float(),
                torch.stack(overflows).float(),
            ]).cpu().numpy()
            loss_v, acc_v, over_v = stats
            self.history[epoch] = {"loss": loss_v, "acc": acc_v,
                                   "overflow": over_v, "stages": stages}
            if over_v.sum():
                print(f"warning: {int(over_v.sum())} batches overflowed "
                      f"capacity in epoch {epoch}")
                self.sampler = self.sampler.grow()
            loss = _nanmean(loss_v)
            acc = _nanmean(np.where(np.isnan(loss_v), np.nan, acc_v))
        else:
            loss = acc = float("nan")
        dt = time.perf_counter() - t_epoch
        return {
            "epoch": epoch, "loss": loss, "train_acc": acc, "time": dt,
            "hit_rate": float("nan"),
        }
