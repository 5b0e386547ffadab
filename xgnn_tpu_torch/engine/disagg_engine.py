"""The disaggregated engine (XGNN's arch5, the FGNN / GNNLab mode): sampler
devices feed data-parallel trainer devices.

The port of ``xgnn_tpu/engine/disagg_engine.py`` (lines 53-448), driven
from one process as JAX drives it (``parallel/disaggregated.py`` says why):

- ``num_sample_worker`` samplers round-robin over their devices
  (``DisaggregatedSampler``), each batch shipped to its trainer's device;
- each of ``num_train_worker`` trainers holds its own feature store (the
  whole table on its device through K1, or, for ``0 < cache_percentage <
  1``, the tiered store: a hot-row cache on the device ranked by
  ``cache_policy`` and the misses read in place from pinned host memory by
  K11, one host table for every trainer, registered once for every
  device) and its labels (K1), in ``feat_dtype``;
- the trainers' step is ``make_disagg_train_step``: a model replica and an
  Adam a trainer, the seed-weighted reduction in trainer order.

With fewer devices than roles the roles share devices round-robin, JAX's
role-degenerate shape (``bench.py:129-141``, ``XGNN_BENCH_ARCH5=1``): one
card samples and trains, the handoff a no-op.  ``device="cpu"`` gives each
role an entry of its own on the CPU.

``init`` runs the presample policies on sampler 0 (``presample_static``
through its exact closure, or under a sampler tier the wide khop0 of
``static_presample_config``).  Each step's samples and extracts run in
``_produce``, under the ``Prefetcher`` when ``pipeline`` (on a card its
side stream, on sampler 0's device), with ``sanity_check`` pulling each
batch's flags there.  ``train_epoch`` shards the epoch as JAX's ``work()``
does (``Shuffler(num_worker=M, worker_id=t, seed=seed + 1)``, every
trainer ``max(num_local_step)`` steps, an exhausted one an EMPTY shard),
pulls the epoch's metrics once and, where a step overflowed (it was skipped
on every trainer), doubles the samplers' capacities for the next epoch.
``evaluate`` samples round-robin and reads through trainer 0.
``_rebalance`` re-roles the devices at an epoch's end, keeping the model
and Adam's state; ``balance_switcher`` calls it from the epoch's sample
share (``_maybe_rebalance``).  ``run`` adds checkpoints (trainer 0's
replica) and the ``test_result:`` lines.  The sampling and dropout
generators are seeded per step and trainer (``seed_of``), so a run is
deterministic; its draws differ from JAX's keys.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from .. import profiler as P
from ..checkpoint import CheckpointManager
from ..config import CachePolicy, RunConfig
from ..device import feature_dtype, generator, resolve, seed_of
from ..models import build_model
from ..ops import sanity
from ..ops.tiered import MappedHostTable
from ..parallel.disaggregated import (
    DisaggregatedSampler,
    batch_to_shard,
    make_disagg_train_step,
)
from ..sampler import Sampler
from ..store.feature_store import (
    HBMFeatureSource,
    LabelSource,
    TieredFeatureSource,
)
from ..store.presample import (
    presample_ranking,
    static_exact_ranking,
    static_presample_config,
)
from ..store.ranking import FREQUENCY_POLICIES, build_ranking
from ..train import Adam, eval_step
from .engine import _DROPOUT, _EVALUATE, _SAMPLE, _nanmean
from .pipeline import Prefetcher
from .shuffler import Shuffler

EMPTY = C.EMPTY_KEY


def role_devices(devices: Sequence, num_sample: int, num_train: int):
    """``(sample_devices, train_devices)``: the first ``num_sample``
    devices sample and the next ``num_train`` train, or, with fewer devices
    than roles, the roles share them round-robin (JAX's role-degenerate
    mode); the trainers need devices of their own."""
    devices, n = list(devices), len(devices)
    if num_sample < 1 or num_train < 1:
        raise ValueError(f"{num_sample} samplers and {num_train} trainers: "
                         "each role needs one at least")
    if n >= num_sample + num_train:
        return devices[:num_sample], devices[num_sample:num_sample + num_train]
    if num_train > n:
        raise ValueError(f"{num_train} trainers need distinct devices, have "
                         f"{n}")
    return ([devices[i % n] for i in range(num_sample)],
            [devices[(num_sample + i) % n] for i in range(num_train)])


class DisaggregatedEngine:
    """``config.num_sample_worker`` sampler roles feeding
    ``config.num_train_worker`` trainer roles over ``devices`` (every card
    by default; ``device`` gives each role an entry of its own on that
    device, ``device="cpu"`` on the CPU)."""

    def __init__(self, dataset, config: RunConfig,
                 devices: Optional[Sequence] = None, device=None):
        self.ds = dataset
        # the engine re-roles its own copy of the config
        self.config = config = dataclasses.replace(config)
        ns, nt = config.num_sample_worker, config.num_train_worker
        if devices is None:
            dev = resolve(device)
            devices = ([dev] * (ns + nt) if device is not None else
                       [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())])
        self.sample_devices, self.train_devices = role_devices(
            [torch.device(d) for d in devices], ns, nt)
        self.num_trainer = nt
        bf16 = config.feat_dtype == "bfloat16" or (
            feature_dtype(dataset.feat) == torch.float16
            and config.compute_dtype == "bfloat16")
        self.feat_dtype = torch.bfloat16 if bf16 else None
        self.profiler = P.Profiler()
        self.history: dict = {}
        self.svc: Optional[DisaggregatedSampler] = None
        self.feature_sources, self.label_sources = [], []
        # the tiered stores' one host table
        self._host_table: Optional[MappedHostTable] = None
        self.models, self.opts = [], []
        self._ranking = None

    @property
    def _tiered(self) -> bool:
        return 0.0 < self.config.cache_percentage < 1.0

    # ------------------------------------------------------------------ init
    def init(self):
        cfg, prof = self.config, self.profiler
        t0 = time.perf_counter()
        self.svc = DisaggregatedSampler(self.ds, cfg, self.sample_devices,
                                        cfg.frontier_capacities)
        prof.log_init("sample_init_time", time.perf_counter() - t0)
        t0 = time.perf_counter()
        if self._tiered:
            self._ranking = build_ranking(self.ds, cfg, self._presample())
        self._build_stores()
        prof.log_init("cache_build_time", time.perf_counter() - t0)
        t0 = time.perf_counter()
        model = build_model(cfg, self.ds.feat_dim, self.ds.num_class)
        self._replicate(model)
        prof.log_init("train_init_time", time.perf_counter() - t0)
        return self

    def _presample(self) -> Optional[np.ndarray]:
        """The frequency policies' access counts, presampled on sampler 0
        (the reference's worker 0)."""
        cfg = self.config
        if cfg.cache_policy not in FREQUENCY_POLICIES:
            return None
        sampler, dev = self.svc.samplers[0], self.svc.devices[0]
        num_node = self.ds.num_node
        if cfg.cache_policy == CachePolicy.PRE_SAMPLE_STATIC:
            if sampler.tier is None:
                # the exact all-neighbour closure over the whole topology
                return static_exact_ranking(sampler.graph,
                                            self.ds.train_set, cfg,
                                            num_node, dev)
            sampler = Sampler(sampler.graph, static_presample_config(cfg),
                              tier=sampler.tier, num_node=sampler.num_node)
        return presample_ranking(sampler, self.ds.train_set, cfg, num_node,
                                 dev)

    def _build_stores(self):
        """Each trainer's feature and label sources on its device; the
        tiered stores share one pinned, mapped host table, registered once
        for every device of the process."""
        self._close_stores()
        if self._tiered:
            self._host_table = MappedHostTable(self.ds.feat,
                                               self.train_devices[0])
        for dev in self.train_devices:
            if self._tiered:
                src = TieredFeatureSource(self.ds.feat, self._ranking,
                                          self.config.cache_percentage, dev,
                                          self.feat_dtype,
                                          host=self._host_table)
            else:
                src = HBMFeatureSource(self.ds.feat, dev, self.feat_dtype)
            self.feature_sources.append(src)
            self.label_sources.append(LabelSource(self.ds.label, dev))

    def _close_stores(self):
        if self._host_table is not None:
            self._host_table.close()
            self._host_table = None
        self.feature_sources, self.label_sources = [], []

    def _replicate(self, model, opt: Optional[Adam] = None):
        """A replica of ``model`` (and of ``opt``'s state) on every
        trainer's device, and the step over them."""
        cfg = self.config
        models, opts = [], []
        for dev in self.train_devices:
            m = copy.deepcopy(model).to(dev)
            o = Adam(list(m.parameters()), cfg.lr,
                     weight_decay=cfg.weight_decay)
            if opt is not None:
                with torch.no_grad():
                    for dst, src in zip(o.mu + o.nu + [o.count],
                                        opt.mu + opt.nu + [opt.count]):
                        dst.copy_(src)
            models.append(m)
            opts.append(o)
        self.models, self.opts = models, opts
        self._train_step = make_disagg_train_step(models, opts)

    # ------------------------------------------------------------- pipeline
    def epoch_shards(self, nodes, seed: int, epoch: int):
        """``(num_steps, steps)``: each step's list of the trainers' shards
        ``(seeds, n)``, JAX's ``work()`` (an exhausted trainer's shard
        EMPTY, n 0)."""
        bs, m = self.config.batch_size, self.num_trainer
        shufflers = [Shuffler(nodes, bs, num_worker=m, worker_id=t,
                              seed=seed) for t in range(m)]
        num_steps = max(s.num_local_step for s in shufflers)
        its = [s.epoch_batches(epoch) for s in shufflers]

        def steps():
            for _ in range(num_steps):
                yield [next(it, (np.full(bs, EMPTY, C.ID_DTYPE), 0))
                       for it in its]

        return num_steps, steps()

    def _produce(self, item):
        """One step's batches: each trainer's shard sampled round-robin on
        the sampler devices, shipped to the trainer and extracted there.
        Returns the shards, the stores' hit and miss counts and the host
        time of the dispatch."""
        shards, (epoch, step) = item
        t0 = time.perf_counter()
        out, counts = [], []
        for t, (seeds, n) in enumerate(shards):
            batch = self.svc.sample_to(
                seeds, n, seed_of(self.config.seed, _SAMPLE, epoch, step, t),
                self.train_devices[t])
            if self.config.sanity_check:
                flags = int(sanity.check_batch(batch))
                if flags:
                    raise RuntimeError(
                        f"sanity check failed: {sanity.explain(flags)}")
            x, info = self.feature_sources[t].extract(batch.input_nodes,
                                                      batch.num_input)
            labels = self.label_sources[t].extract(batch.output_nodes,
                                                   batch.num_output)
            out.append(batch_to_shard(batch, x, labels))
            if "num_hit" in info:
                counts.append((info["num_hit"], info["num_miss"]))
        return out, counts, time.perf_counter() - t0

    def _stream(self, items):
        cfg = self.config
        if not cfg.pipeline:
            return map(self._produce, items)
        dev = self.sample_devices[0]
        return Prefetcher(items, self._produce, depth=cfg.prefetch_depth,
                          device=dev if dev.type == "cuda" else None)

    def train_epoch(self, epoch: int) -> dict:
        cfg, prof = self.config, self.profiler
        num_steps, steps = self.epoch_shards(self.ds.train_set, cfg.seed + 1,
                                             epoch)
        stream = self._stream(
            (shards, (epoch, step)) for step, shards in enumerate(steps))
        dev0 = self.train_devices[0]
        losses, accs, overs, hits, misses = [], [], [], [], []
        t_epoch = time.perf_counter()
        try:
            for step, (shards, counts, t_dispatch) in enumerate(stream):
                gens = [generator(dev, seed_of(cfg.seed, _DROPOUT, epoch,
                                               step, t))
                        for t, dev in enumerate(self.train_devices)]
                if cfg.dump_trace:
                    prof.trace_begin(epoch, step, "train")
                t0 = time.perf_counter()
                m = self._train_step(shards, gens)
                if cfg.dump_trace:
                    m["loss"].item()
                    prof.trace_end(epoch, step, "train")
                # host times: the samples' and extracts' dispatch, the
                # train step's enqueue
                prof.log_step(epoch, step, P.L1_TRAIN_TIME,
                              time.perf_counter() - t0)
                prof.log_step(epoch, step, P.L1_SAMPLE_TIME, t_dispatch)
                prof.log_epoch_add(epoch, "sample_dispatch", t_dispatch)
                losses.append(m["loss"])
                accs.append(m["acc"])
                overs.append(m["overflow"])
                for h, mi in counts:
                    hits.append(h.to(dev0))
                    misses.append(mi.to(dev0))
        finally:
            if isinstance(stream, Prefetcher):
                stream.close()
        # ONE device-to-host pull for the epoch's metrics (float64: the
        # hit and miss counts of every trainer and step sum exactly)
        cols = [torch.stack(v).double() for v in (losses, accs, overs)]
        if hits:
            cols.append(torch.stack([torch.stack(hits).double().sum(),
                                     torch.stack(misses).double().sum()]))
        pulled = torch.cat(cols).cpu().numpy() if losses else \
            np.full(3, np.nan)
        stats = pulled[:3 * num_steps].reshape(3, -1)
        dt = time.perf_counter() - t_epoch
        prof.log_epoch_add(epoch, "epoch_time", dt)
        self.history[epoch] = {"loss": stats[0], "acc": stats[1],
                               "overflow": stats[2]}
        hit_rate = 1.0
        if hits:
            n_hit, n_miss = pulled[3 * num_steps:]
            hit_rate = float(n_hit / max(n_hit + n_miss, 1.0))
            self.history[epoch]["hit_rate"] = hit_rate
            prof.log_step(epoch, 0, P.L2_CACHE_HIT_RATE, hit_rate)
        n_over = int(np.nansum(stats[2]))
        if n_over:
            # the overflowed steps were skipped on every trainer; the next
            # epoch samples at grown capacities
            print(f"warning: {n_over} steps overflowed capacity in epoch "
                  f"{epoch}; growing sampler capacities")
            prof.log_step(epoch, 0, P.L3_OVERFLOW_RETRY, float(n_over))
            self.svc = DisaggregatedSampler(
                self.ds, cfg, self.sample_devices,
                self.svc.samplers[0].grow().capacities,
                topologies=self.svc.topologies)
        return {"epoch": epoch, "loss": _nanmean(stats[0]),
                "train_acc": _nanmean(stats[1]), "time": dt,
                "steps": num_steps, "hit_rate": hit_rate}

    def evaluate(self, split: str = "valid",
                 max_batches: Optional[int] = None) -> float:
        """The sampled accuracy over the valid (or test) nodes through
        trainer 0: batches of ``Shuffler(nodes, seed=0)``, batch ``i``
        sampled round-robin from ``seed_of(123, i)``, the accuracies
        weighted by the batches' node counts, pulled once."""
        nodes = self.ds.valid_set if split == "valid" else self.ds.test_set
        if len(nodes) == 0:
            return float("nan")
        dev0 = self.train_devices[0]
        accs, weights = [], []
        for i, (seeds, n) in enumerate(Shuffler(
                nodes, self.config.batch_size, seed=0).epoch_batches(0)):
            if max_batches is not None and i >= max_batches:
                break
            batch = self.svc.sample_to(seeds, n, seed_of(_EVALUATE, i), dev0)
            x, _ = self.feature_sources[0].extract(batch.input_nodes,
                                                   batch.num_input)
            labels = self.label_sources[0].extract(batch.output_nodes,
                                                   batch.num_output)
            accs.append(eval_step(self.models[0], batch.blocks, x, labels,
                                  batch.num_output))
            weights.append(n)
        if not accs:
            return float("nan")
        accs = torch.stack(accs).float().cpu().numpy()
        return float(np.average(accs, weights=weights))

    # ------------------------------------------------- the balance switcher
    def _rebalance(self, num_sample: int, num_train: int):
        """Re-role the devices between the sampler and trainer pools at an
        epoch's end: the sampling service, the trainers' stores, replicas
        and step rebuilt; the model and Adam's state carried over."""
        cfg = self.config
        devices = list(self.sample_devices) + list(self.train_devices)
        if num_sample + num_train > len(devices):
            raise ValueError(f"{num_sample} + {num_train} roles over "
                             f"{len(devices)} devices")
        self.sample_devices, self.train_devices = role_devices(
            devices, num_sample, num_train)
        cfg.num_sample_worker, cfg.num_train_worker = num_sample, num_train
        self.num_trainer = num_train
        self.svc = DisaggregatedSampler(self.ds, cfg, self.sample_devices,
                                        self.svc.capacities,
                                        topologies=self.svc.topologies)
        self._build_stores()
        self._replicate(self.models[0], self.opts[0])
        print(f"balance_switcher: re-roled to {num_sample} samplers + "
              f"{num_train} trainers")

    def _maybe_rebalance(self, result: dict):
        """JAX's epoch-end rule: a sampling-bound epoch (over 0.6 of its
        time in the dispatch) moves a device to the samplers, a
        training-bound one (under 0.2) to the trainers."""
        cfg = self.config
        frac = (self.profiler._epoch_items[result["epoch"]]
                .get("sample_dispatch", 0.0) / max(result["time"], 1e-9))
        if frac > 0.6 and cfg.num_train_worker > 1:
            self._rebalance(cfg.num_sample_worker + 1,
                            cfg.num_train_worker - 1)
        elif frac < 0.2 and cfg.num_sample_worker > 1:
            self._rebalance(cfg.num_sample_worker - 1,
                            cfg.num_train_worker + 1)

    # ------------------------------------------------------------------- run
    def run(self) -> dict:
        """``init``, then epochs up to ``num_epoch`` (resumed from the newest
        checkpoint of ``checkpoint_dir`` where there is one, a checkpoint
        of trainer 0's replica every ``checkpoint_every``, the balance
        switcher between epochs), then the trace, the valid accuracy
        (``report_acc``) and the ``test_result:`` lines."""
        cfg = self.config
        self.init()
        ckpt = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir \
            else None
        start_epoch = 0
        if ckpt:
            state, extra = ckpt.restore((self.models[0], self.opts[0]))
            if state is not None:
                self._replicate(self.models[0], self.opts[0])
                start_epoch = (extra or {}).get("epoch", -1) + 1
                print(f"resumed from checkpoint at epoch {start_epoch}")
        results = []
        for epoch in range(start_epoch, cfg.num_epoch):
            r = self.train_epoch(epoch)
            results.append(r)
            if ckpt and (epoch + 1) % cfg.checkpoint_every == 0:
                ckpt.save(epoch, (self.models[0], self.opts[0]),
                          extra={"epoch": epoch})
            if cfg.balance_switcher and epoch + 1 < cfg.num_epoch:
                self._maybe_rebalance(r)
        if cfg.dump_trace:
            self.profiler.dump_trace("xgnn_trace.json")
            print("trace dumped to xgnn_trace.json")
        if cfg.report_acc:
            print(f"test_result:valid_acc={self.evaluate('valid'):.4f}")
        out = self.profiler.test_results(extra={
            "final_train_acc": results[-1]["train_acc"] if results else 0.0})
        return {"epochs": results, "test_results": out}

    def close(self):
        """Unmap the tiered stores' host tables and the samplers' host
        CSRs."""
        self._close_stores()
        if self.svc is not None:
            self.svc.close()
