"""The collocated multi-card engine (XGNN's arch6): one rank a card.

The port of ``xgnn_tpu/engine/multi_engine.py``'s ``MultiChipEngine`` in
its fused shape: the topology replicated on every rank or partitioned over
them (``use_dist_graph``, the whole CSR on the cards), the features and
labels interleaved over the ranks' devices (``cache_percentage`` 0 or >=
1: JAX's all-device store), and one step a batch shard a rank
(``parallel/collocated.py``).  Each rank is a process with its own
:class:`~xgnn_tpu_torch.parallel.mesh.Mesh`; at P = 1 the engine makes a
world of one in the caller's process.

As in JAX: ``init`` partitions the topology and interleaves the labels and
features (each rank builds its own part on its device), and calibrates the
frontier capacities from ``calibration_batches`` warm-up batches, every
rank's sizes max-reduced, with ``ALLOC_SCALE`` headroom; the exchange
segment is ``min(max(ceil(cap[-1] / P * exchange_headroom), 128),
cap[-1])``.  ``train_epoch`` shuffles with ``Shuffler(num_worker=P,
worker_id=rank, seed=seed + 1)`` and every rank takes ``max(num_local_step)``
steps (an exhausted rank trains on an empty shard, weighing nothing), so
the collectives meet.  A step that overflowed anywhere was skipped on
every rank; after the epoch the ranks, which all read the same reduced
flags, grow every capacity twofold and replay those steps with their own
seeds and generators, so no batch is lost.  ``evaluate`` counts each
valid (or test) node once, summed over the ranks, an overflowed batch
again at transient grown capacities.  ``run`` trains ``num_epoch``
epochs with the accuracy report and checkpoints (written by rank 0), and
rank 0 prints the ``test_result:`` lines.

Not ported here, each refused naming ROADMAP's **Multi-GPU**: the
two-phase GGMS (a partial cache, ``0 < cache_percentage < 1``), the host
cold tier under the partitioned topology (``dist_graph_percentage < 1``),
DCN groups, the multi-card ``device_loop``, ``auto_placement`` and the
disaggregated engine (arch5).
"""

from __future__ import annotations

import contextlib
import io
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from .. import profiler as P
from ..checkpoint import CheckpointManager
from ..config import WEIGHTED, RunArch, RunConfig
from ..device import feature_dtype, generator, seed_of, to_tensor
from ..models import build_model
from ..parallel.collocated import (
    make_collocated_train_step,
    make_fused_eval_step,
    sample_any,
)
from ..parallel.dist_topology import partition_part
from ..parallel.exchange import interleaved_part
from ..parallel.mesh import MULTI_GPU, Mesh, make_mesh
from ..sampler import _layer_fanouts, default_capacities
from ..store.feature_store import HBMFeatureSource
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
from .shuffler import Shuffler

EMPTY = C.EMPTY_KEY
_SEED_CALIBRATE = 0x5EED  # the JAX engine's calibration shuffle: seed ^ it


def refuse_unported(config: RunConfig):
    """Raise for the multi-card configurations not ported yet."""
    why = None
    if config.arch == RunArch.DISAGGREGATED:
        why = "the disaggregated engine (arch5)"
    elif config.num_dcn_groups != 1:
        why = "DCN groups (num_dcn_groups > 1)"
    elif 0.0 < config.cache_percentage < 1.0:
        why = ("the two-phase GGMS (a partial feature cache, 0 < "
               "cache_percentage < 1)")
    elif config.use_dist_graph and config.dist_graph_percentage < 1.0:
        why = ("the host cold tier under the partitioned topology "
               "(dist_graph_percentage < 1)")
    elif config.device_loop:
        why = "the multi-card device_loop"
    elif config.auto_placement:
        why = "the multi-card placement solve (auto_placement)"
    if why is not None:
        raise NotImplementedError(
            f"not ported to xgnn_tpu_torch yet: {why}: {MULTI_GPU}")


def _array(ds, name: str):
    g = getattr(ds, "graph", None)
    if g is not None and getattr(g, name, None) is not None:
        return getattr(g, name)
    return getattr(ds, name, None)


class MultiChipEngine:
    """Data-parallel training over ``config.num_worker`` ranks, this
    process being one of them (``mesh``), or a world of one on ``device``
    (the card by default)."""

    _MAX_GROWTHS = 4

    def __init__(self, dataset, config: RunConfig, device=None,
                 mesh: Optional[Mesh] = None):
        refuse_unported(config)
        size = 1 if mesh is None else mesh.size
        if size != config.num_worker:
            raise ValueError(f"num_worker={config.num_worker}, and the mesh "
                             f"has {size} ranks")
        self.ds = dataset
        self.config = config
        self.mesh = mesh if mesh is not None else make_mesh(device)
        self.device = self.mesh.device
        self.rank, self.num_parts = self.mesh.rank, self.mesh.size
        bf16 = config.feat_dtype == "bfloat16" or (
            feature_dtype(dataset.feat) == torch.float16
            and config.compute_dtype == "bfloat16")
        self.feat_dtype = torch.bfloat16 if bf16 else None
        self.profiler = P.Profiler()
        self.history: dict = {}
        self.model = None
        self.opt: Optional[Adam] = None

    # ------------------------------------------------------------------ init
    def init(self):
        cfg, prof, dev = self.config, self.profiler, self.device
        p, rank = self.num_parts, self.rank
        t0 = time.perf_counter()
        weighted = cfg.sample_type in WEIGHTED
        tables = [None if not weighted or _array(self.ds, n) is None
                  else to_tensor(_array(self.ds, n), dev)
                  for n in ("prob_table", "alias_table", "prob_prefix_table")]
        if cfg.use_dist_graph:
            indptr = to_tensor(_array(self.ds, "indptr"), dev)
            self.topo = partition_part(
                indptr, to_tensor(_array(self.ds, "indices"), dev,
                                  torch.int32), p, rank, None, *tables)
        else:
            g = getattr(self.ds, "graph", None)
            self.topo = (g if g is not None and g.indptr.device == dev
                         else Graph.from_dataset(self.ds, dev,
                                                 weighted=weighted))
        label = to_tensor(self.ds.label, dev, torch.int32)
        self.lab_part = interleaved_part(label, p, rank).reshape(-1, 1)
        prof.log_init("graph_load_time", time.perf_counter() - t0)
        prof.log_mem_usage("graph_load", dev)
        t0 = time.perf_counter()
        self.capacities = [int(c) for c in (
            cfg.frontier_capacities or default_capacities(
                cfg.batch_size, _layer_fanouts(cfg), self.ds.num_node))]
        self._derive_exchange_caps()
        self._calibrate()
        prof.log_init("presample_time", time.perf_counter() - t0)
        t0 = time.perf_counter()
        feat = self.ds.feat
        if not isinstance(feat, torch.Tensor):
            feat = np.asarray(feat)
        self.feat_part = HBMFeatureSource(interleaved_part(feat, p, rank),
                                          dev, self.feat_dtype).feat
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

    def _derive_exchange_caps(self):
        """A rank's segment for each peer: the even split of the last
        frontier with headroom, never more than the frontier itself."""
        cap = self.capacities[-1]
        self.seg_cap = min(max(int(np.ceil(
            cap / self.num_parts * self.config.exchange_headroom)), 128), cap)

    def _calibrate(self):
        """Tighten the frontier capacities from warm-up batches: each rank
        samples its shard, the sizes are max-reduced over the ranks and the
        batches, then scaled by ALLOC_SCALE."""
        cfg = self.config
        if cfg.frontier_capacities is not None or cfg.calibration_batches <= 0:
            return
        seed = cfg.seed ^ _SEED_CALIBRATE
        total = min(self._num_steps(self.ds.train_set, seed),
                    max(cfg.calibration_batches, 1))
        it = self._shuffler(self.ds.train_set, seed).epoch_batches(0)
        sizes = []
        for step in range(total):
            seeds, n = self._next(it)
            gen = generator(self.device,
                            seed_of(cfg.seed, _CALIBRATE, step, self.rank))
            batch = sample_any(self.topo, seeds, n, cfg, self.capacities,
                               self.seg_cap, self.mesh, cfg.use_dist_graph,
                               gen)
            sizes.append(torch.stack(
                [batch.num_output.to(torch.int32).reshape(())]
                + [b.num_src.to(torch.int32).reshape(())
                   for b in reversed(batch.blocks)]))
        observed = torch.stack(sizes).amax(0)
        self.mesh.all_reduce(observed, dist.ReduceOp.MAX)
        observed = observed.cpu().tolist()
        self.capacities = [self.capacities[0]] + [
            _align_up(int(s * C.ALLOC_SCALE), self.ds.num_node)
            for s in observed[1:]]
        self._derive_exchange_caps()
        self.profiler.log_init("calibrated_input_cap", self.capacities[-1])

    def _build_step_fns(self):
        cfg = self.config
        self.step_fn = make_collocated_train_step(
            self.model, self.opt, cfg, self.mesh, self.capacities,
            self.seg_cap, cfg.use_dist_graph)
        self._fn_eval = make_fused_eval_step(
            self.model, cfg, self.mesh, self.capacities, self.seg_cap,
            cfg.use_dist_graph)

    # ----------------------------------------------------------------- steps
    def _shuffler(self, nodes, seed: int, worker: Optional[int] = None):
        return Shuffler(nodes, self.config.batch_size,
                        num_worker=self.num_parts,
                        worker_id=self.rank if worker is None else worker,
                        seed=seed)

    def _num_steps(self, nodes, seed: int) -> int:
        """Steps every rank takes: the longest shard's."""
        return max(self._shuffler(nodes, seed, w).num_local_step
                   for w in range(self.num_parts))

    def _next(self, it):
        """This rank's next shard of seeds on the device, EMPTY when its
        shard is exhausted."""
        seeds, n = next(it, (None, 0))
        if seeds is None:
            seeds = np.full(self.config.batch_size, EMPTY, C.ID_DTYPE)
        host = torch.from_numpy(seeds)
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True), n

    def _generators(self, epoch: int, step: int):
        cfg, r = self.config, self.rank
        return (generator(self.device, seed_of(cfg.seed, _SAMPLE, epoch,
                                               step, r)),
                generator(self.device, seed_of(cfg.seed, _DROPOUT, epoch,
                                               step, r)))

    def _run_one_step(self, seeds, n, epoch: int, step: int) -> dict:
        gen, dgen = self._generators(epoch, step)
        return self.step_fn(self.topo, self.feat_part, self.lab_part, seeds,
                            n, gen, dgen)

    def train_epoch(self, epoch: int) -> dict:
        cfg, prof = self.config, self.profiler
        seed = cfg.seed + 1
        num_steps = self._num_steps(self.ds.train_set, seed)
        it = self._shuffler(self.ds.train_set, seed).epoch_batches(epoch)
        metrics, records = [], []
        t_epoch = t_prev = time.perf_counter()
        for step in range(num_steps):
            seeds, n = self._next(it)
            records.append((seeds, n, step))
            if cfg.dump_trace:
                prof.trace_begin(epoch, step, "train")
            metrics.append(self._run_one_step(seeds, n, epoch, step))
            if cfg.dump_trace:
                metrics[-1]["loss"].item()
                prof.trace_end(epoch, step, "train")
            now = time.perf_counter()
            # sample, exchange and train are one fused step: its host time
            # is logged as train time, as JAX logs its fused program's
            prof.log_step(epoch, step, P.L1_TRAIN_TIME, now - t_prev)
            t_prev = now
        # ONE device-to-host pull for the epoch's metrics
        stats = torch.stack([torch.stack([m[k].float() for m in metrics])
                             for k in ("loss", "acc", "overflow",
                                       "num_input")]).cpu().numpy()
        loss_v, acc_v, over_v, nin_v = stats
        self.history[epoch] = {"loss": loss_v, "acc": acc_v,
                               "overflow": over_v, "num_input": nin_v}
        for step, v in enumerate(nin_v):
            prof.log_step(epoch, step, P.L1_NUM_NODE, float(v))
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
        return {
            "epoch": epoch,
            "loss": _nanmean(np.concatenate([loss_v, extra_losses])),
            "train_acc": _nanmean(np.concatenate([acc_v, extra_accs])),
            "time": dt, "steps": num_steps, "hit_rate": 1.0,
            "contributed_steps": int(np.isfinite(loss_v).sum())
            + len(extra_losses),
        }

    def _grow_capacities(self):
        """Every static capacity doubled, the step functions rebuilt (the
        single store's Sampler.grow)."""
        self.capacities = [self.capacities[0]] + [
            _align_up(int(c * 2), self.ds.num_node)
            for c in self.capacities[1:]]
        self.seg_cap *= 2
        self._build_step_fns()

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
        untouched (an eval outlier must not reshape the training path)."""
        caps = [self.capacities[0]] + [
            _align_up(int(c * scale), self.ds.num_node)
            for c in self.capacities[1:]]
        return make_fused_eval_step(self.model, self.config, self.mesh, caps,
                                    self.seg_cap * scale,
                                    self.config.use_dist_graph)

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
                                for w in range(self.num_parts))
                     for s in range(num_steps))

        def eval_one(seeds, n, step, fn):
            g = generator(self.device, seed_of(_EVALUATE, step, self.rank))
            return fn(self.topo, self.feat_part, self.lab_part, seeds, n, g)

        batches, outs = [], []
        for step in range(num_steps):
            seeds, n = self._next(it)
            batches.append((seeds, n, step))
            outs.append(torch.stack(eval_one(seeds, n, step,
                                             self._fn_eval)).float())
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
        ``checkpoint_every`` (rank 0 writes it); rank 0 prints the
        ``test_result:`` lines."""
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
        extra = {"final_train_acc": results[-1]["train_acc"] if results
                 else 0.0, "cache_hit_rate": 1.0}
        quiet = (contextlib.nullcontext() if self.rank == 0
                 else contextlib.redirect_stdout(io.StringIO()))
        with quiet:
            out = self.profiler.test_results(extra=extra)
        return {"epochs": results, "test_results": out}

    def close(self):
        """End the process group where this engine made it (a world of
        one)."""
        self.mesh.close()

