"""Disaggregated sampler and trainer roles (XGNN's arch5, the FGNN /
GNNLab mode).

The port of ``xgnn_tpu/parallel/disaggregated.py`` (lines 40-210).  The
reference runs sampler and trainer processes joined by a shared-memory task
queue, the trainers in DDP; JAX drives every role from one controller, the
queue a ``device_put`` from a sampler chip to a trainer chip and DDP a
``psum`` over the trainer mesh.

The port keeps JAX's shape: **one process drives every role.**

- ``DisaggregatedSampler``: one :class:`~xgnn_tpu_torch.sampler.Sampler` a
  sampler device (the topology built once a distinct device and shared by
  the samplers there), requests round-robin over them; ``sample_to`` draws
  the batch on the sampler's device and ships it to the trainer's with
  ``tensor.to(device, non_blocking=True)``, a no-op where the roles share
  a device.  With ``use_dist_graph`` and ``dist_graph_percentage < 1`` each
  sampler samples the tiered topology (``sampler.make_tiered_topology``:
  the hot prefix on its device, the whole CSR mapped from host memory,
  one pinned copy that every sampler device reads).
  The port has no ``cold_cap``, so JAX's third tier element has no
  counterpart.
- ``make_disagg_train_step``: a model replica and an ``Adam`` on each
  trainer device; each trainer's forward and backward, then the
  seed-count-weighted reduction of the gradients, loss and accuracy
  (``sum_t(v_t * w_t) / max(sum_t(w_t), 1)``, not a mean: a trainer with
  an empty shard weighs nothing), taken in trainer order on trainer 0's
  device and copied back, so the replicas stay bit-equal; the update,
  skipped on every trainer where any batch overflowed, the loss and
  accuracy NaN.

Trainer processes over ``torch.distributed``, the batches sent from
sampler processes over CUDA IPC (the reference's queue), would make every
re-role (``balance_switcher``) a teardown of the process group, and one
card could not test them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import WEIGHTED
from ..device import generator
from ..sampler import Sampler, make_tiered_topology
from ..types import Graph, SampledBatch
from .collocated import lane_loss_and_grads, unflatten_weighted, weighted_flat


def batch_to(batch: SampledBatch, device: torch.device) -> SampledBatch:
    """``batch`` with every tensor on ``device``, copied without waiting
    (the same tensors where it lies there already)."""
    move = lambda t: None if t is None else t.to(device, non_blocking=True)
    blocks = tuple(dataclasses.replace(
        b, neigh=move(b.neigh), num_dst=move(b.num_dst),
        num_src=move(b.num_src), dst_ids=move(b.dst_ids),
        weights=move(b.weights)) for b in batch.blocks)
    return SampledBatch(blocks=blocks, input_nodes=move(batch.input_nodes),
                        num_input=move(batch.num_input),
                        output_nodes=move(batch.output_nodes),
                        num_output=move(batch.num_output),
                        overflow=move(batch.overflow))


def batch_to_shard(batch: SampledBatch, x: torch.Tensor,
                   labels: torch.Tensor) -> dict:
    """A trainer's shard of a step: what ``make_disagg_train_step`` reads
    (JAX's ``pack_batch`` with ``x`` and ``labels`` beside it)."""
    return {"blocks": batch.blocks, "x": x, "labels": labels,
            "num_output": batch.num_output, "num_input": batch.num_input,
            "overflow": batch.overflow}


def _topology(dataset, config, device: torch.device, csr=None):
    """``(graph, tier, num_node)`` of a sampler on ``device``; a tier reads
    ``csr`` where given (another sampler's host CSR)."""
    weighted = config.sample_type in WEIGHTED
    src = getattr(dataset, "graph", None)
    src = dataset if src is None else src
    if config.use_dist_graph and config.dist_graph_percentage < 1.0:
        table = lambda name: getattr(src, name, None) if weighted else None
        return make_tiered_topology(
            src.indptr, src.indices, config.dist_graph_percentage,
            config.sample_type, prob_table=table("prob_table"),
            alias_table=table("alias_table"),
            prob_prefix_table=table("prob_prefix_table"), device=device,
            csr=csr)
    g = getattr(dataset, "graph", None)
    if g is None or g.indptr.device != device:
        g = Graph.from_dataset(dataset, device, weighted=weighted)
    return g, None, g.num_node


class DisaggregatedSampler:
    """The sampling service on the sampler devices.  ``topologies`` (a
    dict by device, filled here) lets a rebuilt service reuse the graphs
    built for its devices."""

    def __init__(self, dataset, config, sample_devices: Sequence,
                 capacities: Optional[Sequence[int]] = None,
                 topologies: Optional[dict] = None):
        self.devices = [torch.device(d) for d in sample_devices]
        self.topologies = {} if topologies is None else topologies
        self.samplers = []
        for dev in self.devices:
            if str(dev) not in self.topologies:
                # the samplers' tiers read one host CSR
                tiers = [t for _, t, _ in self.topologies.values()
                         if t is not None]
                self.topologies[str(dev)] = _topology(
                    dataset, config, dev, tiers[0].csr if tiers else None)
            graph, tier, num_node = self.topologies[str(dev)]
            self.samplers.append(Sampler(graph, config, capacities,
                                         tier=tier, num_node=num_node))
        self._rr = 0

    @property
    def capacities(self) -> list:
        return self.samplers[0].capacities

    def sample_to(self, seeds: np.ndarray, num_seed: int, seed: int,
                  train_device) -> SampledBatch:
        """Sample on the next sampler device, from a generator seeded with
        ``seed`` there, and ship the batch to ``train_device``."""
        idx = self._rr
        self._rr = (self._rr + 1) % len(self.samplers)
        dev = self.devices[idx]
        host = torch.from_numpy(np.ascontiguousarray(seeds))
        if dev.type == "cuda":
            host = host.pin_memory()
        batch = self.samplers[idx].sample(host.to(dev, non_blocking=True),
                                          num_seed, generator(dev, seed))
        return batch_to(batch, torch.device(train_device))

    def close(self):
        """Unmap the tiered topologies' host CSR (the first tier's; the
        others are its views)."""
        for _, tier, _ in self.topologies.values():
            if tier is not None:
                tier.csr.close()
        self.topologies.clear()


def make_disagg_train_step(models: Sequence, opts: Sequence):
    """The data-parallel step over the trainer replicas (``models[t]`` and
    ``opts[t]`` on trainer ``t``'s device, equal in state): ``step(shards,
    drop_generators) -> {"loss", "acc", "overflow"}``, device scalars on
    trainer 0's device.  Each trainer's forward and backward on its shard
    (:func:`batch_to_shard`), the seed-weighted sum of the lanes taken in
    trainer order on trainer 0's device, the reduced gradients copied to
    every trainer and the same update there, skipped on all where any
    shard overflowed.  Nothing waits on the host."""

    def step(shards: Sequence[dict], drop_generators: Sequence):
        total, grads0 = None, None
        for model, opt, shard, gen in zip(models, opts, shards,
                                          drop_generators):
            loss, acc, grads = lane_loss_and_grads(
                model, opt.params, shard["blocks"], shard["x"],
                shard["labels"], shard["num_output"], gen)
            flat = weighted_flat(grads, loss, acc, shard["num_output"],
                                 shard["overflow"])
            if total is None:
                total, grads0 = flat, grads
            else:
                total = total + flat.to(total.device, non_blocking=True)
        grads, loss, acc, skip = unflatten_weighted(total, grads0)
        for opt in opts:
            dev = opt.params[0].device
            opt.step([g.to(dev, non_blocking=True) for g in grads],
                     skip.to(dev, non_blocking=True))
        nan = torch.full_like(loss, float("nan"))
        return {"loss": torch.where(skip, nan, loss),
                "acc": torch.where(skip, nan, acc), "overflow": skip}

    return step
