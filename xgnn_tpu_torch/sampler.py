"""Multi-layer mini-batch sampler.

The port of ``xgnn_tpu/sampler.py`` for every sampler: khop0, khop2 and
khop3 through K2, khop1 through K8a, the weighted samplers through K8b
(they read the graph's alias or prefix tables) and the random walk (K9):
per layer, sample a fixed fanout from the frontier, dedup into the next
frontier with the previous one as its prefix, and remap the picks to local
ids.  The walk's visit counts ride on each block as its ``weights``.  With
direct extract the last layer keeps global ids and is not deduped.  Shapes
are static, at the frontier capacities, and the overflow flag stays on the
device: sampling never waits on the host.  On a tiered topology
(:func:`make_tiered_topology`, ``tier=``) the device graph holds the hot
node-id prefix only, and each layer's one launch reads the cold rows in
place from the whole graph's CSR in mapped host memory; K3's id space is
the whole graph's node count (``num_node``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence

import numpy as np
import torch

from . import constants as C
from .config import UNIFORM_KHOP, WEIGHTED, RunConfig, SampleType
from .dataset import host_array
from .device import resolve
from .ops import random_walk, sampling, unique
from .store.topology import (
    MappedHostCSR,
    Tier,
    clamp_num_cache_node_int32,
    compute_num_cache_node,
)
from .types import Block, Graph, SampledBatch


def _align(n: int, num_node: int) -> int:
    a = C.CAPACITY_ALIGN
    return min(int(np.ceil(num_node / a)) * a, int(np.ceil(n / a)) * a)


def default_capacities(batch_size: int, fanouts: Sequence[int],
                       num_node: int) -> list:
    """Worst-case per-layer frontier capacities (``cap_{l+1} = cap_l *
    (K+1)``), clamped to the node count."""
    caps = [_align(batch_size, num_node)]
    for k in fanouts:
        caps.append(_align(caps[-1] * (k + 1), num_node))
    return caps


def _layer_fanouts(config: RunConfig) -> tuple:
    """PinSAGE samples ``num_layer_pinsage`` layers of ``num_neighbor``."""
    if config.sample_type == SampleType.RANDOM_WALK:
        return tuple([config.num_neighbor] * config.num_layer_pinsage)
    return tuple(config.fanout)


def make_tiered_topology(indptr, indices, percentage: float,
                         sample_type: SampleType, prob_table=None,
                         alias_table=None, prob_prefix_table=None,
                         device=None, csr: Optional[MappedHostCSR] = None):
    """A single-store tiered topology: the hot node-id prefix, whose edges
    are ``percentage`` of all edges, clamped so that its offsets fit int32
    (``store/topology.py``), as a :class:`Graph` on ``device`` (with its
    weighted tables for a weighted ``sample_type``, and a coarse CDF of the
    hot rows); and the whole CSR with those tables in host memory, pinned
    and mapped for ``device`` (:class:`~xgnn_tpu_torch.store.topology.
    MappedHostCSR`; ``csr``'s, read through its ``on``, where given: one
    host copy for several devices).  The arrays may be numpy arrays (a
    dataset directory's read-only memory maps among them, a uint32
    ``indptr`` from 2^31 edges on) or tensors on any device.

    Returns ``(hot_graph, tier, num_node)`` for ``Sampler(hot_graph, cfg,
    tier=tier, num_node=num_node)``: the reference's single-GPU large-graph
    mode (``evaluation/large_graph --use-dist-graph 0.85``)."""
    device = resolve(device)
    host_indptr = host_array(indptr)
    if host_indptr.dtype == np.uint32:
        # a dataset file's offsets from 2^31 edges on: int64, as the host
        # CSR holds them
        host_indptr = host_indptr.astype(np.int64)
    ncn = compute_num_cache_node(host_indptr, percentage)
    ncn = clamp_num_cache_node_int32(host_indptr, ncn, 1)
    e = int(host_indptr[ncn])
    weighted = sample_type in WEIGHTED
    tables = dict(prob_table=prob_table, alias_table=alias_table,
                  prob_prefix_table=prob_prefix_table)
    if not weighted:
        tables = {k: None for k in tables}
    host = {k: None if v is None else host_array(v)
            for k, v in dict(indices=indices, **tables).items()}
    sl = lambda a: None if a is None else a[:e]
    hot = Graph.from_dataset(
        SimpleNamespace(indptr=host_indptr[:ncn + 1].astype(np.int32),
                        **{k: sl(v) for k, v in host.items()}),
        device, weighted=weighted)
    csr = (MappedHostCSR(host_indptr, device=device, **host) if csr is None
           else csr.on(device))
    return hot, Tier(ncn, csr), len(host_indptr) - 1


class Sampler:
    """Owns the graph and one set of frontier capacities; ``grow()``
    returns a sampler with larger ones after an overflow.  ``tier``: the
    cold side of a tiered topology (:func:`make_tiered_topology`), with
    ``num_node`` the whole graph's node count, which sizes the capacities
    and K3."""

    def __init__(self, graph: Graph, config: RunConfig,
                 capacities: Optional[Sequence[int]] = None,
                 direct_extract: bool = False, tier: Optional[Tier] = None,
                 num_node: Optional[int] = None):
        st = config.sample_type
        if st in WEIGHTED:
            table = ("prob_prefix_table"
                     if st == SampleType.WEIGHTED_KHOP_PREFIX else "prob_table")
            if getattr(graph, table) is None:
                raise ValueError(
                    f"sample_type {st.value!r} reads the graph's {table}: "
                    "build it with weighted=True (Graph.from_dataset, "
                    "make_device_dataset)"
                )
        self.graph = graph
        self.config = config
        self.fanouts = _layer_fanouts(config)
        self.direct_extract = direct_extract
        self.tier = tier
        self.num_node = num_node or graph.num_node
        if capacities is None:
            capacities = config.frontier_capacities
        if capacities is None:
            capacities = default_capacities(config.batch_size, self.fanouts,
                                            self.num_node)
        self.capacities = [int(c) for c in capacities]
        if len(self.capacities) != len(self.fanouts) + 1:
            raise ValueError(
                f"{len(self.capacities)} capacities for "
                f"{len(self.fanouts)} layers"
            )

    def sample(self, seeds: torch.Tensor, num_seed,
               generator: Optional[torch.Generator] = None,
               u: Optional[Sequence[torch.Tensor]] = None) -> SampledBatch:
        """Sample one mini-batch.  ``seeds``: ``(batch_cap,)`` int32 global
        ids, EMPTY padded.  ``u``: optional uniforms, one entry per layer:
        ``(frontier_len, K)`` for the khop samplers and the prefix draw,
        ``(u, coin)`` for the alias draws (``(frontier_len, K)`` each, or
        ``HASH_DEDUP_ROUNDS * K`` wide for the hash-dedup form), ``(u_step,
        u_restart)`` for the walk (``ops/random_walk.py``); otherwise drawn
        from ``generator``."""
        cfg = self.config
        return _sample_minibatch(
            self.graph, seeds, num_seed,
            sample_type=cfg.sample_type, fanouts=self.fanouts,
            capacities=tuple(self.capacities),
            rw_params=(cfg.num_random_walk, cfg.random_walk_length,
                       cfg.random_walk_restart_prob),
            direct_extract=self.direct_extract, generator=generator, u=u,
            tier=self.tier, num_node=self.num_node,
        )

    def grow(self, factor: float = 2.0) -> "Sampler":
        caps = [self.capacities[0]] + [
            _align(int(c * factor), self.num_node)
            for c in self.capacities[1:]
        ]
        return Sampler(self.graph, self.config, caps,
                       direct_extract=self.direct_extract, tier=self.tier,
                       num_node=self.num_node)


def _device_scalar(v, dev: torch.device) -> torch.Tensor:
    """An int32 scalar on ``dev``: an int is filled in there (a copy from
    pageable host memory would wait for the stream); an int32 scalar
    already there passes through unchanged, so a step captured in a CUDA
    graph reads it from its buffer on every replay."""
    if isinstance(v, torch.Tensor):
        return v.to(device=dev, dtype=torch.int32).reshape(())
    return torch.full((), int(v), dtype=torch.int32, device=dev)


def _sample_layer(graph: Graph, frontier: torch.Tensor, fanout: int,
                  generator, u, sample_type: SampleType, rw_params: tuple,
                  tier: Optional[Tier] = None):
    """``(picks, weights)`` of one layer, in one launch for hot and cold
    rows; weights only from the walk."""
    if sample_type == SampleType.RANDOM_WALK:
        num_rw, rw_len, restart = rw_params
        return random_walk.sample_random_walk(
            graph.indptr, graph.indices, frontier, fanout, generator,
            num_random_walk=num_rw, random_walk_length=rw_len,
            restart_prob=restart, u=u, tier=tier,
        )
    if sample_type in (SampleType.WEIGHTED_KHOP,
                       SampleType.WEIGHTED_KHOP_HASH_DEDUP):
        draw = (sampling.sample_weighted_khop
                if sample_type == SampleType.WEIGHTED_KHOP
                else sampling.sample_weighted_khop_hash_dedup)
        u, coin = (None, None) if u is None else u
        return draw(graph.indptr, graph.indices, graph.prob_table,
                    graph.alias_table, frontier, fanout, generator, u=u,
                    coin=coin, tier=tier), None
    if sample_type == SampleType.WEIGHTED_KHOP_PREFIX:
        return sampling.sample_weighted_khop_prefix(
            graph.indptr, graph.indices, graph.prob_prefix_table, frontier,
            fanout, generator, max_deg=graph.n_max_deg,
            coarse_cdf=graph.coarse_cdf, u=u, tier=tier), None
    if sample_type == SampleType.KHOP1:
        draw = sampling.sample_khop1
    else:
        assert sample_type in UNIFORM_KHOP, sample_type
        draw = sampling.sample_khop0
    return draw(graph.indptr, graph.indices, frontier, fanout, generator,
                u=u, tier=tier), None


def _sample_minibatch(graph: Graph, seeds: torch.Tensor, num_seed, *,
                      sample_type: SampleType, fanouts: tuple,
                      capacities: tuple, rw_params: tuple,
                      direct_extract: bool = False,
                      generator: Optional[torch.Generator] = None,
                      u: Optional[Sequence] = None,
                      tier: Optional[Tier] = None,
                      num_node: Optional[int] = None) -> SampledBatch:
    """Innermost layer first; blocks come back outermost first.
    ``num_node`` (the graph's when not given) sizes K3."""
    dev = seeds.device
    frontier = seeds
    num_frontier = num_seed = _device_scalar(num_seed, dev)
    blocks = []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for layer, fanout in enumerate(fanouts):
        last = layer == len(fanouts) - 1
        nbr, weights = _sample_layer(
            graph, frontier, fanout, generator,
            None if u is None else u[layer], sample_type, rw_params, tier,
        )
        if direct_extract and last:
            blocks.append(Block(
                neigh=nbr,  # GLOBAL ids into the feature table
                num_dst=num_frontier,
                num_src=_device_scalar(graph.num_node, dev),
                dst_ids=frontier,
                weights=weights,
            ))
            break
        out_cap = capacities[layer + 1]
        uids, num_unique, local = unique.unique_seeded_split(
            frontier, nbr.reshape(-1), num_frontier, out_cap,
            num_node=num_node or graph.num_node,
        )
        blocks.append(Block(
            neigh=local.reshape(nbr.shape),
            num_dst=num_frontier,
            num_src=num_unique,
            weights=weights,
        ))
        overflow = overflow | (num_unique > out_cap)
        frontier = uids
        num_frontier = torch.clamp(num_unique, max=out_cap)

    blocks.reverse()
    return SampledBatch(
        blocks=tuple(blocks),
        input_nodes=frontier,
        num_input=num_frontier,
        output_nodes=seeds,
        num_output=num_seed,
        overflow=overflow,
    )
