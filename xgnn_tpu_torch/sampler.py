"""Multi-layer mini-batch sampler.

The port of ``xgnn_tpu/sampler.py`` for the uniform khop samplers: per
layer, sample a fixed fanout from the frontier, dedup into the next
frontier with the previous one as its prefix, and remap the picks to local
ids.  With direct extract the last layer keeps global ids and is not
deduped.  Shapes are static, at the frontier capacities, and the overflow
flag stays on the device: sampling never waits on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import constants as C
from .config import UNIFORM_KHOP, RunConfig
from .ops import sampling, unique
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


class Sampler:
    """Owns the graph and one set of frontier capacities; ``grow()``
    returns a sampler with larger ones after an overflow."""

    def __init__(self, graph: Graph, config: RunConfig,
                 capacities: Optional[Sequence[int]] = None,
                 direct_extract: bool = False):
        if config.sample_type not in UNIFORM_KHOP:
            raise NotImplementedError(
                f"sample_type {config.sample_type.value!r}: ROADMAP open "
                "item 10 (other samplers)"
            )
        self.graph = graph
        self.config = config
        self.fanouts = tuple(config.fanout)
        self.direct_extract = direct_extract
        self.num_node = graph.num_node
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
        ids, EMPTY padded.  ``u``: optional per-layer uniforms
        ``(frontier_len, K)``; otherwise drawn from ``generator``."""
        return _sample_minibatch(
            self.graph, seeds, num_seed,
            fanouts=self.fanouts, capacities=tuple(self.capacities),
            direct_extract=self.direct_extract, generator=generator, u=u,
        )

    def grow(self, factor: float = 2.0) -> "Sampler":
        caps = [self.capacities[0]] + [
            _align(int(c * factor), self.num_node)
            for c in self.capacities[1:]
        ]
        return Sampler(self.graph, self.config, caps,
                       direct_extract=self.direct_extract)


def _device_scalar(v: int, dev: torch.device) -> torch.Tensor:
    """An int32 scalar filled in on ``dev``: a copy from pageable host
    memory would wait for the stream."""
    return torch.full((), int(v), dtype=torch.int32, device=dev)


def _sample_minibatch(graph: Graph, seeds: torch.Tensor, num_seed, *,
                      fanouts: tuple, capacities: tuple,
                      direct_extract: bool = False,
                      generator: Optional[torch.Generator] = None,
                      u: Optional[Sequence[torch.Tensor]] = None
                      ) -> SampledBatch:
    """Innermost layer first; blocks come back outermost first."""
    dev = seeds.device
    frontier = seeds
    num_frontier = num_seed = _device_scalar(num_seed, dev)
    blocks = []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for layer, fanout in enumerate(fanouts):
        last = layer == len(fanouts) - 1
        nbr = sampling.sample_khop0(
            graph.indptr, graph.indices, frontier, fanout, generator,
            u=None if u is None else u[layer],
        )
        if direct_extract and last:
            blocks.append(Block(
                neigh=nbr,  # GLOBAL ids into the feature table
                num_dst=num_frontier,
                num_src=_device_scalar(graph.num_node, dev),
                dst_ids=frontier,
            ))
            break
        out_cap = capacities[layer + 1]
        uids, num_unique, local = unique.unique_seeded_split(
            frontier, nbr.reshape(-1), num_frontier, out_cap,
            num_node=graph.num_node,
        )
        blocks.append(Block(
            neigh=local.reshape(nbr.shape),
            num_dst=num_frontier,
            num_src=num_unique,
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
