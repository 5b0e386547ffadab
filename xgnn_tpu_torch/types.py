"""Core types: device-resident graph, sampled blocks, batches.

The port of ``xgnn_tpu/types.py`` as dataclasses of tensors.  A sampled
layer is a dense fixed-fanout neighbour matrix ``(dst_cap, fanout)`` with
``EMPTY_KEY`` padding, as in the JAX package.  The arrays carry no tile
padding: that is a TPU layout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import constants as C
from .device import to_tensor

EMPTY = C.EMPTY_KEY


@dataclasses.dataclass
class Graph:
    """CSR topology on the device, with the weighted samplers' tables."""

    indptr: torch.Tensor  # (num_node + 1,) int32
    indices: torch.Tensor  # (num_edge,) int32
    prob_table: Optional[torch.Tensor] = None  # (num_edge,) f32, alias method
    alias_table: Optional[torch.Tensor] = None  # (num_edge,) int32 global ids
    # (num_edge,) f32 row-local inclusive prefix sums of the edge weights
    prob_prefix_table: Optional[torch.Tensor] = None
    # (num_node, 128) f32 per-row CDF quantiles (ops/sampling.build_coarse_cdf)
    coarse_cdf: Optional[torch.Tensor] = None
    # the largest out-degree: sizes the plain prefix search
    n_max_deg: Optional[int] = None

    @property
    def num_node(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edge(self) -> int:
        return self.indices.shape[0]

    @classmethod
    def from_dataset(cls, ds, device, weighted: bool = False) -> "Graph":
        """The dataset's CSR on ``device``; with ``weighted``, also the
        tables it has, and the coarse CDF of its prefix table.  The arrays
        may be read-only memory maps of a dataset directory."""
        iptr = np.asarray(ds.indptr)
        if len(iptr) and int(iptr[-1]) >= 2**31:
            # edge offsets are int32, as on the JAX package's single store
            raise ValueError(
                f"graph has {int(iptr[-1])} edges (>= 2^31): a single-store "
                "int32 CSR cannot address them"
            )

        def to(a, dtype=torch.int32):
            return None if a is None else to_tensor(a, device, dtype)

        g = cls(indptr=to(iptr), indices=to(ds.indices),
                n_max_deg=int(np.max(np.diff(iptr))) if len(iptr) > 1
                else None)
        if weighted:
            g.prob_table = to(ds.prob_table, torch.float32)
            g.alias_table = to(ds.alias_table)
            g.prob_prefix_table = to(ds.prob_prefix_table, torch.float32)
            if g.prob_prefix_table is not None:
                from .ops.sampling import build_coarse_cdf

                g.coarse_cdf = build_coarse_cdf(g.indptr, g.prob_prefix_table,
                                                g.num_node)
        return g


@dataclasses.dataclass
class Block:
    """One sampled layer.

    ``neigh[i, k]`` is the local index (into the layer's src frontier) of the
    k-th sampled neighbour of dst row ``i``; ``EMPTY_KEY`` marks padding.  On
    a direct-extract block ``neigh`` holds GLOBAL ids into the feature table
    and ``dst_ids`` the dst rows' global ids.  ``weights`` are per-pick edge
    weights (the random walk's visit counts, PinSAGE), 0 on padding.
    """

    neigh: torch.Tensor  # (dst_cap, fanout) int32
    num_dst: torch.Tensor  # scalar int32
    num_src: torch.Tensor  # scalar int32
    dst_ids: Optional[torch.Tensor] = None  # (dst_cap,) int32 global ids
    weights: Optional[torch.Tensor] = None  # (dst_cap, fanout) float32

    @property
    def dst_cap(self) -> int:
        return self.neigh.shape[0]

    @property
    def fanout(self) -> int:
        return self.neigh.shape[1]

    @property
    def mask(self) -> torch.Tensor:
        return self.neigh != EMPTY


@dataclasses.dataclass
class SampledBatch:
    """One mini-batch; ``blocks`` are ordered outermost first (DGL order)."""

    blocks: Sequence[Block]
    input_nodes: torch.Tensor  # (input_cap,) int32 global ids, EMPTY padded
    num_input: torch.Tensor  # scalar int32
    output_nodes: torch.Tensor  # (batch_cap,) int32 seed ids
    num_output: torch.Tensor  # scalar int32
    # True if a layer's unique frontier exceeded its static capacity
    overflow: torch.Tensor  # scalar bool
