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

EMPTY = C.EMPTY_KEY


@dataclasses.dataclass
class Graph:
    """CSR topology on the device."""

    indptr: torch.Tensor  # (num_node + 1,) int32
    indices: torch.Tensor  # (num_edge,) int32

    @property
    def num_node(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edge(self) -> int:
        return self.indices.shape[0]

    @classmethod
    def from_dataset(cls, ds, device) -> "Graph":
        iptr = np.asarray(ds.indptr)
        if len(iptr) and int(iptr[-1]) >= 2**31:
            # edge offsets are int32, as on the JAX package's single store
            raise ValueError(
                f"graph has {int(iptr[-1])} edges (>= 2^31): a single-store "
                "int32 CSR cannot address them"
            )
        to = lambda a: torch.as_tensor(
            np.asarray(a).astype(np.int32, copy=False)
        ).to(device)
        return cls(indptr=to(iptr), indices=to(ds.indices))


@dataclasses.dataclass
class Block:
    """One sampled layer.

    ``neigh[i, k]`` is the local index (into the layer's src frontier) of the
    k-th sampled neighbour of dst row ``i``; ``EMPTY_KEY`` marks padding.  On
    a direct-extract block ``neigh`` holds GLOBAL ids into the feature table
    and ``dst_ids`` the dst rows' global ids.
    """

    neigh: torch.Tensor  # (dst_cap, fanout) int32
    num_dst: torch.Tensor  # scalar int32
    num_src: torch.Tensor  # scalar int32
    dst_ids: Optional[torch.Tensor] = None  # (dst_cap,) int32 global ids

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
