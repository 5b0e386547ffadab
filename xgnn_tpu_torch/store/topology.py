"""The tiered topology: the hot CSR prefix on the device, every other row
read in place from the whole graph's CSR in pinned, mapped host memory.

The port's copy of ``xgnn_tpu/parallel/ggms.py``'s
``compute_num_cache_node``, ``clamp_num_cache_node_int32`` and
``INT32_EDGE_LIMIT`` (lines 76-131), and of the host CSR that its
``HostColdSampler`` (:264-453) draws from.  The hot node-id prefix
``[0, num_cache_node)`` is sized so that its edges are
``dist_graph_percentage`` of all edges (the reference's
``dist_engine.cc:224-235``), and clamped so that its offsets fit int32.

JAX serves the other rows through a host callback over the compacted cold
ids of each layer, because a TPU program cannot read host memory
(``ggms.py:22-33``).  The GPU reference reads the host partition in place
(UVA, ``dist_graph.h:141-151``), and so does the port: K2, K8a, K8b and K9
read a cold row's indptr pair, its picks and the weighted tables from
:class:`MappedHostCSR`, in the same launch as the hot rows
(``ops/sampling.py``, ``ops/random_walk.py``), or, on the partitioned
topology, in the requesting rank's own launch (the samplers' cold form,
``parallel/dist_topology.py``).  There is no compaction, no ``cold_cap``
and no cold overflow.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..ops.tiered import MappedHostTensor

INT32_EDGE_LIMIT = 2**31 - 1  # the device CSR's offsets are int32


def compute_num_cache_node(indptr: np.ndarray, percentage: float) -> int:
    """The hot node-id prefix whose edges are ``percentage`` of all edges
    (reference ``dist_engine.cc:224-235``)."""
    num_node = len(indptr) - 1
    if percentage >= 1.0:
        return num_node
    num_cache_edge = int(int(indptr[-1]) * percentage)
    return int(min(np.searchsorted(indptr, num_cache_edge, side="left"),
                   num_node))


def clamp_num_cache_node_int32(indptr: np.ndarray, num_cache_node: int,
                               num_parts: int = 1) -> int:
    """The largest prefix ``<= num_cache_node`` whose per-part edge share
    (rows ``p, p + num_parts, ...`` of part ``p``) fits int32 offsets; the
    host CSR, with int64 offsets, serves the rest."""
    num_cache_node = int(num_cache_node)
    if int(indptr[num_cache_node]) <= INT32_EDGE_LIMIT:
        return num_cache_node
    deg = (indptr[1:num_cache_node + 1].astype(np.int64)
           - indptr[:num_cache_node].astype(np.int64))
    cums = [np.cumsum(deg[p::num_parts]) for p in range(num_parts)]

    def fits(ncn: int) -> bool:
        for p in range(num_parts):
            # the rows p, p + P, ... below ncn
            k = max(0, -(-(ncn - p) // num_parts))
            if k > 0 and int(cums[p][k - 1]) > INT32_EDGE_LIMIT:
                return False
        return True

    lo, hi = 0, num_cache_node
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


class MappedHostCSR:
    """The whole graph's CSR in host memory, each array a
    :class:`~xgnn_tpu_torch.ops.tiered.MappedHostTensor`: ``indptr`` as
    int64, ``indices`` as int32, and the weighted samplers' tables that are
    given (``prob_table`` float32, ``alias_table`` int32,
    ``prob_prefix_table`` float32).  On a CUDA ``device`` each is copied,
    pinned and mapped, and any failure raises; on the CPU they are plain
    tensors, sharing the caller's memory where no conversion copies it (a
    memory-mapped file of 2^31 edges or more stays on disk).  With
    ``mesh`` (a multi-card engine's) each array is the host's one copy,
    shared by the host's ranks on the CPU and on the card alike
    (``store/host_shared.py``), on the mesh's device."""

    TABLES = {"indices": torch.int32, "prob_table": torch.float32,
              "alias_table": torch.int32,
              "prob_prefix_table": torch.float32}

    def __init__(self, indptr, indices, prob_table=None, alias_table=None,
                 prob_prefix_table=None,
                 device: Union[str, torch.device] = "cpu", mesh=None):
        given = dict(indices=indices, prob_table=prob_table,
                     alias_table=alias_table,
                     prob_prefix_table=prob_prefix_table)
        self.arrays = {}
        try:
            self.arrays["indptr"] = MappedHostTensor(
                indptr, device, torch.int64, "MappedHostCSR indptr", True,
                mesh)
            for name, dtype in self.TABLES.items():
                if given[name] is not None:
                    self.arrays[name] = MappedHostTensor(
                        given[name], device, dtype, f"MappedHostCSR {name}",
                        True, mesh)
        except Exception:
            self.close()
            raise
        self.device = self.arrays["indptr"].device
        num_edge = int(self.arrays["indptr"].tensor[-1])
        for name, arr in self.arrays.items():
            if name != "indptr" and arr.tensor.shape != (num_edge,):
                self.close()
                raise ValueError(f"MappedHostCSR: {name} has shape "
                                 f"{tuple(arr.tensor.shape)}, the CSR "
                                 f"{num_edge} edges")

    @property
    def num_node(self) -> int:
        return self.arrays["indptr"].tensor.shape[0] - 1

    @property
    def num_edge(self) -> int:
        return self.arrays["indices"].tensor.shape[0]

    def host(self, name: str) -> Optional[torch.Tensor]:
        """The array ``name`` on the host, or None where it was not
        given."""
        arr = self.arrays.get(name)
        return None if arr is None else arr.tensor

    def dev_ptr(self, name: str) -> Optional[int]:
        """The device address of the mapped array ``name`` (None on the
        CPU, for an empty array, or where it was not given)."""
        arr = self.arrays.get(name)
        return None if arr is None else arr.dev_ptr

    def on(self, device) -> "MappedHostCSR":
        """These arrays as ``device`` reads them (each array's ``on``): a
        view that shares the memory and its registration; closing this
        object releases them, closing the view does nothing."""
        device = torch.device(device)
        if device == self.device or device.type != "cuda":
            return self
        view = copy.copy(self)
        view.arrays = {k: a.on(device) for k, a in self.arrays.items()}
        view.device = device
        return view

    def close(self):
        for arr in self.arrays.values():
            arr.close()


class Tier(NamedTuple):
    """A tiered topology's cold side, as the samplers take it (``tier=``):
    the hot prefix ``[0, num_cache_node)`` is the device graph's (or, on
    the partitioned topology, spread over the ranks' parts); the rows
    ``[num_cache_node, csr.num_node)`` are read from ``csr``."""

    num_cache_node: int
    csr: MappedHostCSR
