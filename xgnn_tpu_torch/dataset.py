"""Dataset container (the fields of ``xgnn_tpu/dataset.py``'s ``Dataset``).

The arrays may be numpy arrays on the host or tensors; the engine moves
them to its device.  A dataset built on the device carries its CSR as a
ready :class:`~xgnn_tpu_torch.types.Graph` in ``graph``.  The binary-format
file loader is not ported yet (ROADMAP queue 1, 'Dataset files and
host test graphs').
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


def host_array(a) -> np.ndarray:
    """A numpy array of ``a``, pulled from the device if it is a tensor."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class Dataset:
    name: str
    num_node: int
    num_edge: int
    feat_dim: int
    num_class: int
    indptr: Any  # (num_node + 1,) int32/int64
    indices: Any  # (num_edge,) int32
    feat: Any  # (num_node, feat_dim) float32
    label: Any  # (num_node,) integer
    train_set: np.ndarray  # (num_train,) int32 node ids
    valid_set: np.ndarray
    test_set: np.ndarray
    prob_table: Optional[np.ndarray] = None
    alias_table: Optional[np.ndarray] = None
    prob_prefix_table: Optional[np.ndarray] = None
    in_degrees: Optional[np.ndarray] = None
    out_degrees: Optional[np.ndarray] = None
    cache_rankings: dict = dataclasses.field(default_factory=dict)
    graph: Any = None  # a device-resident types.Graph, when built on device

    @property
    def degrees(self) -> np.ndarray:
        """Out-degrees from the CSR (sampling fans out along indptr rows),
        on the host."""
        if self.out_degrees is not None:
            return np.asarray(self.out_degrees)
        indptr = host_array(self.indptr)
        return np.diff(indptr)

    @classmethod
    def from_arrays(cls, other) -> "Dataset":
        """Copy the fields of any object that has them (for example a
        dataset of the JAX package, whose arrays are numpy)."""
        names = [f.name for f in dataclasses.fields(cls) if f.name != "graph"]
        return cls(**{n: getattr(other, n) for n in names if hasattr(other, n)})
