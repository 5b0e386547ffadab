"""Dataset container and the binary dataset directory (the port of
``xgnn_tpu/dataset.py``).

A directory holds ``meta.txt`` (``KEY VALUE`` lines), a uint32 CSR
(``indptr.bin``, ``indices.bin``), ``feat.bin`` in the meta's
``FEAT_DATA_TYPE``, int64 ``label.bin``, uint32 node sets and the optional
tables of ``xgnn-convert`` (weighted sampling, degrees, cache rankings):
the reference's layout, which both packages read and write alike.
:func:`load_dataset` maps the files read-only, with the JAX package's views
and dtypes; the engine moves what it needs to its device.  A dataset built
on the device carries its CSR as a ready
:class:`~xgnn_tpu_torch.types.Graph` in ``graph``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np

from . import constants as C

_FEAT_DTYPES = {"F32": np.float32, "F16": np.float16}
# the static cache rankings' files, by policy
RANKING_FILES = {
    "degree": C.CACHE_BY_DEGREE_FILE,
    "heuristic": C.CACHE_BY_HEURISTIC_FILE,
    "degree_hop": C.CACHE_BY_DEGREE_HOP_FILE,
    "fake_optimal": C.CACHE_BY_FAKE_OPTIMAL_FILE,
    "random": C.CACHE_BY_RANDOM_FILE,
}


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
    indptr: Any  # (num_node + 1,) int32, or uint32 from 2^31 edges on
    indices: Any  # (num_edge,) int32
    feat: Any  # (num_node, feat_dim) float32 (float16 from an F16 file)
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

    def validate(self):
        assert self.indptr.shape == (self.num_node + 1,)
        assert self.indptr[0] == 0 and self.indptr[-1] == self.num_edge
        assert self.indices.shape == (self.num_edge,)
        if self.feat is not None:
            assert self.feat.shape == (self.num_node, self.feat_dim)

    @classmethod
    def from_arrays(cls, other) -> "Dataset":
        """Copy the fields of any object that has them (for example a
        dataset of the JAX package, whose arrays are numpy)."""
        names = [f.name for f in dataclasses.fields(cls) if f.name != "graph"]
        return cls(**{n: getattr(other, n) for n in names if hasattr(other, n)})


def _read_meta(path: str) -> dict:
    meta = {C.META_FEAT_DATA_TYPE: "F32"}
    with open(os.path.join(path, C.META_FILE)) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            key, value = parts
            meta[key] = value if key == C.META_FEAT_DATA_TYPE else int(value)
    for key in (C.META_NUM_NODE, C.META_NUM_EDGE, C.META_FEAT_DIM,
                C.META_NUM_CLASS, C.META_NUM_TRAIN_SET,
                C.META_NUM_VALID_SET, C.META_NUM_TEST_SET):
        if key not in meta:
            raise ValueError(f"meta.txt missing {key}")
    return meta


def _mmap(path: str, dtype, shape) -> np.ndarray:
    return np.memmap(path, dtype=dtype, mode="r", shape=shape)


def _maybe_mmap(path: str, dtype, shape) -> Optional[np.ndarray]:
    return _mmap(path, dtype, shape) if os.path.isfile(path) else None


def _maybe_int32(path: str, n: int) -> Optional[np.ndarray]:
    """A uint32 file's int32 view, or None where there is no file."""
    a = _maybe_mmap(path, np.uint32, (n,))
    return None if a is None else a.view(np.int32)


def load_dataset(path: str, name: Optional[str] = None,
                 load_feat: bool = True,
                 fake_feat_dim: Optional[int] = None) -> Dataset:
    """Load a dataset directory, every array a read-only memory map.

    ``indptr`` is an int32 view below 2^31 edges and stays uint32 from
    2^31 on (the offsets then need 64-bit arithmetic; only the tiered
    topology's host CSR takes them, as int64); ``indices``, the node sets,
    the alias table, the degrees and the rankings are int32 views; ``label``
    is int64 and ``feat`` of the meta's ``FEAT_DATA_TYPE``.
    ``fake_feat_dim`` draws normal features of that width instead of
    reading them, from ``np.random.default_rng(0)`` as the JAX package
    draws them (the reference's ``SAMGRAPH_FAKE_FEAT_DIM``)."""
    meta = _read_meta(path)
    num_node = meta[C.META_NUM_NODE]
    num_edge = meta[C.META_NUM_EDGE]
    feat_dim = meta[C.META_FEAT_DIM]
    j = os.path.join
    if num_node + 1 >= 2**31:
        raise ValueError(
            f"num_node {num_node} exceeds the uint32-id design point")
    if num_edge >= 2**32:
        raise ValueError(
            f"num_edge {num_edge} exceeds the uint32 offset space "
            "(the reference binary format caps at 2^32 edges)")
    indptr = _mmap(j(path, C.INDPTR_FILE), np.uint32, (num_node + 1,))
    if num_edge < 2**31:
        indptr = indptr.view(np.int32)
    # catches a truncated or corrupt indptr file and a 32-bit misreading of
    # big offsets (reads two pages of the map)
    if int(indptr[0]) != 0 or int(indptr[-1]) != num_edge:
        raise ValueError(
            f"indptr.bin inconsistent with meta.txt: indptr[0]="
            f"{int(indptr[0])}, indptr[-1]={int(indptr[-1])}, "
            f"NUM_EDGE={num_edge}")
    indices = _mmap(j(path, C.INDICES_FILE), np.uint32,
                    (num_edge,)).view(np.int32)

    feat = None
    if fake_feat_dim:
        feat_dim = fake_feat_dim
        rng = np.random.default_rng(0)
        feat = rng.standard_normal((num_node, feat_dim), dtype=np.float32)
    elif load_feat:
        feat = _maybe_mmap(j(path, C.FEAT_FILE),
                           _FEAT_DTYPES[meta[C.META_FEAT_DATA_TYPE]],
                           (num_node, feat_dim))

    def node_set(fname, n):
        return np.asarray(_mmap(j(path, fname), np.uint32, (n,)).view(
            np.int32))

    ds = Dataset(
        name=name or os.path.basename(os.path.normpath(path)),
        num_node=num_node,
        num_edge=num_edge,
        feat_dim=feat_dim,
        num_class=meta[C.META_NUM_CLASS],
        indptr=indptr,
        indices=indices,
        feat=feat,
        label=_maybe_mmap(j(path, C.LABEL_FILE), np.int64, (num_node,)),
        train_set=node_set(C.TRAIN_SET_FILE, meta[C.META_NUM_TRAIN_SET]),
        valid_set=node_set(C.VALID_SET_FILE, meta[C.META_NUM_VALID_SET]),
        test_set=node_set(C.TEST_SET_FILE, meta[C.META_NUM_TEST_SET]),
        prob_table=_maybe_mmap(j(path, C.PROB_TABLE_FILE), np.float32,
                               (num_edge,)),
        alias_table=_maybe_int32(j(path, C.ALIAS_TABLE_FILE), num_edge),
        prob_prefix_table=_maybe_mmap(j(path, C.PROB_PREFIX_TABLE_FILE),
                                      np.float32, (num_edge,)),
        in_degrees=_maybe_int32(j(path, C.IN_DEGREE_FILE), num_node),
        out_degrees=_maybe_int32(j(path, C.OUT_DEGREE_FILE), num_node),
    )
    for policy, fname in RANKING_FILES.items():
        ranking = _maybe_int32(j(path, fname), num_node)
        if ranking is not None:
            ds.cache_rankings[policy] = ranking
    return ds


def save_dataset(ds: Dataset, path: str):
    """Write a dataset directory, the files that the JAX package's
    ``save_dataset`` writes, byte for byte: the features as F32, the
    optional tables and rankings that ``ds`` has.  Tensors are pulled from
    their device first."""
    os.makedirs(path, exist_ok=True)
    j = os.path.join
    if ds.num_edge >= 2**32:
        raise ValueError(
            f"num_edge {ds.num_edge} does not fit the uint32 offset space")

    def write(fname, arr, dtype):
        np.ascontiguousarray(host_array(arr), dtype=dtype).tofile(
            j(path, fname))

    write(C.INDPTR_FILE, ds.indptr, np.uint32)
    write(C.INDICES_FILE, ds.indices, np.uint32)
    if ds.feat is not None:
        write(C.FEAT_FILE, ds.feat, np.float32)
    if ds.label is not None:
        write(C.LABEL_FILE, ds.label, np.int64)
    write(C.TRAIN_SET_FILE, ds.train_set, np.uint32)
    write(C.VALID_SET_FILE, ds.valid_set, np.uint32)
    write(C.TEST_SET_FILE, ds.test_set, np.uint32)
    for fname, arr, dtype in (
            (C.PROB_TABLE_FILE, ds.prob_table, np.float32),
            (C.ALIAS_TABLE_FILE, ds.alias_table, np.uint32),
            (C.PROB_PREFIX_TABLE_FILE, ds.prob_prefix_table, np.float32)):
        if arr is not None:
            write(fname, arr, dtype)
    for policy, ranking in ds.cache_rankings.items():
        write(RANKING_FILES[policy], ranking, np.uint32)
    with open(j(path, C.META_FILE), "w") as f:
        f.write(f"{C.META_NUM_NODE} {ds.num_node}\n")
        f.write(f"{C.META_NUM_EDGE} {ds.num_edge}\n")
        f.write(f"{C.META_FEAT_DIM} {ds.feat_dim}\n")
        f.write(f"{C.META_FEAT_DATA_TYPE} F32\n")
        f.write(f"{C.META_NUM_CLASS} {ds.num_class}\n")
        f.write(f"{C.META_NUM_TRAIN_SET} {len(ds.train_set)}\n")
        f.write(f"{C.META_NUM_VALID_SET} {len(ds.valid_set)}\n")
        f.write(f"{C.META_NUM_TEST_SET} {len(ds.test_set)}\n")
