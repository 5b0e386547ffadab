"""Hot-row cache rankings.

The port's copy of ``xgnn_tpu/store/ranking.py``: a ranking is a
hottest-first array of node ids, and ``cache_percentage`` takes its prefix.
The policies stay numpy on the host, with the JAX package's stable sorts
and generator seeds, so that the two packages give equal arrays.  A dataset
built on the device has its CSR pulled to the host for the policies that
read it.
"""

from __future__ import annotations

import numpy as np

from ..config import CachePolicy, RunConfig
from ..dataset import host_array

# the policies ranked by access frequency (presample counts)
FREQUENCY_POLICIES = (
    CachePolicy.PRE_SAMPLE,
    CachePolicy.PRE_SAMPLE_STATIC,
    CachePolicy.FAKE_OPTIMAL,
    CachePolicy.DYNAMIC,
)


def _rank_by_degree(ds) -> np.ndarray:
    """Descending out-degree, ties broken by a fixed shuffle before the
    stable sort."""
    rng = np.random.default_rng(0)
    perm = rng.permutation(ds.num_node)
    deg = ds.degrees
    order = perm[np.argsort(-deg[perm], kind="stable")]
    return order.astype(np.int32)


def _rank_by_heuristic(ds) -> np.ndarray:
    """The train set, then its 1-hop frontier (of its first 200,000 nodes),
    then the rest, each by descending degree."""
    indptr, indices = host_array(ds.indptr), host_array(ds.indices)
    train = np.asarray(ds.train_set)
    tier = np.full(ds.num_node, 2, np.int8)
    hop = np.unique(
        np.concatenate(
            [indices[indptr[v]: indptr[v + 1]]
             for v in train[: min(len(train), 200_000)]]
        )
        if len(train)
        else np.empty(0, np.int32)
    )
    tier[hop] = 1
    tier[train] = 0
    order = np.lexsort((-ds.degrees, tier))
    return order.astype(np.int32)


def _rank_by_degree_hop(ds) -> np.ndarray:
    """Degree plus the summed degrees of the neighbours (a 2-hop reach
    proxy), by exact segment sums over prefix sums."""
    deg = ds.degrees.astype(np.int64)
    if ds.num_edge == 0:
        nbr_deg = np.zeros(ds.num_node, np.int64)
    else:
        indices = host_array(ds.indices)
        csum = np.concatenate(([0], np.cumsum(deg[indices], dtype=np.int64)))
        ip = host_array(ds.indptr).astype(np.int64)
        nbr_deg = csum[ip[1:]] - csum[ip[:-1]]
    score = deg + nbr_deg
    return np.argsort(-score, kind="stable").astype(np.int32)


def _rank_random(ds) -> np.ndarray:
    rng = np.random.default_rng(1)
    return rng.permutation(ds.num_node).astype(np.int32)


def build_ranking(ds, config: RunConfig,
                  access_freq: np.ndarray | None = None) -> np.ndarray:
    """A hottest-first node-id ranking for ``config.cache_policy``.

    The frequency policies need ``access_freq`` (per-node access counts,
    from :func:`~xgnn_tpu_torch.store.presample.presample_ranking` or
    :func:`~xgnn_tpu_torch.store.presample.static_exact_ranking`).  A
    ranking shipped with the dataset (``ds.cache_rankings``) takes
    precedence for the static policies.
    """
    policy = config.cache_policy
    file_key = {
        CachePolicy.DEGREE: "degree",
        CachePolicy.HEURISTIC: "heuristic",
        CachePolicy.DEGREE_HOP: "degree_hop",
        CachePolicy.FAKE_OPTIMAL: "fake_optimal",
        CachePolicy.RANDOM: "random",
    }.get(policy)
    if file_key and file_key in ds.cache_rankings:
        return np.asarray(ds.cache_rankings[file_key])
    if policy in FREQUENCY_POLICIES:
        if access_freq is None:
            raise ValueError(f"{policy} ranking requires access frequencies")
        return np.argsort(-np.asarray(access_freq), kind="stable").astype(
            np.int32)
    if policy == CachePolicy.DEGREE:
        return _rank_by_degree(ds)
    if policy == CachePolicy.HEURISTIC:
        return _rank_by_heuristic(ds)
    if policy == CachePolicy.DEGREE_HOP:
        return _rank_by_degree_hop(ds)
    if policy == CachePolicy.RANDOM:
        return _rank_random(ds)
    raise NotImplementedError(policy)
