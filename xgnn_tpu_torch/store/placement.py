"""Store placement planning: how much of the device memory the topology and
the feature cache each get.

The port's copy of ``xgnn_tpu/parallel/placement.py`` (lines 36-244, the
reference's ``PartitionSolver`` analog, ``cuda/dist_graph.cu:684-777``):
given the device memory, the group size and the degree skew, decide whether
the topology is fully resident or tiered (``use_dist_graph`` and
``dist_graph_percentage``) and how much of the rest the feature cache gets
(``cache_percentage``), greedily by marginal accesses a byte.  The single
store's ``Engine`` solves it with ``group_size=1``.  ``device_hbm_bytes``
reads the card's total memory (``torch.cuda.get_device_properties``); on
the CPU it is None, so the caller must give ``hbm_budget_gb``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class StorePlan:
    """Solved per-chip HBM allocation for the GGMS stores."""

    use_dist_graph: bool
    dist_graph_percentage: float  # fraction of EDGES device-resident
    cache_percentage: float  # fraction of NODES' features cached
    topology_bytes: int  # per-chip topology spend
    cache_bytes: int  # per-chip feature-cache spend
    expected_topo_hit: float  # fraction of neighbor draws served on-device
    expected_feat_hit: float  # fraction of feature reads served on-device
    notes: str = ""


def _norm_cdf(weights: np.ndarray) -> np.ndarray:
    """CDF over a DESCENDING hot-first ranking of per-item access weights."""
    w = np.sort(np.asarray(weights, np.float64))[::-1]
    tot = w.sum()
    if tot <= 0:
        return np.linspace(0.0, 1.0, len(w) + 1)[1:]
    return np.cumsum(w) / tot


def solve_placement(
    num_node: int,
    num_edge: int,
    feat_dim: int,
    *,
    hbm_bytes: int,
    group_size: int = 1,
    feat_bytes: int = 4,
    weighted: bool = False,
    node_freq: Optional[np.ndarray] = None,
    degrees: Optional[np.ndarray] = None,
    reserve_fraction: float = 0.35,
    buckets: int = 128,
) -> StorePlan:
    """Greedy marginal-value fill of the per-chip HBM budget.

    Args:
      hbm_bytes: per-chip HBM capacity.
      group_size: chips in the ICI partition group (stores shard over it;
        DCN groups replicate, so they don't enter the capacity math).
      weighted: weighted sampling doubles+ topology bytes (prob/alias or
        prefix tables are edge-aligned f32/i32; coarse CDF is 128f32/node).
      node_freq: per-node access counts (presample ranking) for the feature
        CDF; falls back to ``degrees``, then to uniform.
      degrees: per-node out-degree — orders the edge (topology) CDF, since
        the hot edge prefix is ranked by the same node ranking
        (dist_engine.cc:224-235: prefix sized by edge mass).
      reserve_fraction: HBM held back for model/optimizer/activations/
        sampler frontier buffers (calibration owns the exact number later;
        planning only needs a safe envelope).

    The solver discretizes each store's hot-first access CDF into
    ``buckets`` prefix steps and repeatedly gives the next HBM slice to the
    store with the higher marginal accesses-per-byte.  Topology draws and
    feature reads are weighted equally: every sampled edge endpoint costs
    one topology touch and (post-dedup) roughly one feature row read at the
    last layer — the reference's presample statistic counts exactly those.
    """
    budget = int(hbm_bytes * (1.0 - reserve_fraction))
    # per-chip bytes for FULL residency, sharded over the ICI group
    row = feat_dim * feat_bytes
    feat_total = num_node * row
    topo_unit = 4 * (2 if weighted else 1)  # indices (+ one edge table)
    topo_total = num_edge * topo_unit + (num_node + 1) * 4
    if weighted:
        topo_total += num_node * 128 * 4  # coarse CDF tile per node
    topo_full = -(-topo_total // group_size)
    feat_full = -(-feat_total // group_size)

    # hot-first access CDFs
    if node_freq is not None and np.asarray(node_freq).sum() > 0:
        order_w = np.asarray(node_freq, np.float64)
    elif degrees is not None:
        order_w = np.asarray(degrees, np.float64)
    else:
        order_w = np.ones(num_node)
    feat_cdf = _norm_cdf(order_w)
    if degrees is not None:
        # edge mass of the hot node prefix, in the same ranking
        d = np.asarray(degrees, np.float64)
        rank = np.argsort(-order_w, kind="stable")
        edge_mass = np.cumsum(d[rank])
        edge_cdf = edge_mass / max(edge_mass[-1], 1.0)
    else:
        edge_cdf = np.linspace(0.0, 1.0, num_node + 1)[1:]

    def bucketize(cdf):
        idx = np.linspace(0, len(cdf) - 1, buckets + 1).astype(np.int64)
        pts = np.concatenate([[0.0], cdf[idx[1:]]])
        return np.diff(pts)  # marginal access mass per prefix step

    feat_gain = bucketize(feat_cdf)
    topo_gain = bucketize(edge_cdf)
    feat_step = feat_full / buckets
    topo_step = topo_full / buckets

    spend_f = spend_t = 0
    i_f = i_t = 0
    remaining = budget
    while remaining > 0 and (i_f < buckets or i_t < buckets):
        mf = feat_gain[i_f] / feat_step if i_f < buckets else -1.0
        mt = topo_gain[i_t] / topo_step if i_t < buckets else -1.0
        if mt >= mf:
            if topo_step > remaining:
                break
            spend_t += topo_step
            remaining -= topo_step
            i_t += 1
        else:
            if feat_step > remaining:
                break
            spend_f += feat_step
            remaining -= feat_step
            i_f += 1

    topo_pct = i_t / buckets
    cache_pct = i_f / buckets
    plan = StorePlan(
        use_dist_graph=(group_size > 1) or (topo_pct < 1.0),
        dist_graph_percentage=round(topo_pct, 4),
        cache_percentage=round(cache_pct, 4),
        topology_bytes=int(spend_t),
        cache_bytes=int(spend_f),
        expected_topo_hit=float(edge_cdf[min(
            int(topo_pct * (len(edge_cdf) - 1)), len(edge_cdf) - 1)])
        if topo_pct > 0 else 0.0,
        expected_feat_hit=float(feat_cdf[min(
            int(cache_pct * (len(feat_cdf) - 1)), len(feat_cdf) - 1)])
        if cache_pct > 0 else 0.0,
        notes=(
            f"budget={budget>>20}MiB/chip group={group_size} "
            f"topo_full={topo_full>>20}MiB feat_full={feat_full>>20}MiB"
        ),
    )
    return plan


def device_hbm_bytes(device=None) -> Optional[int]:
    """The card's memory in bytes; None on the CPU, whose callers must give
    ``hbm_budget_gb``."""
    import torch

    device = torch.device(device) if device is not None else None
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return int(torch.cuda.get_device_properties(index).total_memory)


def resolve_auto_placement(config, ds, *, group_size: int = 1, device=None):
    """Fill ``dist_graph_percentage`` / ``cache_percentage`` /
    ``use_dist_graph`` from the solved plan (``RunConfig.auto_placement``).

    Explicit user values win: only fields left at their defaults are
    replaced.  Returns ``(config, StorePlan)``.
    """
    from ..config import WEIGHTED, RunConfig
    from ..dataset import host_array

    hbm = (
        int(config.hbm_budget_gb * (1 << 30))
        if config.hbm_budget_gb
        else device_hbm_bytes(device)
    )
    if hbm is None:
        raise ValueError(
            "auto_placement: the device reports no memory size (the "
            "CPU); set hbm_budget_gb"
        )
    deg = np.diff(host_array(ds.indptr).astype(np.int64))
    weighted = config.sample_type in WEIGHTED
    plan = solve_placement(
        ds.num_node,
        ds.num_edge,
        ds.feat.shape[1],
        hbm_bytes=hbm,
        group_size=group_size,
        feat_bytes=2 if config.feat_dtype == "bfloat16" else 4,
        weighted=weighted,
        degrees=deg,
    )
    defaults = RunConfig.__dataclass_fields__
    updates = {}
    if config.dist_graph_percentage == defaults[
        "dist_graph_percentage"
    ].default:
        updates["dist_graph_percentage"] = max(
            plan.dist_graph_percentage, 0.01
        )
    if config.cache_percentage == defaults["cache_percentage"].default:
        # never emit exactly 0: the engines read cache_percentage == 0 as
        # "no cache knob" => FULL HBM residency, the opposite of a starved
        # budget; a floor of one bucket keeps the store tiered
        updates["cache_percentage"] = (
            plan.cache_percentage
            if plan.cache_percentage >= 1.0
            else max(plan.cache_percentage, 1.0 / 128)
        )
    if not config.use_dist_graph and plan.use_dist_graph:
        updates["use_dist_graph"] = True
    return dataclasses.replace(config, **updates), plan
