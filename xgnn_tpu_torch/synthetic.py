"""Weighted-sampling tables built on the host.

The port's copy of ``build_alias_tables`` from ``xgnn_tpu/synthetic.py``:
numpy, with ``np.random.default_rng(seed)`` and the same stack order, so
its tables equal the JAX package's bit for bit for a seed.  The host test
graphs of that module are not ported yet (ROADMAP queue 1, 'Dataset files
and host test graphs').
"""

from __future__ import annotations

import numpy as np


def build_alias_tables(ds, seed: int = 0) -> None:
    """Attach ``prob_table``, ``alias_table`` and ``prob_prefix_table`` to
    ``ds`` for random edge weights U[0.1, 1.1): per row, Walker's alias
    method over the row's weights, edge-aligned, and the row-local
    inclusive prefix sums (float64 sums rounded to float32).  Alias entries
    are global destination ids, so a sampler uses them as picks directly.
    A Python loop over the rows, for test-sized graphs; files from
    ``xgnn-convert create-weights`` serve large ones."""
    rng = np.random.default_rng(seed)
    weights = rng.random(ds.num_edge).astype(np.float32) + 0.1
    prob = np.zeros(ds.num_edge, dtype=np.float32)
    alias = np.zeros(ds.num_edge, dtype=np.int32)
    prefix = np.zeros(ds.num_edge, dtype=np.float32)
    indptr = np.asarray(ds.indptr)  # host arrays, or CPU tensors
    indices = np.asarray(ds.indices)
    for v in range(ds.num_node):
        s, e = int(indptr[v]), int(indptr[v + 1])
        d = e - s
        if d == 0:
            continue
        w = weights[s:e].astype(np.float64)
        prefix[s:e] = np.cumsum(w)
        p = w * d / w.sum()
        small = [i for i in range(d) if p[i] < 1.0]
        large = [i for i in range(d) if p[i] >= 1.0]
        pr = p.copy()
        al = np.asarray(indices[s:e], dtype=np.int64).copy()  # its own id
        while small and large:
            sm, lg = small.pop(), large.pop()
            al[sm] = indices[s + lg]
            pr[lg] = pr[lg] - (1.0 - pr[sm])
            (small if pr[lg] < 1.0 else large).append(lg)
        # leftovers take their own slot with certainty
        for i in small + large:
            pr[i] = 1.0
        prob[s:e] = pr.clip(0.0, 1.0)
        alias[s:e] = al
    ds.prob_table = prob
    ds.alias_table = alias
    ds.prob_prefix_table = prefix
