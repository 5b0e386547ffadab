"""Host test graphs and weighted-sampling tables, built with numpy.

The port's copy of ``xgnn_tpu/synthetic.py``: ``make_synthetic_dataset``
(uniform, power-law or RMAT endpoint draws, an optional planted label
signal, symmetrised and deduplicated), ``plant_hop2_task`` (labels that
only aggregation can recover) and ``build_alias_tables``.  Every draw comes
from ``np.random.default_rng(seed)`` in the JAX package's order, so for a
seed each array equals the JAX package's bit for bit.  These are the
command lines' ``--synthetic`` graphs and the tests' datasets; a graph at
products scale is built faster on the device (``synthetic_device``).
"""

from __future__ import annotations

import numpy as np

from .dataset import Dataset


def _coo_to_csr(src, dst, num_node):
    """COO to CSR with multi-edges removed (a simple graph, as converted
    datasets are): one ``np.unique`` of the int64 keys ``src * N + dst``."""
    eid = np.unique(src.astype(np.int64) * num_node + dst.astype(np.int64))
    src, dst = eid // num_node, eid % num_node
    indptr = np.zeros(num_node + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr.astype(np.int32), dst.astype(np.int32)


def rmat_edges(
    num_node: int,
    num_edge: int,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    chunk: int = 1 << 24,
) -> tuple[np.ndarray, np.ndarray]:
    """RMAT endpoint draws (a power-law degree distribution), ``chunk``
    edges at a time; self-loops dropped."""
    rng = np.random.default_rng(seed)
    scale = int(np.ceil(np.log2(max(num_node, 2))))
    srcs, dsts = [], []
    remaining = num_edge
    while remaining > 0:
        n = min(chunk, remaining)
        src = np.zeros(n, dtype=np.int64)
        dst = np.zeros(n, dtype=np.int64)
        for _ in range(scale):
            r = rng.random(n)
            src <<= 1
            dst <<= 1
            # quadrant probabilities: a (0,0), b (0,1), c (1,0), d (1,1)
            go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
            go_down = r >= a + b
            dst |= go_right.astype(np.int64)
            src |= go_down.astype(np.int64)
        src %= num_node
        dst %= num_node
        keep = src != dst
        srcs.append(src[keep])
        dsts.append(dst[keep])
        remaining -= n
    return np.concatenate(srcs), np.concatenate(dsts)


def powerlaw_edges(
    num_node: int,
    num_edge: int,
    seed: int = 0,
    alpha: float = 0.45,
) -> tuple[np.ndarray, np.ndarray]:
    """Heavy-tailed endpoint draws by the inverse CDF: ranks with
    ``P(rank = i) ~ (i + 1)^-alpha`` as ``rank = N * u^(1 / (1 - alpha))``,
    mapped through independent random permutations for the sources and the
    destinations, so that hubs are uncorrelated; self-loops dropped."""
    rng = np.random.default_rng(seed)
    exp = 1.0 / (1.0 - alpha)

    def draw(n, perm):
        u = rng.random(n)
        ranks = np.minimum(
            (num_node * np.power(u, exp)).astype(np.int64), num_node - 1
        )
        return perm[ranks]

    perm_s = rng.permutation(num_node).astype(np.int64)
    perm_d = rng.permutation(num_node).astype(np.int64)
    src = draw(num_edge, perm_s)
    dst = draw(num_edge, perm_d)
    keep = src != dst
    return src[keep], dst[keep]


def make_synthetic_dataset(
    num_node: int = 10_000,
    avg_degree: int = 10,
    feat_dim: int = 64,
    num_class: int = 16,
    train_frac: float = 0.1,
    seed: int = 0,
    power_law: bool = True,
    with_feat: bool = True,
    planted_signal: float = 0.0,
    name: str = "synthetic",
) -> Dataset:
    """A synthetic dataset of ``num_node * avg_degree`` endpoint draws
    (``power_law``: True for :func:`powerlaw_edges`, ``"rmat"`` for
    :func:`rmat_edges`, False for uniform draws), symmetrised and
    deduplicated, with normal features, uniform labels and a random split
    (``train_frac``, then 5% valid and 5% test).  With ``planted_signal >
    0``, 80% of the edges are rewired within a class and the features carry
    the class centroid times ``planted_signal``, so a GNN learns."""
    rng = np.random.default_rng(seed)
    num_edge = num_node * avg_degree
    label = rng.integers(0, num_class, num_node).astype(np.int64)
    if power_law == "rmat":
        src, dst = rmat_edges(num_node, num_edge, seed=seed)
    elif power_law:
        src, dst = powerlaw_edges(num_node, num_edge, seed=seed)
    else:
        src = rng.integers(0, num_node, num_edge)
        dst = rng.integers(0, num_node, num_edge)
        keep = src != dst
        src, dst = src[keep], dst[keep]
    if planted_signal > 0:
        # homophily: rewire most edges within the same class so neighbor
        # aggregation carries label signal (GCN has no self path)
        order = np.argsort(label, kind="stable")
        class_start = np.searchsorted(label[order], np.arange(num_class))
        class_count = np.bincount(label, minlength=num_class)
        rewire = rng.random(len(src)) < 0.8
        cls = label[src[rewire]]
        pick = class_start[cls] + rng.integers(
            0, 1 << 62, rewire.sum()) % np.maximum(class_count[cls], 1)
        dst = dst.copy()
        dst[rewire] = order[pick]
        keep = src != dst
        src, dst = src[keep], dst[keep]
    # symmetrize so sampling in either direction sees edges
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    indptr, indices = _coo_to_csr(src, dst, num_node)
    num_edge = len(indices)
    feat = None
    if with_feat:
        feat = rng.standard_normal((num_node, feat_dim), dtype=np.float32)
        if planted_signal > 0:
            # class centroids added to the features: a learnable signal
            centroids = rng.standard_normal((num_class, feat_dim),
                                            dtype=np.float32)
            feat += planted_signal * centroids[label]

    perm = rng.permutation(num_node).astype(np.int32)
    n_train = max(1, int(num_node * train_frac))
    n_valid = max(1, int(num_node * 0.05))
    ds = Dataset(
        name=name,
        num_node=num_node,
        num_edge=num_edge,
        feat_dim=feat_dim,
        num_class=num_class,
        indptr=indptr,
        indices=indices,
        feat=feat,
        label=label,
        train_set=perm[:n_train],
        valid_set=perm[n_train : n_train + n_valid],
        test_set=perm[n_train + n_valid : n_train + 2 * n_valid],
    )
    ds.validate()
    return ds


def plant_hop2_task(
    ds: Dataset,
    label_noise: float = 0.15,
    token_alpha: float = 0.55,
    feat_noise: float = 1.0,
    seed: int = 0,
) -> Dataset:
    """Re-label ``ds`` with a task that only aggregation solves.

    The dataset's labels become hidden communities (build it with
    ``planted_signal > 0``, so that most edges stay within one).  Each node
    gets a token, its community with probability ``1 - token_alpha`` and a
    uniform class otherwise; its label is the token most often reached by
    2-hop walks from it, flipped to a uniform class with probability
    ``label_noise``; its features are its own token one-hot (3.0) plus
    normal noise.  A feature-only MLP sees one noisy vote (about 45% at the
    defaults), a working 2-3-layer GNN many, up to the label noise's
    ceiling (about 86%).  Mutates and returns ``ds``."""
    rng = np.random.default_rng(seed)
    n = ds.num_node
    C_ = int(ds.num_class)
    g = np.asarray(ds.label).astype(np.int64)
    t = np.where(
        rng.random(n) < token_alpha, rng.integers(0, C_, n), g
    ).astype(np.int64)
    indptr64 = np.asarray(ds.indptr).astype(np.int64)
    deg = np.diff(indptr64)
    row = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = np.asarray(ds.indices).astype(np.int64)
    counts1 = np.zeros((n, C_), np.float64)
    for c in range(C_):
        counts1[:, c] = np.bincount(row, weights=(t[dst] == c), minlength=n)
    counts2 = np.zeros((n, C_), np.float64)
    for c in range(C_):
        counts2[:, c] = np.bincount(
            row, weights=counts1[dst, c], minlength=n
        )
    # deterministic tiebreak, then label noise
    label = np.argmax(counts2 + rng.random((n, C_)) * 1e-6, axis=1)
    flip = rng.random(n) < label_noise
    label[flip] = rng.integers(0, C_, int(flip.sum()))
    ds.label = label.astype(np.int64)
    feat = rng.standard_normal((n, ds.feat_dim), dtype=np.float32) * feat_noise
    feat[np.arange(n), t % ds.feat_dim] += 3.0
    ds.feat = feat
    return ds


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
