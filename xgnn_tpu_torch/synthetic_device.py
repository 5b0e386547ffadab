"""Synthetic power-law graphs built on the device.

The port of ``xgnn_tpu/synthetic_device.py``'s ``make_device_dataset``:
power-law endpoint draws (``_gen_edges``), symmetrised, then a CSR with
multi-edges and self-loops removed (``dedup=True``, the default:
``_build_csr``, one sort of the int64 keys ``src * N + dst``) or with
multi-edges kept (``dedup=False``: ``_build_csr_fast``, one sort by
source).  The random streams are PyTorch's, so the graph is not bit-equal
to the JAX package's for a seed; it is drawn from the same distribution.
The JAX package pads the arrays to its TPU tile; the port keeps them
trimmed.  With ``weighted=True`` the graph also carries random edge
weights as row-local prefix sums, their coarse CDF and the largest degree
(``_prefix_table`` and ``build_coarse_cdf`` there).  :func:`alias_tables`
builds alias tables for the same weights on the device, which the JAX
package builds only on the host.  The host test graphs, bit-equal to the
JAX package's, are ``synthetic.make_synthetic_dataset``'s.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import constants as C
from .dataset import Dataset
from .device import generator, resolve, seed_of
from .ops.sampling import build_coarse_cdf
from .types import Graph


def _gen_edges(num_node: int, num_edge: int, alpha: float, gen, device):
    """Power-law endpoint draws: ``rank = N * u^(1/(1-alpha))`` mapped
    through an independent random permutation for each endpoint."""
    exp = 1.0 / (1.0 - alpha)

    def draw():
        u = torch.rand(num_edge, generator=gen, device=device)
        u = u * (1.0 - 1e-7) + 1e-7  # uniform on [1e-7, 1), as the JAX draw
        ranks = (num_node * u.pow_(exp)).to(torch.int32)
        del u
        ranks.clamp_(max=num_node - 1)
        perm = torch.randperm(
            num_node, generator=gen, device=device, dtype=torch.int32
        )
        return perm[ranks]

    src = draw()
    dst = draw()
    return src, dst


def _build_csr_fast(src: torch.Tensor, dst: torch.Tensor, num_node: int):
    """COO to CSR without multi-edge dedup: one sort by source.  Self-loops
    get a sentinel source that sorts last and is cut off."""
    src = torch.where(src == dst, C.EMPTY_KEY, src)
    s, order = torch.sort(src)
    del src
    num_valid = int(torch.count_nonzero(s != C.EMPTY_KEY))
    s = s[:num_valid]
    indices = dst[order[:num_valid]]
    del order
    counts = torch.bincount(s, minlength=num_node)
    indptr = torch.zeros(num_node + 1, dtype=torch.int32, device=s.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, indices


def _build_csr(src: torch.Tensor, dst: torch.Tensor, num_node: int):
    """COO to CSR with multi-edges and self-loops removed: the sorted
    distinct int64 keys ``src * num_node + dst`` of the edges that are not
    loops.  The JAX package sorts the int32 pairs with ``lexsort`` (a TPU
    runs without 64-bit types); one sort of the key gives the same CSR:
    each row's neighbours ascending and distinct."""
    keep = src != dst
    key = torch.unique(src[keep].to(torch.int64) * num_node
                       + dst[keep].to(torch.int64))
    del keep
    rows = torch.div(key, num_node, rounding_mode="floor")
    indices = (key - rows * num_node).to(torch.int32)
    del key
    counts = torch.bincount(rows, minlength=num_node)
    del rows
    indptr = torch.zeros(num_node + 1, dtype=torch.int32,
                         device=indices.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, indices


def edge_weights(num_edge: int, seed: int, device) -> torch.Tensor:
    """The edge weights of the weighted dataset of ``seed``: float32
    U[0.1, 1.0), one per edge, from a generator of their own,
    ``seed_of(seed, 7)`` (the JAX package's ``fold_in(key, 7)``), so the
    graph, features and split stay those of the unweighted dataset."""
    device = torch.device(device)
    gen = generator(device, seed_of(seed, 7))
    return torch.rand(num_edge, generator=gen, device=device) * 0.9 + 0.1


def _row_sums(values: torch.Tensor, rows: torch.Tensor, num_rows: int):
    """Inclusive and exclusive running sums of float64 ``values`` within
    each run of equal ``rows`` (nondecreasing ids): a global running sum
    minus each row's base, so that a row's exclusive sum at ``i + 1``
    equals its inclusive sum at ``i`` exactly."""
    inc = torch.cumsum(values, 0)
    exc = torch.zeros_like(inc)
    exc[1:] = inc[:-1]
    counts = torch.bincount(rows, minlength=num_rows)
    first = torch.clamp(torch.cumsum(counts, 0) - counts, max=max(
        inc.shape[0] - 1, 0))
    base = exc[first][rows] if inc.numel() else exc
    return inc - base, exc - base


def alias_tables(indptr: torch.Tensor, indices: torch.Tensor,
                 weights: torch.Tensor):
    """``(prob_table, alias_table)`` for ``weights`` (positive, one per
    edge): per row, an alias table of the row's weights, edge-aligned, with
    alias entries as global destination ids, as ``synthetic.
    build_alias_tables`` lays them out.  Built in parallel on the tensors'
    device, with no loop over rows or edges: the sweep of Walker's method
    (a light slot, ``q = w * deg / sum < 1``, borrows from a heavy one)
    becomes two merges of running sums (Hübschle-Schneider and Sanders,
    "Parallel Weighted Random Sampling", 2019).  Within a row the lights
    and the heavies each keep CSR order; light ``i`` borrows from the first
    heavy whose running excess reaches the lights' running deficit before
    ``i``, and a heavy, once its excess is spent, keeps ``1 + excess -
    deficit`` of its slot and borrows the rest from the next heavy.  The
    tables differ from the host build's but give each edge the same
    probability, in float64 sums rounded to float32.  A one-time set-up
    step, with several float64 and int64 temporaries an edge."""
    num_node = indptr.shape[0] - 1
    dev = indices.device
    if not indices.numel():
        return (torch.zeros(0, dtype=torch.float32, device=dev),
                indices.clone())
    deg = (indptr[1:] - indptr[:-1]).to(torch.int64)
    rows = torch.repeat_interleave(torch.arange(num_node, device=dev), deg,
                                   output_size=indices.shape[0])
    w = weights.to(torch.float64)
    inc, _ = _row_sums(w, rows, num_node)
    total = inc[torch.clamp(indptr[1:].to(torch.int64) - 1, min=0)]
    q = w * deg[rows] / total[rows]  # the row's mean slot is 1
    del w, inc, total
    # every row holds a heavy slot (q >= 1) but where rounding leaves all
    # its q below 1; the slots of such a row keep themselves
    heavy = q >= 1.0
    light_e = torch.nonzero(~heavy).squeeze(1)
    heavy_e = torch.nonzero(heavy).squeeze(1)
    del heavy
    if not (light_e.numel() and heavy_e.numel()):  # every q is 1
        return (torch.ones(indices.shape[0], dtype=torch.float32,
                           device=dev), indices.clone())
    lr, hr = rows[light_e], rows[heavy_e]
    del rows
    deficit_in, deficit_ex = _row_sums(1.0 - q[light_e], lr, num_node)
    excess_in, _ = _row_sums(q[heavy_e] - 1.0, hr, num_node)
    # the running sums of every row in one ascending key: row id plus the
    # sum scaled into [0, 1)
    scale = 1.0 / (deg.to(torch.float64) + 1.0)
    heavy_key = hr + excess_in * scale[hr]
    n_heavy = torch.bincount(hr, minlength=num_node)
    n_light = torch.bincount(lr, minlength=num_node)
    heavy0 = torch.cumsum(n_heavy, 0) - n_heavy
    light0 = torch.cumsum(n_light, 0) - n_light

    prob = torch.ones_like(q)
    alias_e = torch.arange(indices.shape[0], device=dev)  # its own slot
    # light i: the heavies of its row whose excess ends below the deficit
    # before i are spent; it borrows from the next one
    j = torch.searchsorted(heavy_key, lr + deficit_ex * scale[lr])
    has = n_heavy[lr] > 0
    j = torch.minimum(torch.maximum(j, heavy0[lr]),
                      heavy0[lr] + n_heavy[lr] - 1)
    prob[light_e] = torch.where(has, q[light_e], 1.0)
    j = torch.clamp(j, 0, heavy_e.shape[0] - 1)
    alias_e[light_e] = torch.where(has, heavy_e[j], light_e)
    del j, has, deficit_ex
    # heavy k: spent at the first light whose deficit passes its excess;
    # the last heavy of a row, or one never spent, keeps its whole slot
    i = torch.searchsorted(lr + deficit_in * scale[lr], heavy_key,
                           right=True)
    k = torch.arange(heavy_e.shape[0], device=dev)
    spent = (i < light0[hr] + n_light[hr]) & (k < heavy0[hr] + n_heavy[hr]
                                              - 1)
    rest = 1.0 + excess_in - deficit_in[torch.clamp(
        i, max=light_e.shape[0] - 1)]
    prob[heavy_e] = torch.where(spent, torch.clamp(rest, 0.0, 1.0), 1.0)
    nxt = heavy_e[torch.clamp(k + 1, max=heavy_e.shape[0] - 1)]
    alias_e[heavy_e] = torch.where(spent, nxt, heavy_e)
    return prob.to(torch.float32), indices[alias_e]


def prefix_table(indptr: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Row-local inclusive prefix sums of ``weights`` (one per edge), as
    float32: a float64 running sum minus each row's base, rounded.  With
    positive weights every row is nondecreasing, which the prefix sampler
    relies on.  A one-time set-up step."""
    num_node = indptr.shape[0] - 1
    rows = torch.repeat_interleave(
        torch.arange(num_node, device=weights.device),
        indptr[1:] - indptr[:-1], output_size=weights.shape[0])
    return _row_sums(weights.to(torch.float64), rows,
                     num_node)[0].to(torch.float32)


def make_device_dataset(
    num_node: int,
    num_edge: int,
    feat_dim: int,
    num_class: int,
    train_frac: float = 0.08,
    seed: int = 0,
    alpha: float = 0.45,
    name: str = "synthetic_device",
    symmetric: bool = True,
    device: Optional[str] = None,
    weighted: bool = False,
    dedup: bool = True,
) -> Dataset:
    """Build a power-law graph with ``num_edge`` endpoint draws (twice as
    many when ``symmetric``; with ``dedup`` the distinct ones that are not
    loops, else every one that is not a loop), normal features, uniform
    labels and a random train/valid/test split.  ``dedup`` draws nothing,
    so the features, labels and split are the same either way.  Topology,
    features and labels stay on ``device``; the node sets come to the
    host.  ``weighted`` adds edge
    weights U[0.1, 1.0), drawn from a generator of their own (the same
    graph, features and split as unweighted), as the prefix table and its
    coarse CDF: what ``weighted_khop_prefix`` samples from."""
    device = resolve(device)
    gen = generator(device, seed)
    src, dst = _gen_edges(num_node, num_edge, alpha, gen, device)
    if symmetric:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    indptr, indices = (_build_csr if dedup else _build_csr_fast)(
        src, dst, num_node)
    del src, dst
    graph = Graph(indptr=indptr, indices=indices)

    feat = torch.randn(
        (num_node, feat_dim), generator=gen, device=device, dtype=torch.float32
    )
    label = torch.randint(
        0, num_class, (num_node,), generator=gen, device=device,
        dtype=torch.int32,
    )
    n_train = max(1, int(num_node * train_frac))
    n_val = max(1, int(num_node * 0.02))
    perm = torch.randperm(num_node, generator=gen, device=device,
                          dtype=torch.int32)
    sets = perm[: n_train + 2 * n_val].cpu().numpy()
    graph.n_max_deg = int((indptr[1:] - indptr[:-1]).max()) if num_node else 0
    if weighted:
        w = edge_weights(graph.num_edge, seed, device)
        graph.prob_prefix_table = prefix_table(indptr, w)
        del w
        graph.coarse_cdf = build_coarse_cdf(indptr, graph.prob_prefix_table,
                                            num_node)
    return Dataset(
        name=name,
        num_node=num_node,
        num_edge=graph.num_edge,
        feat_dim=feat_dim,
        num_class=num_class,
        indptr=indptr,
        indices=indices,
        feat=feat,
        label=label,
        train_set=sets[:n_train],
        valid_set=sets[n_train: n_train + n_val],
        test_set=sets[n_train + n_val:],
        prob_prefix_table=graph.prob_prefix_table,
        graph=graph,
    )
