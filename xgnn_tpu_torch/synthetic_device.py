"""Synthetic power-law graphs built on the device.

The port of ``xgnn_tpu/synthetic_device.py``'s ``make_device_dataset`` with
``dedup=False`` (``_gen_edges`` and ``_build_csr_fast``): power-law endpoint
draws, one sort by source, then a bincount and cumsum for ``indptr``.
Multi-edges are kept and self-loops dropped.  The random streams are
PyTorch's, so the graph is not bit-equal to the JAX package's for a seed;
it is drawn from the same distribution.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import constants as C
from .dataset import Dataset
from .device import generator, resolve
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
) -> Dataset:
    """Build a power-law graph with ``num_edge`` endpoint draws (twice as
    many edges when ``symmetric``), normal features, uniform labels and a
    random train/valid/test split.  Topology, features and labels stay on
    ``device``; the node sets come to the host."""
    device = resolve(device)
    gen = generator(device, seed)
    src, dst = _gen_edges(num_node, num_edge, alpha, gen, device)
    if symmetric:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    indptr, indices = _build_csr_fast(src, dst, num_node)
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
        graph=graph,
    )
