"""Uniform neighbour sampling without replacement (khop0, khop2, khop3).

The port of ``xgnn_tpu/ops/sampling.py``'s ``_frontier_meta`` and
``sample_khop0``.  The reference's khop0, khop2 and khop3 all draw a uniform
K-subset of the neighbours (all of them when ``deg <= K``), so the three
share one partial Fisher-Yates.  Each call maps a padded frontier ``(B,)``
to a neighbour matrix ``(B, K)`` with ``EMPTY_KEY`` padding, with static
shapes and no host sync.

Given the same uniforms ``u`` the picks equal the JAX package's exactly:
the draw ``t = j + min(floor(u[:, j] * span), span - 1)`` is computed in
float32 as there.  Plain PyTorch for now; a hand kernel is ROADMAP K2.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as C

EMPTY = C.EMPTY_KEY


def _frontier_meta(indptr: torch.Tensor, frontier: torch.Tensor):
    """Per-node CSR slice ``(start, deg)``; EMPTY entries get degree 0."""
    valid = frontier != EMPTY
    node = torch.where(valid, frontier, 0)
    start = indptr[node]
    deg = torch.where(valid, indptr[node + 1] - start, 0)
    return node, start, deg, valid


def sample_khop0(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Partial Fisher-Yates over the virtual array ``A = [0..deg)``: at step
    ``j`` draw ``t`` in ``[j, deg)``, emit ``A[t]`` and set ``A[t] = A[j]``.
    Only displaced entries are recorded, at most ``K`` of them, so each pick
    is resolved by a scan over the records.

    ``u``: ``(B, fanout)`` float32 uniforms; drawn from ``generator`` when
    not given.
    """
    b = frontier.shape[0]
    _, start, deg, _ = _frontier_meta(indptr, frontier)
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)

    rec_pos = []  # displaced positions, one per step
    rec_val = []  # the value stored at that position
    picks = []

    def lookup(x):
        v = x
        for p, w in zip(rec_pos, rec_val):
            v = torch.where(x == p, w, v)
        return v

    for j in range(fanout):
        span = torch.clamp(deg - j, min=1)
        # float32 u times int32 span stays float32, as in the JAX kernel
        t = j + torch.minimum(torch.floor(u[:, j] * span).to(torch.int32),
                              span - 1)
        pick = lookup(t)
        a_j = lookup(torch.full_like(t, j))
        rec_pos.append(t)
        rec_val.append(a_j)
        picks.append(pick)

    off = torch.stack(picks, dim=1)
    live = torch.arange(fanout, device=frontier.device)[None, :] < deg[:, None]
    # rows past their degree read edge 0 (a valid address), then mask
    pos = torch.where(live, start[:, None] + off, 0)
    return torch.where(live, indices[pos], EMPTY)


sample_khop2 = sample_khop0
sample_khop3 = sample_khop0
