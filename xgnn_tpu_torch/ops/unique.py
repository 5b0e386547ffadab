"""Seeded frontier dedup and id remap.

The port of ``xgnn_tpu/ops/unique.py``'s ``unique_seeded``.  The previous
frontier keeps local ids ``0..num_prev-1`` (the dst rows of a block are a
prefix of its src rows); new ids follow in ascending id order.  One stable
sort, a ``cummax`` forward fill and two scatters, all at static shapes with
no host sync.  The JAX package's three sorts and log-doubling fill are TPU
workarounds with the same result.  Plain PyTorch for now; a hand kernel is
ROADMAP K3.
"""

from __future__ import annotations

import torch

from .. import constants as C

EMPTY = C.EMPTY_KEY


def unique_seeded(
    ids: torch.Tensor, num_prev: torch.Tensor, prev_cap: int, out_cap: int
):
    """Dedup ``ids = concat(prev_frontier, picks)`` whose first ``prev_cap``
    entries (``num_prev`` of them valid) are already unique.

    Returns ``(unique_ids, num_unique, local_ids)``: ``unique_ids`` is
    ``(out_cap,)`` EMPTY-padded; ``num_unique`` is an int32 scalar that may
    exceed ``out_cap`` (the caller flags that as overflow); ``local_ids`` is
    ``(N,)``, the position of each id in the full unique list, EMPTY for
    EMPTY inputs.
    """
    n = ids.shape[0]
    dev = ids.device
    sid, spos = torch.sort(ids, stable=True)
    spos = spos.to(torch.int32)

    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = sid[1:] != sid[:-1]
    is_first &= sid != EMPTY
    num_unique = is_first.sum(dtype=torch.int32)

    # a run belongs to the prev frontier iff its first element came from the
    # prefix; the stable sort puts that element first, carrying its position
    is_prev_first = is_first & (spos < prev_cap)
    new_rank = torch.cumsum(is_first & ~is_prev_first, 0,
                            dtype=torch.int32) - 1
    local_first = torch.where(is_prev_first, spos, num_prev + new_rank)

    # forward fill: every element takes the local id of its run's first
    pos = torch.arange(n, device=dev)
    head = torch.cummax(torch.where(is_first, pos, 0), 0).values
    local_sorted = torch.where(is_first, local_first, 0)[head]

    local_ids = torch.empty(n, dtype=torch.int32, device=dev)
    local_ids[spos] = local_sorted
    local_ids = torch.where(ids == EMPTY, EMPTY, local_ids)

    # compact: run firsts land at their local id; the rest (and any local id
    # past out_cap) go to a spill slot that is cut off
    slot = torch.where(is_first & (local_first < out_cap), local_first, out_cap)
    unique_ids = torch.full((out_cap + 1,), EMPTY, dtype=ids.dtype, device=dev)
    unique_ids[slot] = torch.where(slot < out_cap, sid, EMPTY)
    return unique_ids[:out_cap], num_unique, local_ids
