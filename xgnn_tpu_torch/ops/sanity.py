"""Batch sanity checks (opt-in, ``sanity_check``).

The port of ``xgnn_tpu/ops/sanity.py``: that a sampled batch holds its
invariants.  The unique frontier has no duplicate and no EMPTY in its valid
prefix, and its padding is EMPTY; every pick of a valid dst row addresses a
valid src entry, and the rows past ``num_dst`` hold only EMPTY.  Plain
torch ops return a violation bitmask as a device int32 scalar (0 = clean),
so nothing waits on the device unless the caller pulls it; the engine does
so only when ``sanity_check`` is on, and raises with :func:`explain`'s
names.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..types import SampledBatch

EMPTY = C.EMPTY_KEY

VIOLATION_NAMES = (
    "input_duplicate",
    "input_empty_leak",
    "input_pad_dirty",
    "neigh_out_of_range",
    "neigh_pad_dirty",
)


def _bit(cond: torch.Tensor, i: int) -> torch.Tensor:
    return cond.to(torch.int32) << i


def check_batch(batch: SampledBatch) -> torch.Tensor:
    """An int32 bitmask of violations on the batch's device, bit ``i`` for
    ``VIOLATION_NAMES[i]``."""
    ids = batch.input_nodes
    dev = ids.device
    valid = torch.arange(ids.shape[0], device=dev) < batch.num_input
    # duplicates within the valid prefix (sort-adjacent check)
    s = torch.sort(torch.where(valid, ids, EMPTY)).values
    dup = ((s[1:] == s[:-1]) & (s[1:] != EMPTY)).any()
    flags = _bit(dup, 0)
    flags = flags | _bit((valid & (ids == EMPTY)).any(), 1)
    flags = flags | _bit((~valid & (ids != EMPTY)).any(), 2)
    for blk in batch.blocks:
        in_dst = (torch.arange(blk.dst_cap, device=dev) < blk.num_dst)[:, None]
        neigh = blk.neigh
        bad_range = (in_dst & (neigh != EMPTY)
                     & ((neigh < 0) | (neigh >= blk.num_src))).any()
        flags = flags | _bit(bad_range, 3)
        flags = flags | _bit((~in_dst & (neigh != EMPTY)).any(), 4)
    return flags


def explain(flags: int) -> list:
    return [name for i, name in enumerate(VIOLATION_NAMES) if flags & (1 << i)]
