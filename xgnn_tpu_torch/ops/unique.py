"""K3: seeded frontier dedup and id remap.

The port of ``xgnn_tpu/ops/unique.py``'s ``unique_seeded``.  The previous
frontier keeps local ids ``0..num_prev-1`` (the dst rows of a block are a
prefix of its src rows); new ids follow in ascending id order.  Static
shapes, no host sync.

The CUDA kernel is ``csrc/unique.cu``: a direct-address table over the node
ids, so it needs ``num_node``.  :func:`unique_seeded_plain` is its plain
PyTorch version (one stable sort, a ``cummax`` forward fill and two
scatters; the JAX package's three sorts and log-doubling fill are TPU
workarounds with the same result): the wrapper takes it only for tensors
on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as C
from . import _build

EMPTY = C.EMPTY_KEY
_NAME = "unique_seeded"
_SEGMENT = 1024  # node ids per scan segment (kSeg in csrc/unique.cu)


def unique_seeded_plain(
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


def _check(ids, num_prev, prev_cap, out_cap, num_node):
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(
            f"unique_seeded: ids must be 1-D int32, got {ids.dtype} "
            f"{tuple(ids.shape)}"
        )
    if not ids.is_contiguous():
        raise ValueError("unique_seeded: ids must be contiguous")
    if not isinstance(num_prev, torch.Tensor) or (
        num_prev.dtype != torch.int32 or num_prev.numel() != 1
        or num_prev.device != ids.device
    ):
        raise ValueError(
            f"unique_seeded: num_prev must be a tensor of one int32 on "
            f"{ids.device}"
        )
    if not 0 <= prev_cap <= ids.shape[0] or out_cap < 0:
        raise ValueError(
            f"unique_seeded: prev_cap {prev_cap} and out_cap {out_cap} for "
            f"{ids.shape[0]} ids"
        )
    if num_node is not None and not 0 <= num_node <= EMPTY:
        raise ValueError(f"unique_seeded: num_node {num_node} out of range")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unique_seeded: no kernel for {ids.device}")


def unique_seeded(
    ids: torch.Tensor,
    num_prev: torch.Tensor,
    prev_cap: int,
    out_cap: int,
    *,
    num_node: Optional[int] = None,
):
    """:func:`unique_seeded_plain`'s contract.  ``num_node``: the ids lie in
    ``[0, num_node)`` or are EMPTY; the kernel needs it (the size of its
    table) and treats any other id as EMPTY.  The plain version ignores it.
    """
    _check(ids, num_prev, prev_cap, out_cap, num_node)
    if ids.device.type == "cpu":
        return unique_seeded_plain(ids, num_prev, prev_cap, out_cap)
    if num_node is None:
        raise ValueError("unique_seeded: the CUDA kernel needs num_node")
    dev = ids.device
    n = ids.shape[0]
    num_seg = -(-num_node // _SEGMENT)
    # per call, from the caching allocator on the current stream: the
    # producer thread samples on its own stream
    scratch = torch.empty(num_node + 2 * num_seg, dtype=torch.int32,
                          device=dev)
    unique_ids = torch.empty(out_cap, dtype=torch.int32, device=dev)
    num_unique = torch.empty((), dtype=torch.int32, device=dev)
    local_ids = torch.empty(n, dtype=torch.int32, device=dev)
    lib = _build.load("unique")
    rc = lib.xg_unique_seeded(
        ids.data_ptr(), n, prev_cap, num_prev.data_ptr(), num_node, out_cap,
        scratch.data_ptr(), scratch.numel(), unique_ids.data_ptr(),
        num_unique.data_ptr(), local_ids.data_ptr(),
        _build.stream_handle(dev),
    )
    _build.check(rc, _NAME)
    _build.LAUNCHES.add(_NAME)
    return unique_ids, num_unique, local_ids
