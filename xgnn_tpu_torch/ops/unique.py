"""K3: seeded frontier dedup and id remap.

The port of ``xgnn_tpu/ops/unique.py``'s ``unique_seeded``.  The previous
frontier keeps local ids ``0..num_prev-1`` (the dst rows of a block are a
prefix of its src rows); new ids follow in ascending id order.  Static
shapes, no host sync.

The CUDA kernel is ``csrc/unique.cu``: a direct-address table over the node
ids and a bitmap of the ids present, so it needs ``num_node``.  Its table
and bitmaps are state kept across calls, one per (device, stream,
``num_node``), made at first use (:func:`state`); a call allocates only its
outputs and makes three launches.  The state's generation stamp lives on
the card and the kernel advances it, so a call captured in a CUDA graph
stays right on every replay; make the state before the capture, on the
stream that captures (a state made during a capture would put its fill
into the graph).  :func:`unique_seeded_split` takes the
prefix and the picks as two tensors, as the sampler holds them, and returns
the picks' local ids only.  :func:`unique_seeded_plain` is the kernel's
plain PyTorch version (one stable sort, a ``cummax`` forward fill and two
scatters; the JAX package's three sorts and log-doubling fill are TPU
workarounds with the same result): the wrappers take it only for tensors
on the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .. import constants as C
from . import _build

EMPTY = C.EMPTY_KEY
_NAME = "unique_seeded"
_TILE_WORDS = 256  # bitmap words per scan tile (kTileWords in csrc/unique.cu)
_MAX_GEN = 2**32 - 1  # the last generation before the stamp wraps


def compact_mask_positions(mask: torch.Tensor, out_cap: int) -> torch.Tensor:
    """The positions of ``mask``'s True elements in their order, then ``n``
    (the mask's length) as padding, ``min(out_cap, n)`` of them, int32:
    JAX's ``compact_mask_positions`` (``xgnn_tpu/ops/unique.py:27``, K10).
    A rank by cumulative sum and one scatter (JAX sorts, a TPU workaround
    for scatters); no host sync.  Its CUDA form is the tiered store's split
    (``csrc/tiered.cu``), which compacts the miss positions so."""
    n = mask.shape[0]
    cap = min(out_cap, n)
    rank = torch.cumsum(mask, 0) - 1
    slot = torch.where(mask & (rank < cap), rank, cap)
    pos = torch.full((cap + 1,), n, dtype=torch.int32, device=mask.device)
    pos.scatter_(0, slot, torch.arange(n, dtype=torch.int32,
                                       device=mask.device))
    return pos[:cap]


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


def unique_seeded_split_plain(prefix: torch.Tensor, picks: torch.Tensor,
                              num_prev: torch.Tensor, out_cap: int):
    """:func:`unique_seeded_plain` of ``concat(prefix, picks)``, with the
    local ids of the picks only."""
    uids, num_unique, local = unique_seeded_plain(
        torch.cat([prefix, picks]), num_prev, prefix.shape[0], out_cap)
    return uids, num_unique, local[prefix.shape[0]:]


def unique_ordered(ids: torch.Tensor, out_cap: int):
    """Dedup ``ids`` (int32, EMPTY-padded anywhere) keeping the order of
    first occurrence: JAX's ``unique_ordered`` (``xgnn_tpu/ops/unique.py:46``,
    K10; the reference's ``OrderedHashTable::FillWithDuplicates``).

    Returns ``(unique_ids, num_unique, local_ids)``: ``unique_ids`` is
    ``(out_cap,)`` in first-occurrence order, EMPTY-padded; ``num_unique``
    an int32 scalar that may exceed ``out_cap`` (the caller flags that as
    overflow); ``local_ids`` ``(N,)`` each input's position in the unique
    list, EMPTY for EMPTY inputs.  Torch ops on any device, no host sync:
    one stable sort, the first of each run of equal ids, their rank by
    original position (a cumulative sum in input order) carried to the
    run by a ``cummax`` forward fill, and two scatters.  No path of the
    port calls it (the sampler dedups with K3's seeded form)."""
    n = ids.shape[0]
    dev = ids.device
    sid, spos = torch.sort(ids, stable=True)
    is_first = torch.ones(n, dtype=torch.bool, device=dev)
    is_first[1:] = sid[1:] != sid[:-1]
    is_first &= sid != EMPTY
    num_unique = is_first.sum(dtype=torch.int32)

    # a run's first element (its smallest position: the sort is stable)
    # ranked among the firsts by position, in input order
    first_at = torch.zeros(n, dtype=torch.bool, device=dev)
    first_at[spos] = is_first
    rank = torch.cumsum(first_at, 0, dtype=torch.int32) - 1
    local_first = rank[spos]

    # forward fill: every element takes the local id of its run's first
    pos = torch.arange(n, device=dev)
    head = torch.cummax(torch.where(is_first, pos, 0), 0).values
    local_sorted = torch.where(is_first, local_first, 0)[head]

    local_ids = torch.empty(n, dtype=torch.int32, device=dev)
    local_ids[spos] = local_sorted
    local_ids = torch.where(ids == EMPTY, EMPTY, local_ids)

    slot = torch.where(is_first & (local_first < out_cap), local_first,
                       out_cap)
    unique_ids = torch.full((out_cap + 1,), EMPTY, dtype=ids.dtype,
                            device=dev)
    unique_ids[slot] = torch.where(slot < out_cap, sid, EMPTY)
    return unique_ids[:out_cap], num_unique, local_ids


class _State:
    """K3's table, tile words, rank records, bitmaps and the generation of
    its last call, for one stream (``csrc/unique.cu`` gives the layout)."""

    def __init__(self, device: torch.device, num_node: int):
        words = -(-num_node // 32)
        tiles = max(1, -(-words // _TILE_WORDS))
        self.num_node = num_node
        self.buf = torch.empty(num_node + tiles + 2 * words + 2,
                               dtype=torch.int64, device=device)
        self.lock = threading.Lock()
        # every table entry older than any stamp, every tile word
        # unpublished, the bitmaps, the ticket and the generation 0
        self.buf[:num_node].fill_(-1)
        self.buf[num_node:].zero_()

    @property
    def gen(self) -> int:
        """The generation of the state's last call (read from the card: it
        waits for the stream), the low word of the state's last int64."""
        return int(self.buf[-1]) & _MAX_GEN

    @gen.setter
    def gen(self, value: int):
        if not 0 <= value < _MAX_GEN:
            raise ValueError(f"generation {value} out of [0, {_MAX_GEN})")
        self.buf[-1].fill_(value)


_states: dict = {}
_states_lock = threading.Lock()


def state(device: torch.device, num_node: int) -> _State:
    """K3's state for ``num_node`` on the current stream of ``device``, made
    there at first use.  Calls on one stream run in order, so they share it;
    calls on two streams never do."""
    stream = torch.cuda.current_stream(device)
    key = (stream.device.index, stream.cuda_stream, num_node)
    with _states_lock:
        st = _states.get(key)
        if st is None:
            st = _states[key] = _State(stream.device, num_node)
        return st


def _check(prefix, picks, num_prev, out_cap, num_node):
    for what, t in (("prefix", prefix), ("picks", picks)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(
                f"unique_seeded: {what} must be 1-D int32, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"unique_seeded: {what} must be contiguous")
    if prefix.device != picks.device:
        raise ValueError("unique_seeded: prefix and picks on two devices")
    if not isinstance(num_prev, torch.Tensor) or (
        num_prev.dtype != torch.int32 or num_prev.numel() != 1
        or num_prev.device != picks.device
    ):
        raise ValueError(
            f"unique_seeded: num_prev must be a tensor of one int32 on "
            f"{picks.device}"
        )
    if out_cap < 0:
        raise ValueError(f"unique_seeded: out_cap {out_cap}")
    if num_node is not None and not 0 <= num_node <= EMPTY:
        raise ValueError(f"unique_seeded: num_node {num_node} out of range")
    if picks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unique_seeded: no kernel for {picks.device}")


def _launch(prefix, picks, num_prev, out_cap, num_node, local_prefix,
            local_picks):
    """The kernel on CUDA tensors: returns ``(unique_ids, num_unique)`` and
    writes the local ids into ``local_prefix`` (or not, if None) and
    ``local_picks``."""
    if num_node is None:
        raise ValueError("unique_seeded: the CUDA kernel needs num_node")
    dev = picks.device
    lib = _build.load("unique")
    st = state(dev, num_node)
    unique_ids = torch.empty(out_cap, dtype=torch.int32, device=dev)
    num_unique = torch.empty((), dtype=torch.int32, device=dev)
    # a call's three launches under one lock, so that the calls of two
    # threads on one stream do not interleave; each takes the generation
    # its predecessor on the stream left on the card
    with st.lock:
        rc = lib.xg_unique_seeded(
            prefix.data_ptr(), prefix.shape[0], picks.data_ptr(),
            picks.shape[0], num_prev.data_ptr(), num_node, out_cap,
            st.buf.data_ptr(), st.buf.numel(),
            unique_ids.data_ptr(), num_unique.data_ptr(),
            None if local_prefix is None else local_prefix.data_ptr(),
            local_picks.data_ptr(), _build.stream_handle(dev),
        )
    _build.check(rc, _NAME)
    _build.LAUNCHES.add(_NAME)
    return unique_ids, num_unique


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
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(
            f"unique_seeded: ids must be 1-D int32, got {ids.dtype} "
            f"{tuple(ids.shape)}"
        )
    if not ids.is_contiguous():
        raise ValueError("unique_seeded: ids must be contiguous")
    if not 0 <= prev_cap <= ids.shape[0]:
        raise ValueError(
            f"unique_seeded: prev_cap {prev_cap} for {ids.shape[0]} ids"
        )
    _check(ids[:prev_cap], ids[prev_cap:], num_prev, out_cap, num_node)
    if ids.device.type == "cpu":
        return unique_seeded_plain(ids, num_prev, prev_cap, out_cap)
    local_ids = torch.empty(ids.shape[0], dtype=torch.int32,
                            device=ids.device)
    unique_ids, num_unique = _launch(
        ids[:prev_cap], ids[prev_cap:], num_prev, out_cap, num_node,
        local_ids[:prev_cap], local_ids[prev_cap:])
    return unique_ids, num_unique, local_ids


def unique_seeded_split(
    prefix: torch.Tensor,
    picks: torch.Tensor,
    num_prev: torch.Tensor,
    out_cap: int,
    *,
    num_node: Optional[int] = None,
):
    """:func:`unique_seeded` of ``concat(prefix, picks)`` (``prev_cap`` is
    ``len(prefix)``) without the concatenation, returning ``(unique_ids,
    num_unique, local_ids of the picks)``."""
    _check(prefix, picks, num_prev, out_cap, num_node)
    if picks.device.type == "cpu":
        return unique_seeded_split_plain(prefix, picks, num_prev, out_cap)
    local_picks = torch.empty(picks.shape[0], dtype=torch.int32,
                              device=picks.device)
    unique_ids, num_unique = _launch(prefix, picks, num_prev, out_cap,
                                     num_node, None, local_picks)
    return unique_ids, num_unique, local_picks
