"""The owner exchange over an interleaved store (K13).

The port of ``xgnn_tpu/parallel/exchange.py``.  Rows are interleaved over
the ``P`` ranks: global row ``g`` lives on rank ``g % P`` at local row
``g // P`` (:func:`shard_interleaved`).  A read of arbitrary rows is two
collectives with static shapes:

    group the requested ids by owner (:func:`plan_exchange`, K13-plan) ->
    all_to_all the ids -> every rank gathers its local rows (K1) ->
    all_to_all the rows back -> read them in request order through the
    plan's pick.

Each rank's segment for each peer holds ``seg_cap`` slots; a request past
its owner's ``seg_cap`` raises the overflow flag (the step is skipped and
replayed at grown capacities by the engine).  Both collectives are
``all_to_all_single`` with equal splits, as JAX's padded segments are.

The owner's serve is K1 over its local partition at ``req // P``, an
EMPTY slot giving a zero row (JAX spreads its padding slots over distinct
rows, a TPU transaction trick; no pick addresses them, so their value is
free).  :func:`partitioned_gather_indirect` returns the raw response
buffer and the pick, so the model's first layer reads the rows through
the pick without a request-order copy; :func:`partitioned_gather` picks
them in request order with K1, where an invalid pick (EMPTY) gives a zero
row, as JAX's ``mode="fill"``.

K13-plan's CUDA kernel is ``csrc/exchange.cu``; :func:`plan_exchange_plain`
is its plain PyTorch version (JAX's ``P`` prefix counts), which the
wrapper takes only for ids on the CPU.  Launches are counted as
``plan_exchange``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as C
from ..ops import _build
from ..ops.gather import gather_rows
from .mesh import Mesh

EMPTY = C.EMPTY_KEY
MAX_PARTS = 32  # kMaxParts in csrc/exchange.cu
_NAME = "plan_exchange"
_TILE = 2048  # kTile in csrc/exchange.cu


def shard_interleaved(arr, num_parts: int) -> np.ndarray:
    """Host-side: rows rearranged so that partition ``p`` holds rows ``p,
    p + P, p + 2P, ...``: ``(P, ceil(N / P), ...)``, zero padded; row ``g``
    lands at ``[g % P, g // P]``."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    rows = -(-n // num_parts)
    padded = np.zeros((num_parts * rows,) + arr.shape[1:], arr.dtype)
    padded[:n] = arr
    return np.ascontiguousarray(
        padded.reshape(rows, num_parts, *arr.shape[1:]).swapaxes(0, 1))


def interleaved_part(t, num_parts: int, part: int):
    """Rank ``part``'s rows of a tensor or a host array (rows ``part, part
    + P, ...``, zero padded to ``ceil(N / P)``), where it lies:
    ``shard_interleaved(t, P)[part]``.  At P = 1 it is ``t`` itself, not a
    copy."""
    if num_parts == 1:
        return t
    rows = -(-t.shape[0] // num_parts)
    own = t[part::num_parts]
    if isinstance(t, torch.Tensor):
        out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
    else:
        out = np.zeros((rows,) + t.shape[1:], t.dtype)
    out[:own.shape[0]] = own
    return out


class Plan(NamedTuple):
    """``send``: ``(P, seg_cap)`` ids by owner, in request order, EMPTY
    padded; ``pick``: each request's slot ``owner * seg_cap + rank``, or
    EMPTY where it is EMPTY or past ``seg_cap``; ``overflow``: a bool scalar
    on the device.  ``owner`` (``P`` for EMPTY) and ``rank`` (0 for EMPTY)
    only from :func:`plan_exchange_plain` where asked for."""

    send: torch.Tensor
    pick: torch.Tensor
    overflow: torch.Tensor
    owner: Optional[torch.Tensor] = None
    rank: Optional[torch.Tensor] = None


def plan_exchange_plain(ids: torch.Tensor, num_parts: int, seg_cap: int,
                        ranks: bool = False,
                        hot_limit: Optional[int] = None) -> Plan:
    """JAX's ``plan_exchange`` in torch ops: ``P`` prefix counts over the
    request vector, then a linearised scatter.  ``ranks``: also return each
    request's owner and rank, as JAX's ``plan_exchange`` does (the
    exchange itself needs only ``send`` and ``pick``).  ``hot_limit``: an
    id at or past it counts as EMPTY (JAX's hot mask before the plan)."""
    valid = ids != EMPTY
    if hot_limit is not None:
        valid = valid & (ids < hot_limit)
    owner = torch.where(valid, torch.remainder(ids, num_parts), num_parts)
    rank = torch.zeros_like(ids)
    for k in range(num_parts):
        mask = owner == k
        rank = rank + torch.where(mask, torch.cumsum(mask, 0) - 1, 0).to(
            torch.int32)
    ok = valid & (rank < seg_cap)
    slot = owner * seg_cap + rank
    dump = num_parts * seg_cap
    send = torch.full((dump + 1,), EMPTY, dtype=torch.int32,
                      device=ids.device)
    send[torch.where(ok, slot, dump).long()] = ids
    return Plan(send[:dump].reshape(num_parts, seg_cap),
                torch.where(ok, slot, EMPTY).to(torch.int32),
                (valid & (rank >= seg_cap)).any(),
                owner.to(torch.int32) if ranks else None,
                rank if ranks else None)


def plan_exchange(ids: torch.Tensor, num_parts: int, seg_cap: int,
                  hot_limit: Optional[int] = None) -> Plan:
    """K13-plan: ``(n,)`` int32 requested ids grouped by owner (``id %
    num_parts``) into a ``(num_parts, seg_cap)`` send buffer.  ``hot_limit``
    (a tiered topology's hot prefix size): an id at or past it is not sent
    and its pick is EMPTY, as an EMPTY request's, so no mask pass runs
    before the plan.  On the card ``send``, ``pick``, the overflow byte and
    the kernel's scratch lie in one allocation, and the call is one memset
    and one kernel."""
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"plan_exchange: ids must be 1-D int32, got "
                         f"{ids.dtype} {tuple(ids.shape)}")
    if not 1 <= num_parts <= MAX_PARTS:
        raise ValueError(f"plan_exchange: {num_parts} parts; the kernel "
                         f"takes 1 to {MAX_PARTS}")
    if seg_cap < 1 or num_parts * seg_cap >= 2**31:
        raise ValueError(f"plan_exchange: seg_cap {seg_cap} out of range")
    if ids.device.type == "cpu":
        return plan_exchange_plain(ids, num_parts, seg_cap,
                                   hot_limit=hot_limit)
    if ids.device.type != "cuda":
        raise ValueError(f"plan_exchange: no kernel for {ids.device}")
    ids = ids.contiguous()
    n = ids.shape[0]
    pick_at, flag_at, words = plan_layout(n, num_parts, seg_cap)
    buf = torch.empty(words, dtype=torch.int32, device=ids.device)
    rc = _plan_entry()(ids.data_ptr(), n, num_parts,
                       EMPTY if hot_limit is None else int(hot_limit),
                       seg_cap, buf.data_ptr(),
                       _build.stream_handle(ids.device))
    _build.check(rc, _NAME)
    _build.LAUNCHES.add(_NAME)
    return Plan(buf.as_strided((num_parts, seg_cap), (seg_cap, 1)),
                buf.as_strided((n,), (1,), pick_at),
                buf.view(torch.bool).as_strided((), (), 4 * flag_at))


def plan_layout(n: int, num_parts: int, seg_cap: int):
    """``(pick, flag, words)``: the int32 offsets of pick and of the overflow
    byte's 16 bytes in the kernel's buffer, and its size
    (``xg_plan_buffer_words``): send, pick, the overflow byte, then the
    scratch (an 8-byte ticket and a 64-bit status word a tile and owner)."""
    pick = -(-num_parts * seg_cap // 4) * 4
    flag = pick + -(-n // 4) * 4
    return pick, flag, flag + 6 + 2 * max(-(-n // _TILE), 1) * num_parts


_entry = []


def _plan_entry():
    """The bound C entry point, looked up once."""
    if not _entry:
        _entry.append(_build.load("exchange").xg_plan_exchange)
    return _entry[0]


def local_rows_of(req: torch.Tensor, num_parts: int) -> torch.Tensor:
    """The owner's local row of each received global id (``g // P``),
    EMPTY kept."""
    if num_parts == 1:
        return req
    return torch.where(req != EMPTY,
                       torch.div(req, num_parts, rounding_mode="floor"),
                       EMPTY)


def partitioned_gather_indirect(local_rows: torch.Tensor, ids: torch.Tensor,
                                mesh: Mesh, seg_cap: int):
    """The exchange without the request-order copy: ``(buf, pick,
    overflow)``, ``buf`` the ``(P * seg, F)`` response rows in (owner,
    rank) order and ``row_for_request[i] == buf[pick[i]]``, ``pick[i]``
    EMPTY for an EMPTY or overflowed request.  A segment never needs more
    slots than there are requests, so ``seg = min(seg_cap, n)``."""
    p = mesh.size
    seg = max(min(seg_cap, ids.shape[0]), 1)
    plan = plan_exchange(ids, p, seg)
    req = mesh.all_to_all(plan.send.reshape(-1))
    rows = gather_rows(local_rows, local_rows_of(req, p))
    buf = mesh.all_to_all(rows)
    return buf, plan.pick, plan.overflow


def partitioned_gather(local_rows: torch.Tensor, ids: torch.Tensor,
                       mesh: Mesh, seg_cap: int):
    """Rows of an interleave-partitioned table in request order: ``(out,
    overflow)``, ``out`` ``(n, F)`` with zero rows for EMPTY or overflowed
    requests."""
    buf, pick, overflow = partitioned_gather_indirect(local_rows, ids, mesh,
                                                      seg_cap)
    return gather_rows(buf, pick), overflow
