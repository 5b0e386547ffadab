"""K12 and K12b: the presample counts behind the cache rankings.

K12, :func:`accumulate_freq`: ``freq[ids[i]] += 1`` for ``i < num_input``
and ids in ``[0, len(freq))``, in place (the JAX package's ``_accumulate``
of ``xgnn_tpu/store/presample.py`` returns a new array).  K12b,
:func:`closure_expand`: one batch of ``static_exact_ranking``, the node set
within ``num_layer`` hops of the seeds (every neighbour, not a sample)
added into ``counts`` in place, as the JAX package's ``expand`` does with
its edge-parallel bitmask closure.

K12b's partitioned form, :func:`closure_parts`: one layer of the exact
closure of every rank's batch (a lane each) over a rank's part of the
interleave-partitioned CSR, for ``parallel/collocated.
make_presample_static_exact_step``: the lanes' new marks over the rank's
own rows, then each newly reached row's edges marked at their global
destinations, owner-major, for the reduce by owner, except where the rank
already knows the mark is held (a known set, :func:`closure_known`, that
the calls of a batch carry); or, after the last layer, the lanes that
reached each owned row added into the counts.

The CUDA kernels are ``csrc/presample.cu``; K12b there is a BFS by levels
that expands each row once, and so is its partitioned form, once for all
the lanes that reach the row.  :func:`accumulate_freq_plain`
(``index_put_`` with ``accumulate=True``), :func:`closure_expand_plain`
and :func:`closure_parts_plain` (the edge-parallel closure in PyTorch ops,
as JAX computes it; the partitioned form with the same known set) are
their plain versions: the wrappers take them only for
tensors on the CPU.  All are exact.  Launches are counted as
``accumulate_freq``, ``closure_expand`` and ``closure_parts``, one a call.
"""

from __future__ import annotations

import functools

import torch

from . import _build

MAX_LAYERS = 126  # the CUDA kernel keeps a node's first layer in a byte


def accumulate_freq_plain(freq: torch.Tensor, ids: torch.Tensor, num_input):
    live = torch.arange(ids.shape[0], device=ids.device) < \
        _build.int32_scalar(num_input, ids.device)
    ok = live & (ids >= 0) & (ids < freq.shape[0])
    idx = torch.where(ok, ids, 0).long()
    return freq.index_put_((idx,), ok.to(freq.dtype), accumulate=True)


def _check_1d(name, what, t, dtype=torch.int32):
    if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be 1-D contiguous {dtype}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def accumulate_freq(freq: torch.Tensor, ids: torch.Tensor, num_input):
    """Add one to ``freq`` (int32, ``(num_node,)``) at each of the first
    ``num_input`` ids (an int or a device int32 scalar, read on the
    device); returns ``freq``."""
    for what, t in (("freq", freq), ("ids", ids)):
        _check_1d("accumulate_freq", what, t)
    if freq.device != ids.device:
        raise ValueError("accumulate_freq: freq and ids on two devices")
    if ids.device.type == "cpu":
        return accumulate_freq_plain(freq, ids, num_input)
    if ids.device.type != "cuda":
        raise ValueError(f"accumulate_freq: no kernel for {ids.device}")
    lib = _build.load("presample")
    num = _build.int32_scalar(num_input, ids.device)
    rc = lib.xg_accumulate_freq(
        freq.data_ptr(), freq.shape[0], ids.data_ptr(), ids.shape[0],
        num.data_ptr(), ids.device.index, _build.stream_handle(ids.device))
    _build.check(rc, "accumulate_freq")
    _build.LAUNCHES.add("accumulate_freq")
    return freq


def closure_expand_plain(indptr: torch.Tensor, indices: torch.Tensor,
                         seeds: torch.Tensor, num_layer: int,
                         counts: torch.Tensor):
    """The JAX package's edge-parallel closure: each layer marks the
    destinations of every edge whose source row is marked, from the mask
    of the layer before."""
    num_node = indptr.shape[0] - 1
    dev = seeds.device
    rowid = torch.repeat_interleave(
        torch.arange(num_node, device=dev), (indptr[1:] - indptr[:-1]).long(),
        output_size=indices.shape[0])
    mask = torch.zeros(num_node, dtype=torch.bool, device=dev)
    ok = (seeds >= 0) & (seeds < num_node)
    mask[seeds[ok].long()] = True
    dst_ok = (indices >= 0) & (indices < num_node)
    for _ in range(num_layer):
        hit = mask[rowid] & dst_ok
        mask = mask.clone()
        mask[indices[hit].long()] = True
    return counts.add_(mask.to(counts.dtype))


def closure_expand(indptr: torch.Tensor, indices: torch.Tensor,
                   seeds: torch.Tensor, num_layer: int,
                   counts: torch.Tensor):
    """Add 1 into ``counts`` (int32, ``(num_node,)``) at every node within
    ``num_layer`` CSR hops of ``seeds`` (ids outside ``[0, num_node)``,
    EMPTY among them, are ignored); returns ``counts``."""
    for what, t in (("indptr", indptr), ("indices", indices),
                    ("seeds", seeds), ("counts", counts)):
        _check_1d("closure_expand", what, t)
    num_node = indptr.shape[0] - 1
    if counts.shape[0] != num_node:
        raise ValueError(f"closure_expand: counts has {counts.shape[0]} "
                         f"entries for {num_node} nodes")
    if len({t.device for t in (indptr, indices, seeds, counts)}) != 1:
        raise ValueError("closure_expand: tensors on several devices")
    if num_layer < 0:
        raise ValueError(f"closure_expand: num_layer {num_layer}")
    if seeds.device.type == "cpu":
        return closure_expand_plain(indptr, indices, seeds, num_layer, counts)
    if seeds.device.type != "cuda":
        raise ValueError(f"closure_expand: no kernel for {seeds.device}")
    if counts.data_ptr() % 16:
        raise ValueError("closure_expand: counts must be 16-byte aligned")
    if num_layer > MAX_LAYERS:
        raise ValueError(f"closure_expand: num_layer {num_layer} past the "
                         f"kernel's {MAX_LAYERS} (a level byte a node)")
    lib = _build.load("presample")
    dev = seeds.device
    num_edge = indices.shape[0]
    size = lib.xg_closure_scratch_bytes(num_node, num_edge)
    scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    rc = lib.xg_closure_expand(
        indptr.data_ptr(), indices.data_ptr(), num_node, num_edge,
        seeds.data_ptr(), seeds.shape[0], num_layer, scratch.data_ptr(),
        size, counts.data_ptr(), dev.index, _build.stream_handle(dev))
    _build.check(rc, "closure_expand")
    _build.LAUNCHES.add("closure_expand")
    return counts


def lane_width(parts: int) -> int:
    """Q, the bits a node takes in the known set: the least power of two
    that holds its ``parts`` lanes."""
    return 1 << (parts - 1).bit_length()


def closure_known(rows: int, parts: int, device) -> torch.Tensor:
    """A zeroed known set for :func:`closure_parts` over ``rows`` local rows
    of ``parts`` parts: ``(ceil(rows * parts * Q / 32),)`` int32, node
    ``v``'s lane ``l`` at bit ``v * Q + l``."""
    words = -(-rows * parts * lane_width(parts) // 32)
    return torch.zeros(words, dtype=torch.int32, device=device)


def _unpack(known: torch.Tensor, nodes: int, parts: int) -> torch.Tensor:
    """The known set as ``(parts, nodes)`` bools (a copy)."""
    q = lane_width(parts)
    shifts = torch.arange(32, dtype=torch.int32, device=known.device)
    bits = ((known[:, None] >> shifts) & 1).bool().reshape(-1)
    return bits[:nodes * q].view(nodes, q)[:, :parts].t().contiguous()


def _pack_into(known: torch.Tensor, bits: torch.Tensor):
    """``bits`` (``(parts, nodes)`` bools) written over ``known``."""
    parts, nodes = bits.shape
    q = lane_width(parts)
    slots = torch.zeros((known.shape[0] * 32,), dtype=torch.int64,
                        device=known.device)
    full = torch.zeros((nodes, q), dtype=torch.int64, device=known.device)
    full[:, :parts] = bits.t()
    slots[:nodes * q] = full.reshape(-1)
    shifts = torch.arange(32, dtype=torch.int64, device=known.device)
    words = (slots.view(-1, 32) << shifts).sum(1)
    known.copy_(torch.where(words >= 2**31, words - 2**32, words).to(
        torch.int32))


def closure_parts_plain(indptr: torch.Tensor, indices: torch.Tensor,
                        level: torch.Tensor, recv: torch.Tensor, tag: int,
                        num_node: int, part: int, known: torch.Tensor,
                        counts=None):
    """JAX's edge-parallel layer (``make_presample_static_exact_step``)
    with the known set: the update (its new marks into ``known`` too), then
    each edge's source row found by the cumsum trick over the local
    offsets, the lanes' marks gathered along it, and the ``(lane, node)``
    pairs of their global destinations that ``known`` lacks marked and
    added to it (only the rows reached by the last reduce expand: the older
    rows' destinations are known already)."""
    p, rows = level.shape
    new = (level == 0) & (recv != 0)
    level.masked_fill_(new, tag)
    bits = _unpack(known, rows * p, p)
    lane, row = new.nonzero(as_tuple=True)
    bits[lane, row * p + part] = True
    if counts is not None:
        _pack_into(known, bits)
        return counts.add_((level != 0).sum(0, dtype=torch.int32))
    e = indices.shape[0]
    ip = indptr.long()
    starts = ip[1:rows]
    marks = torch.zeros(e, dtype=torch.int64, device=level.device)
    marks.index_add_(0, starts[starts < e], torch.ones_like(
        starts[starts < e]))
    rowid = torch.cumsum(marks, 0)
    dst = indices.long()
    live = ((torch.arange(e, device=level.device) < ip[rows])
            & (dst >= 0) & (dst < num_node))
    hit = (level[:, rowid] == tag) & live[None, :]
    lane, edge = hit.nonzero(as_tuple=True)
    v = dst[edge]
    fresh = ~bits[lane, v]
    lane, v = lane[fresh], v[fresh]
    bits[lane, v] = True
    _pack_into(known, bits)
    flat = torch.zeros((p, rows * p), dtype=torch.uint8, device=level.device)
    flat[lane, v] = 1
    return flat.view(p, rows, p).permute(2, 0, 1).contiguous()


def closure_parts(indptr: torch.Tensor, indices: torch.Tensor,
                  level: torch.Tensor, recv: torch.Tensor, tag: int,
                  num_node: int, part: int, known: torch.Tensor,
                  counts=None):
    """One layer of K12b's partitioned form on part ``part`` of ``P``.
    ``indptr`` ``(rows + 1,)`` int32 local offsets (local row ``r`` is
    global node ``r * P + part``) and ``indices`` their int32 global
    destinations; ``level``, ``recv`` ``(P, rows)`` uint8: each lane's
    level of the rank's rows (0 unmarked, in place) and their reduced marks
    from the layer before (or the seeds'); ``tag`` this layer's mark, 1 to
    127; ``known`` (:func:`closure_known`, in place) the ``(lane, node)``
    marks this rank knows are held.  ``level`` and ``known`` start zeroed
    for a batch and are carried by calls with tags 1, 2, ... in order.
    First every unmarked ``(lane, row)`` with a mark in ``recv`` is marked
    ``tag`` (and known); then, with ``counts`` None, returns ``(P owners,
    P lanes, rows)`` uint8, 1 at ``[v % P, lane, v // P]`` for every
    destination ``v`` of a row at level ``tag`` whose ``(lane, v)`` was
    not known, now known (the reduce-scatter's input: the owners' levels
    come out as if every destination were sent); else adds to ``counts``
    (``(rows,)`` int32, in place) the lanes that reached each row and
    returns it."""
    for what, t, dtype in (("indptr", indptr, torch.int32),
                           ("indices", indices, torch.int32),
                           ("known", known, torch.int32)):
        _check_1d("closure_parts", what, t, dtype)
    p, rows = level.shape
    if (level.dtype != torch.uint8 or recv.dtype != torch.uint8
            or recv.shape != level.shape or not level.is_contiguous()
            or not recv.is_contiguous()):
        raise ValueError("closure_parts: level and recv must be contiguous "
                         "uint8 (P, rows)")
    if indptr.shape[0] != rows + 1 or rows * p < num_node:
        raise ValueError(f"closure_parts: {indptr.shape[0]} offsets for "
                         f"{rows} rows of {p} parts, {num_node} nodes")
    if not 1 <= tag <= 127:
        raise ValueError(f"closure_parts: tag {tag} outside [1, 127]")
    if not 0 <= part < p <= 32:
        raise ValueError(f"closure_parts: part {part} of {p} (at most 32)")
    words = -(-rows * p * lane_width(p) // 32)
    if known.shape[0] != words:
        raise ValueError(f"closure_parts: known has {known.shape[0]} words, "
                         f"not {words}")
    if counts is not None:
        _check_1d("closure_parts", "counts", counts)
        if counts.shape[0] != rows:
            raise ValueError(f"closure_parts: counts has {counts.shape[0]} "
                             f"entries for {rows} rows")
    dev = level.device
    ts = [indptr, indices, level, recv, known] + ([] if counts is None else
                                                  [counts])
    if len({t.device for t in ts}) != 1:
        raise ValueError("closure_parts: tensors on several devices")
    if dev.type == "cpu":
        return closure_parts_plain(indptr, indices, level, recv, tag,
                                   num_node, part, known, counts)
    if dev.type != "cuda":
        raise ValueError(f"closure_parts: no kernel for {dev}")
    lib = _build.load("presample")
    num_edge = indices.shape[0]
    scratch, size = None, 0
    if counts is None:
        size = _parts_scratch_bytes(lib, rows, p, num_edge)
        scratch = torch.empty(size, dtype=torch.uint8, device=dev)
    rc = lib.xg_closure_parts(
        indptr.data_ptr(), indices.data_ptr(), rows, num_node, num_edge, p,
        part, level.data_ptr(), recv.data_ptr(), tag, known.data_ptr(),
        None if scratch is None else scratch.data_ptr(), size,
        None if counts is None else counts.data_ptr(), dev.index,
        _build.stream_handle(dev))
    _build.check(rc, "closure_parts")
    _build.LAUNCHES.add("closure_parts")
    if counts is not None:
        return counts
    return scratch[:p * p * rows].view(p, p, rows)


@functools.lru_cache(maxsize=64)
def _parts_scratch_bytes(lib, rows, parts, num_edge):
    return lib.xg_closure_parts_scratch_bytes(rows, parts, num_edge)
