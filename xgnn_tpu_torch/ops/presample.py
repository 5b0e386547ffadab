"""K12 and K12b: the presample counts behind the cache rankings.

K12, :func:`accumulate_freq`: ``freq[ids[i]] += 1`` for ``i < num_input``
and ids in ``[0, len(freq))``, in place (the JAX package's ``_accumulate``
of ``xgnn_tpu/store/presample.py`` returns a new array).  K12b,
:func:`closure_expand`: one batch of ``static_exact_ranking``, the node set
within ``num_layer`` hops of the seeds (every neighbour, not a sample)
added into ``counts`` in place, as the JAX package's ``expand`` does with
its edge-parallel bitmask closure.

The CUDA kernels are ``csrc/presample.cu``; K12b there is a BFS by levels
that expands each row once.  :func:`accumulate_freq_plain` (``index_put_``
with ``accumulate=True``) and :func:`closure_expand_plain` (the
edge-parallel closure in PyTorch ops) are their plain versions: the
wrappers take them only for tensors on the CPU.  Both are exact.  Launches
are counted as ``accumulate_freq`` and ``closure_expand``, one a call.
"""

from __future__ import annotations

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
