"""K11: the tiered extract, hot rows from the device cache and cold rows
read by the SMs in place from pinned, mapped host memory.

The port of ``xgnn_tpu/store/feature_store.py``'s two-phase extract
(``_split_kernel``, the host gather of the miss rows, their copy to the
device and ``_combine_kernel``).  For ``i < num_input`` and a valid id,
``out[i] = cache[posmap[id]]`` where the row is cached, else the host
table's row ``id``; every other row is zero.  ``counts`` holds the hits and
the misses as device int32.  With ``posmap=None`` (the all-miss form) every
valid id is read from the host table: the cache's rows are built so.  The
host table is the dataset's float32 or float16 (an F16 feature file); the
cache and ``out`` are of the host's type, or bfloat16 under
``feat_dtype="bfloat16"`` (JAX keeps the host tier in the dataset's dtype
and the device cache in ``feat_dtype``): a miss row is then rounded to
bfloat16 as it is written, as JAX's combine casts it (``astype``), and
crosses PCIe in the host's type.

Two steps in ``csrc/tiered.cu``, both on the caller's stream, with nothing
waiting on the host:

1. :func:`tiered_split`: the posmap lookup, the hit and zero rows of
   ``out``, the exact counts and the stable compaction of the miss
   positions and ids (``compact_mask_positions``), JAX's split;
2. :func:`tiered_direct`: ``out[miss_pos[j]] = host[miss_ids[j]]`` for
   ``j < counts[1]`` (the count read on the device), the SMs reading the
   rows in place over PCIe from the table that :class:`MappedHostTable`
   pins and maps: JAX's host gather, copy and combine in one kernel.

The split has a position form, :func:`tiered_split_positions`, for a
cache spread over the cards (XGNN's two-phase GGMS,
``parallel/ggms.py``): it writes each hit's cache position in place of its
row, and the owner exchange serves the rows.

Their plain PyTorch versions are :func:`tiered_split_plain`,
:func:`tiered_split_positions_plain` and
:func:`tiered_direct_plain` (a gather of the miss rows on the host, their
copy to the device and :func:`tiered_combine_plain`, JAX's combine),
composed in :func:`tiered_extract_plain`: the wrappers take them only for
tensors on the CPU.  Launches are counted as ``tiered_split``,
``tiered_split_positions`` and by the
host's and ``out``'s types as ``tiered_direct`` (float32 rows),
``tiered_direct_bf16`` (float32 rounded to bfloat16),
``tiered_direct_f16`` (float16 rows) and ``tiered_direct_f16_bf16``
(float16 rounded to bfloat16).
"""

from __future__ import annotations

import copy
import ctypes
import warnings
from typing import Optional, Union

import numpy as np
import torch

from .. import constants as C
from ..device import feature_dtype
from . import _build
from .unique import compact_mask_positions

EMPTY = C.EMPTY_KEY
_TILE = 2048  # ids a block of the split (kTile in csrc/tiered.cu)
# the types of the cache and of the extracted rows, by their element's bytes
DTYPES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
# the host table's types: a dataset's feature file is F32 or F16
HOST_DTYPES = (torch.float32, torch.float16)
# tiered_direct's launch names by (host, out) type
_DIRECT = {(torch.float32, torch.float32): "tiered_direct",
           (torch.float32, torch.bfloat16): "tiered_direct_bf16",
           (torch.float16, torch.float16): "tiered_direct_f16",
           (torch.float16, torch.bfloat16): "tiered_direct_f16_bf16"}


def _map(tensor: torch.Tensor, index: int, what: str = "MappedHostTable",
         read_only: bool = False) -> int:
    """Pin ``tensor``'s memory and map it for every device, read-only
    where asked (memory mapped without write access); its address on
    device ``index``.  A second call over the same memory counts a
    registration more (``xg_host_unmap`` releases one).  Raises if CUDA
    refuses."""
    nbytes = tensor.numel() * tensor.element_size()
    out = ctypes.c_void_p()
    rc = _build.load("tiered").xg_host_map(tensor.data_ptr(), nbytes, index,
                                           int(read_only),
                                           ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"{what}: pinning and mapping {nbytes} bytes "
                           f"{'read-only ' if read_only else ''}for cuda:"
                           f"{index} failed (CUDA error {rc}); the tiered "
                           "store and topology have no other path")
    return out.value


def registrations(tensor: torch.Tensor) -> int:
    """How many :class:`MappedHostTensor` registrations hold the memory at
    ``tensor``'s address (0: it is not pinned by one)."""
    return _build.load("tiered").xg_host_map_count(tensor.data_ptr())


class MappedHostTensor:
    """A contiguous tensor of ``dtype`` in host memory that a CUDA device
    reads in place: on a CUDA ``device`` it is pinned and mapped for every
    device of the process (``cudaHostRegister`` with
    ``cudaHostRegisterPortable | cudaHostRegisterMapped``), and any
    failure raises; :meth:`on` gives its view for another device.  On the
    CPU it is the plain tensor.

    Without ``mesh`` the data is copied first unless converting it made a
    copy already (on the CPU too, unless ``share_on_cpu``): memory that the
    caller holds is never pinned.  With ``mesh`` (a multi-card engine's)
    the memory is the host's one copy, shared by the host's ranks
    (``store/host_shared.SharedHostArray``: written by the host's first
    rank, then mapped read-only by every rank of the host, each registering
    it with ``cudaHostRegisterReadOnly``); on the mesh's device, and every
    rank of the mesh's world must make it.  :meth:`close`
    (or garbage collection) unmaps it."""

    def __init__(self, data, device: Union[str, torch.device, None],
                 dtype: torch.dtype, what: str = "MappedHostTensor",
                 share_on_cpu: bool = False, mesh=None):
        self.what = what
        self.shared = None
        self._ptrs: dict = {}  # the devices' addresses, by device index
        self._view = False
        self.read_only = False
        if mesh is not None:
            self.device = mesh.device
            self._init_shared(data, mesh, dtype)
            return
        device = torch.device(device)
        with warnings.catch_warnings():
            # a read-only array (a dataset file's memory map) is copied
            # below, or only read where it is shared on the CPU
            warnings.filterwarnings("ignore", "The given NumPy array is "
                                    "not writable")
            t = torch.as_tensor(data).detach()
        own = t.to("cpu", dtype)
        if own is t and (device.type == "cuda" or not share_on_cpu):
            # no copy was made: never pin memory that the caller holds
            own = own.clone()
        self.tensor = own.contiguous()
        self._check(tuple(self.tensor.shape))
        self.device = device
        if device.type == "cuda" and self.tensor.numel():
            index = device.index if device.index is not None else \
                torch.cuda.current_device()
            self.device = torch.device("cuda", index)
            torch.cuda.init()
            self._ptrs[index] = _map(self.tensor, index, what)

    def _init_shared(self, data, mesh, dtype: torch.dtype):
        from ..store.host_shared import SharedHostArray

        self._check(tuple(data.shape) if hasattr(data, "shape")
                    else np.shape(data))

        def register(tensor: torch.Tensor):
            self.tensor = tensor
            torch.cuda.init()
            self._ptrs[self.device.index] = _map(tensor, self.device.index,
                                                 self.what, True)

        def release():
            self.close()
            self.tensor = None

        self.read_only = True
        self.shared = SharedHostArray(
            mesh, data, dtype, self.what,
            register if self.device.type == "cuda" else None, release)
        self.tensor = self.shared.tensor

    @property
    def dev_ptr(self) -> Optional[int]:
        """The table's address on :attr:`device` (None on the CPU and for
        an empty tensor)."""
        return self._ptrs.get(self.device.index) \
            if self.device.type == "cuda" else None

    def on(self, device) -> "MappedHostTensor":
        """This memory as ``device`` reads it: a view that shares the
        tensor and the registration (one more device's address of it;
        :meth:`close` of this object releases it, the view's does
        nothing).  On the CPU, or for this object's own device, ``self``."""
        device = torch.device(device)
        if device == self.device or device.type != "cuda":
            return self
        if self.device.type != "cuda":
            raise ValueError(f"{self.what}: a table mapped for the CPU "
                             f"serves no {device}")
        if device.index not in self._ptrs and self.tensor.numel():
            self._ptrs[device.index] = _map(self.tensor, device.index,
                                            self.what, self.read_only)
        view = copy.copy(self)
        view.device, view._view = device, True
        return view

    def _check(self, shape: tuple):
        """A subclass's refusal of a shape, before anything is pinned."""

    def close(self):
        if self._view:
            return
        for index in list(self._ptrs):
            del self._ptrs[index]
            _build.load("tiered").xg_host_unmap(self.tensor.data_ptr(),
                                                index)

    def __del__(self):
        try:
            self.close()
        except Exception:  # at interpreter exit the library may be gone
            pass


class MappedHostTable(MappedHostTensor):
    """A 2-D :class:`MappedHostTensor`: the tiered store's host table of
    feature rows, float16 where ``table`` is float16 (an F16 feature file,
    kept as JAX keeps its host tier), else float32; with ``mesh`` the
    host's one copy."""

    def __init__(self, table, device: Union[str, torch.device, None] = None,
                 mesh=None):
        super().__init__(table, device, feature_dtype(table),
                         "MappedHostTable", mesh=mesh)

    def _check(self, shape: tuple):
        if len(shape) != 2:
            raise ValueError(f"MappedHostTable: a 2-D table, got {shape}")


# ---------------------------------------------------------- plain versions
def _out_dtype(cache: Optional[torch.Tensor], dtype,
               host: torch.Tensor) -> torch.dtype:
    """The extracted rows' type: ``dtype`` where given, else the cache's,
    else the host table's."""
    if dtype is not None:
        return dtype
    return host.dtype if cache is None else cache.dtype


def _split_lists_plain(ids: torch.Tensor, num_input,
                       posmap: Optional[torch.Tensor], num_node: int):
    """``(hit, slot, counts, miss_pos, miss_ids)`` of the split: each
    slot's hit flag and cache position (0 where it is no hit), the int32
    ``(hits, misses)`` and the misses' positions in order (padded with
    ``n``) and ids (padded with EMPTY)."""
    dev = ids.device
    n = ids.shape[0]
    live = torch.arange(n, device=dev) < _build.int32_scalar(num_input, dev)
    valid = live & (ids >= 0) & (ids < num_node)
    safe = torch.where(valid, ids, 0).long()
    if posmap is None or num_node == 0:
        hit, slot = torch.zeros_like(valid), torch.zeros_like(ids)
    else:
        looked = posmap[safe]
        hit = valid & (looked != EMPTY)
        slot = torch.where(hit, looked, 0)
    miss = valid & ~hit
    num_miss = miss.sum(dtype=torch.int32)
    miss_pos = compact_mask_positions(miss, n)
    miss_ids = torch.where(torch.arange(n, device=dev) < num_miss,
                           ids[miss_pos.clamp(max=max(n - 1, 0)).long()],
                           EMPTY)
    counts = torch.stack([hit.sum(dtype=torch.int32), num_miss])
    return hit, slot, counts, miss_pos, miss_ids


def tiered_split_plain(ids: torch.Tensor, num_input,
                       posmap: Optional[torch.Tensor],
                       cache: Optional[torch.Tensor], host: torch.Tensor,
                       dtype: Optional[torch.dtype] = None):
    """``(out, counts, miss_pos, miss_ids)``: JAX's ``_split_kernel`` in
    PyTorch ops.  ``out`` holds the hit rows and zero rows elsewhere (the
    misses included); ``miss_pos`` the misses' positions in order, padded
    with ``n``; ``miss_ids`` their ids, padded with EMPTY; ``counts`` the
    int32 ``(hits, misses)``.  ``host`` is the table (its shape is read).
    ``out`` is of ``dtype``, by default the cache's (the host's without
    one)."""
    n, (num_node, width) = ids.shape[0], host.shape
    hit, slot, counts, miss_pos, miss_ids = _split_lists_plain(
        ids, num_input, posmap, num_node)
    out = torch.zeros((n, width), dtype=_out_dtype(cache, dtype, host),
                      device=ids.device)
    if posmap is not None and cache is not None and cache.shape[0]:
        out = torch.where(hit[:, None], cache[slot.long()], out)
    return out, counts, miss_pos, miss_ids


def tiered_split_positions_plain(ids: torch.Tensor, num_input,
                                 posmap: torch.Tensor):
    """``(pos, counts, miss_pos, miss_ids)``: the split's position form in
    PyTorch ops, the lookup and compaction of JAX's ``cache_split``
    (``xgnn_tpu/parallel/ggms.py:134-203``).  ``pos`` holds each hit's
    cache position and EMPTY elsewhere (a miss, an invalid id, a slot at or
    past ``num_input``); the rest as :func:`tiered_split_plain`."""
    hit, slot, counts, miss_pos, miss_ids = _split_lists_plain(
        ids, num_input, posmap, posmap.shape[0])
    pos = torch.where(hit, slot, EMPTY).to(torch.int32)
    return pos, counts, miss_pos, miss_ids


def tiered_combine_plain(out: torch.Tensor, miss_rows: torch.Tensor,
                         miss_pos: torch.Tensor, num_miss: int):
    """JAX's ``_combine_kernel``: ``out[miss_pos[j]] = miss_rows[j]`` for
    ``j < num_miss``, cast to ``out``'s type, in place (JAX donates
    ``out``); returns ``out``."""
    out[miss_pos[:num_miss].long()] = miss_rows[:num_miss].to(
        device=out.device, dtype=out.dtype)
    return out


def tiered_direct_plain(out: torch.Tensor, miss_ids: torch.Tensor,
                        miss_pos: torch.Tensor, num_miss: int,
                        host: torch.Tensor):
    """JAX's host gather, copy and combine: ``out[miss_pos[j]] =
    host[miss_ids[j]]`` for ``j < num_miss``, the rows gathered from the
    table on the CPU; in place, returns ``out``."""
    miss_rows = host[miss_ids[:num_miss].cpu().long()]
    return tiered_combine_plain(out, miss_rows, miss_pos, num_miss)


def tiered_extract_plain(ids: torch.Tensor, num_input,
                         posmap: Optional[torch.Tensor],
                         cache: Optional[torch.Tensor],
                         host: torch.Tensor,
                         dtype: Optional[torch.dtype] = None):
    """``(out, counts)``: the split, then the miss rows gathered from the
    host table on the CPU and combined into place, in PyTorch ops."""
    out, counts, miss_pos, miss_ids = tiered_split_plain(
        ids, num_input, posmap, cache, host, dtype)
    num_miss = int(counts[1])
    return tiered_direct_plain(out, miss_ids, miss_pos, num_miss,
                               host), counts


# ----------------------------------------------------------- card wrappers
def _check(ids, posmap, cache, host: MappedHostTable, dtype):
    if ids.dim() != 1 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"tiered_extract: ids must be 1-D contiguous int32, "
                         f"got {ids.dtype} {tuple(ids.shape)}")
    num_node, width = host.tensor.shape
    if posmap is not None:
        if (posmap.dtype != torch.int32 or posmap.shape != (num_node,)
                or not posmap.is_contiguous() or posmap.device != ids.device):
            raise ValueError(
                f"tiered_extract: posmap must be ({num_node},) contiguous "
                f"int32 on {ids.device}")
        if (cache is None or cache.dtype not in DTYPES or cache.dim() != 2
                or cache.shape[1] != width or not cache.is_contiguous()
                or cache.device != ids.device):
            raise ValueError(
                f"tiered_extract: cache must be (rows, {width}) contiguous "
                f"float32, bfloat16 or float16 on {ids.device}")
    out_dtype = _out_dtype(cache, dtype, host.tensor)
    if (host.tensor.dtype, out_dtype) not in _DIRECT or (
            cache is not None and dtype not in (None, cache.dtype)):
        raise ValueError(f"tiered_extract: rows of {dtype} from a cache of "
                         f"{None if cache is None else cache.dtype} and a "
                         f"{host.tensor.dtype} host table")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tiered_extract: no kernel for {ids.device}")
    if ids.device.type == "cuda" and (host.dev_ptr is None
                                      or host.device != ids.device):
        raise ValueError(f"tiered_extract: the host table is not mapped for "
                         f"{ids.device}")


def tiered_split(ids: torch.Tensor, num_input,
                 posmap: Optional[torch.Tensor],
                 cache: Optional[torch.Tensor], host: MappedHostTable,
                 dtype: Optional[torch.dtype] = None):
    """``(out, counts, miss_pos, miss_ids)``: step 1.  ``counts`` is the
    int32 ``(hits, misses)`` on ``ids``' device; ``miss_pos`` and
    ``miss_ids`` the misses' positions and ids in position order.  On the
    card ``out``'s miss rows and the lists past ``counts[1]`` are left
    unwritten (the plain version zeroes the rows and pads the lists).
    ``out`` is of ``dtype``, by default the cache's (the host's without
    one)."""
    _check(ids, posmap, cache, host, dtype)
    if ids.device.type == "cpu":
        return tiered_split_plain(ids, num_input, posmap, cache, host.tensor,
                                  dtype)
    dev = ids.device
    n = ids.shape[0]
    num_node, width = host.tensor.shape
    out_dtype = _out_dtype(cache, dtype, host.tensor)
    out = torch.empty((n, width), dtype=out_dtype, device=dev)
    scratch = torch.empty(2 * n + -(-n // _TILE), dtype=torch.int32,
                          device=dev)
    miss_pos, miss_ids, tiles = scratch[:n], scratch[n:2 * n], scratch[2 * n:]
    if n == 0:
        return out, torch.zeros(2, dtype=torch.int32, device=dev), \
            miss_pos, miss_ids
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    num = _build.int32_scalar(num_input, dev)
    rc = _build.load("tiered").xg_tiered_split(
        ids.data_ptr(), n, num.data_ptr(),
        None if posmap is None else posmap.data_ptr(), num_node,
        None if cache is None else cache.data_ptr(), width,
        DTYPES[out_dtype], out.data_ptr(),
        counts.data_ptr(), tiles.data_ptr(), miss_pos.data_ptr(),
        miss_ids.data_ptr(), _build.stream_handle(dev))
    _build.check(rc, "tiered_split")
    _build.LAUNCHES.add("tiered_split")
    return out, counts, miss_pos, miss_ids


def tiered_split_positions(ids: torch.Tensor, num_input,
                           posmap: torch.Tensor):
    """``(pos, counts, miss_pos, miss_ids)``: step 1 in its position form,
    for a cache that the owner exchange serves.  ``pos`` is ``(n,)``
    int32, each hit's ``posmap[id]`` and EMPTY elsewhere; ``counts``,
    ``miss_pos`` and ``miss_ids`` as :func:`tiered_split`'s (the lists past
    ``counts[1]`` unwritten on the card).  No rows are written."""
    if ids.dim() != 1 or ids.dtype != torch.int32 or not ids.is_contiguous():
        raise ValueError(f"tiered_split_positions: ids must be 1-D "
                         f"contiguous int32, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if (posmap.dim() != 1 or posmap.dtype != torch.int32
            or not posmap.is_contiguous() or posmap.device != ids.device):
        raise ValueError(f"tiered_split_positions: posmap must be 1-D "
                         f"contiguous int32 on {ids.device}")
    if ids.device.type == "cpu":
        return tiered_split_positions_plain(ids, num_input, posmap)
    if ids.device.type != "cuda":
        raise ValueError(f"tiered_split_positions: no kernel for "
                         f"{ids.device}")
    dev, n = ids.device, ids.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return pos, torch.zeros(2, dtype=torch.int32, device=dev), empty, \
            empty
    lib = _build.load("tiered")
    # the lists, then the one pass's ticket and a status word a tile
    # (8-byte aligned: 2n words in), which the call zeroes
    scratch = torch.empty(2 * n + lib.xg_tiered_positions_scratch_bytes(n)
                          // 4, dtype=torch.int32, device=dev)
    miss_pos, miss_ids, tiles = scratch[:n], scratch[n:2 * n], scratch[2 * n:]
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    num = _build.int32_scalar(num_input, dev)
    rc = lib.xg_tiered_split_positions(
        ids.data_ptr(), n, num.data_ptr(), posmap.data_ptr(),
        posmap.shape[0], pos.data_ptr(), counts.data_ptr(),
        tiles.data_ptr(), miss_pos.data_ptr(), miss_ids.data_ptr(),
        _build.stream_handle(dev))
    _build.check(rc, "tiered_split_positions")
    _build.LAUNCHES.add("tiered_split_positions")
    return pos, counts, miss_pos, miss_ids


def tiered_direct(out: torch.Tensor, miss_ids: torch.Tensor,
                  miss_pos: torch.Tensor, counts: torch.Tensor,
                  host: MappedHostTable):
    """Step 2: ``out[miss_pos[j]] = host[miss_ids[j]]`` for ``j <
    counts[1]``, in place, rounded to bfloat16 for a bfloat16 ``out``
    (``out`` is of the host's type otherwise); returns ``out``.  On the
    card the count is read on the device (no host sync); positions outside
    ``out`` are skipped."""
    n, width = out.shape if out.dim() == 2 else (-1, -1)
    name = _DIRECT.get((host.tensor.dtype, out.dtype))
    if (name is None or width != host.tensor.shape[1]
            or miss_ids.dtype != torch.int32 or miss_pos.dtype != torch.int32
            or counts.dtype != torch.int32 or counts.shape != (2,)
            or miss_ids.shape != (n,) or miss_pos.shape != (n,)
            or not (out.is_contiguous() and miss_ids.is_contiguous()
                    and miss_pos.is_contiguous())
            or not out.device == miss_ids.device == miss_pos.device
            == counts.device):
        raise ValueError(f"tiered_direct: out (n, {host.tensor.shape[1]}) "
                         f"contiguous, of the {host.tensor.dtype} host "
                         "table's type or bfloat16, miss_ids and miss_pos "
                         "(n,) and counts (2,) int32, on one device")
    if out.device.type == "cpu":
        return tiered_direct_plain(out, miss_ids, miss_pos, int(counts[1]),
                                   host.tensor)
    if host.dev_ptr is None or host.device != out.device:
        raise ValueError(f"tiered_direct: the host table is not mapped for "
                         f"{out.device}")
    if n == 0:
        return out
    rc = _build.load("tiered").xg_tiered_direct(
        host.dev_ptr, width, miss_ids.data_ptr(), miss_pos.data_ptr(),
        counts[1:].data_ptr(), out.data_ptr(), n,
        host.tensor.element_size(), int(out.dtype == torch.bfloat16),
        _build.stream_handle(out.device))
    _build.check(rc, name)
    _build.LAUNCHES.add(name)
    return out


def tiered_extract(ids: torch.Tensor, num_input,
                   posmap: Optional[torch.Tensor],
                   cache: Optional[torch.Tensor], host: MappedHostTable,
                   dtype: Optional[torch.dtype] = None):
    """``(out, counts)``: ``out`` is ``(len(ids), F)`` rows of ``dtype``
    (the host table's type or bfloat16; by default the cache's, the host's
    without one),
    ``counts`` the int32 ``(hits, misses)`` on ``ids``' device.
    ``num_input`` is an int or a device int32 scalar (read on the device:
    no host sync)."""
    _check(ids, posmap, cache, host, dtype)
    if ids.device.type == "cpu":
        return tiered_extract_plain(ids, num_input, posmap, cache,
                                    host.tensor, dtype)
    out, counts, miss_pos, miss_ids = tiered_split(ids, num_input, posmap,
                                                   cache, host, dtype)
    return tiered_direct(out, miss_ids, miss_pos, counts, host), counts
