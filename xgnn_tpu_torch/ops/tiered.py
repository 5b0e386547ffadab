"""K11: the tiered extract, hot rows from the device cache and cold rows
read from pinned, mapped host memory.

The port of ``xgnn_tpu/store/feature_store.py``'s two-phase extract
(``_split_kernel``, the host gather of the miss rows, their copy to the
device and ``_combine_kernel``).  For ``i < num_input`` and a valid id,
``out[i] = cache[posmap[id]]`` where the row is cached, else the host
table's row ``id``; every other row is zero.  ``counts`` holds the hits and
the misses as device int32.  With ``posmap=None`` (the all-miss form) every
valid id is read from the host table: the cache's rows are built so.

The CUDA kernel is ``csrc/tiered.cu``.  It reads the host table in place
over PCIe through :class:`MappedHostTable`, which pins and maps it; nothing
waits on the host.  :func:`tiered_extract_plain` is its plain PyTorch
version (a gather from the cache, a gather of the miss rows on the host and
their copy to the device, then a ``torch.where``): the wrapper takes it
only for ids on the CPU.  Launches are counted as ``tiered_extract``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from .. import constants as C
from . import _build

_NAME = "tiered_extract"
EMPTY = C.EMPTY_KEY


class MappedHostTable:
    """A contiguous float32 table in host memory that a CUDA device reads
    in place: on a CUDA ``device`` it is pinned and mapped into the
    device's address space (``cudaHostRegister`` with
    ``cudaHostRegisterMapped``), and any failure raises.  On the CPU it is
    the plain table.  :meth:`close` (or garbage collection) unmaps it."""

    def __init__(self, table, device: Union[str, torch.device]):
        device = torch.device(device)
        t = torch.as_tensor(table).detach()
        own = t.to("cpu", torch.float32)
        if own is t:
            # no copy was made: never pin memory that the caller holds
            own = own.clone()
        self.tensor = own.contiguous()
        if self.tensor.dim() != 2:
            raise ValueError(f"MappedHostTable: a 2-D table, got "
                             f"{tuple(self.tensor.shape)}")
        self.device = device
        self.dev_ptr: Optional[int] = None
        if device.type == "cuda" and self.tensor.numel():
            index = device.index if device.index is not None else \
                torch.cuda.current_device()
            self.device = torch.device("cuda", index)
            torch.cuda.init()
            out = ctypes.c_void_p()
            lib = _build.load("tiered")
            rc = lib.xg_host_map(
                self.tensor.data_ptr(),
                self.tensor.numel() * self.tensor.element_size(), index,
                ctypes.addressof(out))
            if rc != 0:
                raise RuntimeError(
                    f"MappedHostTable: pinning and mapping "
                    f"{self.tensor.numel() * 4} bytes failed (CUDA error "
                    f"{rc}); the tiered store has no other path")
            self.dev_ptr = out.value

    def close(self):
        if self.dev_ptr is not None:
            self.dev_ptr = None
            _build.load("tiered").xg_host_unmap(self.tensor.data_ptr(),
                                                self.device.index)

    def __del__(self):
        try:
            self.close()
        except Exception:  # at interpreter exit the library may be gone
            pass


def tiered_extract_plain(ids: torch.Tensor, num_input,
                         posmap: Optional[torch.Tensor],
                         cache: Optional[torch.Tensor],
                         host: torch.Tensor):
    """``(out, counts)``: K11's function in PyTorch ops; ``host`` is the
    table on the CPU, gathered there for the misses."""
    dev = ids.device
    n, (num_node, width) = ids.shape[0], host.shape
    live = torch.arange(n, device=dev) < _build.int32_scalar(num_input, dev)
    valid = live & (ids >= 0) & (ids < num_node)
    safe = torch.where(valid, ids, 0).long()
    if posmap is None:
        hit = torch.zeros_like(valid)
    else:
        hit = valid & (posmap[safe] != EMPTY)
    miss = valid & ~hit
    out = torch.zeros((n, width), dtype=host.dtype, device=dev)
    if posmap is not None and cache is not None and cache.shape[0]:
        slot = torch.where(hit, posmap[safe], 0).long()
        out = torch.where(hit[:, None], cache[slot], out)
    miss_ids = safe[miss].cpu()
    out[miss] = host[miss_ids].to(dev)
    counts = torch.stack([hit.sum(), miss.sum()]).to(torch.int32)
    return out, counts


def _check(ids, posmap, cache, host: MappedHostTable):
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
        if (cache is None or cache.dtype != torch.float32 or cache.dim() != 2
                or cache.shape[1] != width or not cache.is_contiguous()
                or cache.device != ids.device):
            raise ValueError(
                f"tiered_extract: cache must be (rows, {width}) contiguous "
                f"float32 on {ids.device}")
    if ids.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tiered_extract: no kernel for {ids.device}")


def tiered_extract(ids: torch.Tensor, num_input,
                   posmap: Optional[torch.Tensor],
                   cache: Optional[torch.Tensor], host: MappedHostTable):
    """``(out, counts)``: ``out`` is ``(len(ids), F)`` float32 rows,
    ``counts`` the int32 ``(hits, misses)`` on ``ids``' device.
    ``num_input`` is an int or a device int32 scalar (read on the device:
    no host sync)."""
    _check(ids, posmap, cache, host)
    if ids.device.type == "cpu":
        return tiered_extract_plain(ids, num_input, posmap, cache,
                                    host.tensor)
    if host.dev_ptr is None or host.device != ids.device:
        raise ValueError(f"tiered_extract: the host table is not mapped for "
                         f"{ids.device}")
    lib = _build.load("tiered")
    num_node, width = host.tensor.shape
    out = torch.empty((ids.shape[0], width), dtype=torch.float32,
                      device=ids.device)
    counts = torch.empty(2, dtype=torch.int32, device=ids.device)
    num = _build.int32_scalar(num_input, ids.device)
    rc = lib.xg_tiered_extract(
        ids.data_ptr(), ids.shape[0], num.data_ptr(),
        None if posmap is None else posmap.data_ptr(), num_node,
        None if cache is None else cache.data_ptr(), host.dev_ptr, width,
        out.data_ptr(), counts.data_ptr(), ids.device.index,
        _build.stream_handle(ids.device),
    )
    _build.check(rc, _NAME)
    _build.LAUNCHES.add(_NAME)
    return out, counts
