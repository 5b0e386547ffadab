"""Feature and label sources: the whole table on the device, or tiered.

The port of ``xgnn_tpu/store/feature_store.py``:

- ``HBMFeatureSource`` and ``LabelSource`` gather through kernel K1.  Slots
  at or past ``num_valid`` come back as zero rows (the JAX package fills
  them with arbitrary finite rows; nothing reads them).
- ``TieredFeatureSource``: a hot-row cache in device memory (a ranking's
  prefix) with a node-to-slot position map, and the whole table in pinned
  host memory.  ``extract`` is kernel K11: JAX's split on the card, then
  the miss rows read from the host table in place, over PCIe, in place of
  JAX's host gather, copy and combine.  The miss count stays on the device,
  so the fixed miss bucket that keeps JAX's steps free of host syncs
  (``miss_cap``, its ``overflow`` flag, ``grow_miss_cap``, ``PAD_ROWS``)
  has nothing to do here; the hit and miss counts stay on the device.
- ``DynamicTieredFeatureSource``: ``refresh(ranking)`` rebuilds the position
  map and the cache on the device.

``dtype`` is JAX's ``feat_dtype``: ``torch.bfloat16`` keeps the device
table (the tiered store's cache, and the rows it extracts) in bfloat16,
rounded to nearest, ties to even, as ``astype`` rounds; ``None`` keeps the
dataset's type, float32 or an F16 file's float16, as JAX's store keeps it.
The tiered store's host table keeps the dataset's type too, so an F16
file's misses cross PCIe at 2 bytes a value and ``miss_bytes`` counts
them so.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as C
from ..device import feature_dtype, to_tensor
from ..ops.gather import gather_rows
from ..ops.tiered import MappedHostTable, tiered_extract

EMPTY = C.EMPTY_KEY


def _gather_rows(feat: torch.Tensor, ids: torch.Tensor, num_valid):
    n = ids.shape[0]
    live = torch.arange(n, device=ids.device) < num_valid
    return gather_rows(feat, torch.where(live, ids, C.EMPTY_KEY))


class HBMFeatureSource:
    """The whole feature matrix in device memory, in ``dtype`` (by
    default the dataset's: float32, or float16 from an F16 file)."""

    def __init__(self, feat, device, dtype: Optional[torch.dtype] = None):
        self.feat = to_tensor(feat, device, dtype or feature_dtype(feat)
                              ).contiguous()
        self.feat_dim = int(self.feat.shape[1])

    def extract(self, input_nodes: torch.Tensor, num_input):
        out = _gather_rows(self.feat, input_nodes, num_input)
        return out, {"hit_rate": 1.0, "miss_bytes": 0}


class TieredFeatureSource:
    """The ``int(num_node * cache_percentage)`` hottest rows of a ranking
    cached on the device, every row in pinned, mapped host memory.

    ``extract`` returns ``(x, info)``: ``x`` in the cache's ``dtype`` (by
    default the dataset's); ``info["num_hit"]`` and ``info["num_miss"]``
    are device int32 scalars and ``info["miss_bytes"]`` a device int64
    scalar (the miss rows' bytes in the host table's type, as they cross
    PCIe), so a step waits on nothing; the engine pulls them once an epoch.
    The host table is a copy of ``feat_host`` in its float32 or float16
    (pulled from the device if it lies there; the source keeps no device
    copy), or ``host``'s table where given (a :class:`MappedHostTable` that
    several stores share, read on this device through its ``on``; its
    owner closes it).
    """

    def __init__(self, feat_host, ranking, cache_percentage: float, device,
                 dtype: Optional[torch.dtype] = None,
                 host: Optional[MappedHostTable] = None):
        self.device = torch.device(device)
        self.host = (MappedHostTable(feat_host, self.device) if host is None
                     else host.on(self.device))
        self.dtype = dtype or self.host.tensor.dtype
        num_node, self.feat_dim = self.host.tensor.shape
        self.num_cache = int(num_node * cache_percentage)
        self._build(ranking)

    @property
    def feat_host(self) -> torch.Tensor:
        return self.host.tensor

    @property
    def row_bytes(self) -> int:
        """A host row's bytes, what a miss moves over PCIe."""
        return self.feat_dim * self.host.tensor.element_size()

    def _build(self, ranking):
        """The position map and the cache rows of ``ranking``'s prefix, on
        the device; the rows are read from the host table by K11's
        all-miss form."""
        num_node = self.host.tensor.shape[0]
        cache_ids = to_tensor(ranking[: self.num_cache], self.device,
                              torch.int32)
        posmap = torch.full((num_node,), EMPTY, dtype=torch.int32,
                            device=self.device)
        posmap[cache_ids.long()] = torch.arange(
            cache_ids.shape[0], dtype=torch.int32, device=self.device)
        self.posmap = posmap
        self.cache_feat, _ = tiered_extract(
            cache_ids.contiguous(), cache_ids.shape[0], None, None, self.host,
            self.dtype)

    def extract(self, input_nodes: torch.Tensor, num_input):
        out, counts = tiered_extract(input_nodes, num_input, self.posmap,
                                     self.cache_feat, self.host)
        return out, {
            "num_hit": counts[0],
            "num_miss": counts[1],
            "miss_bytes": counts[1].to(torch.int64) * self.row_bytes,
        }


class DynamicTieredFeatureSource(TieredFeatureSource):
    """A refreshable cache: ``refresh(ranking)`` swaps the cached rows for
    the prefix of a new ranking (a host array or a device tensor).  The
    engine counts accesses on the device and refreshes at epoch ends."""

    def refresh(self, ranking):
        self._build(ranking)


class LabelSource:
    """Labels in device memory as int32, negative labels clipped to 0."""

    def __init__(self, label, device):
        lab = to_tensor(label, device, torch.int32)
        self.label = torch.clamp(lab, min=0).contiguous()

    def extract(self, output_nodes: torch.Tensor, num_output):
        return _gather_rows(self.label[:, None], output_nodes, num_output)[:, 0]
