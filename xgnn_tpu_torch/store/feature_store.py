"""Feature and label sources with the whole table on the device.

The port of ``HBMFeatureSource``, ``LabelSource`` and ``_gather_rows`` of
``xgnn_tpu/store/feature_store.py``.  Both gather through kernel K1.  Slots
at or past ``num_valid`` come back as zero rows (the JAX package fills them
with arbitrary finite rows; nothing reads them).  The tiered and cached
sources are ROADMAP queue 1, 'Stores and caching'.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops.gather import gather_rows


def _gather_rows(feat: torch.Tensor, ids: torch.Tensor, num_valid):
    n = ids.shape[0]
    live = torch.arange(n, device=ids.device) < num_valid
    return gather_rows(feat, torch.where(live, ids, C.EMPTY_KEY))


class HBMFeatureSource:
    """The whole feature matrix in device memory."""

    def __init__(self, feat, device):
        self.feat = torch.as_tensor(feat).to(device=device,
                                             dtype=torch.float32).contiguous()
        self.feat_dim = int(self.feat.shape[1])

    def extract(self, input_nodes: torch.Tensor, num_input):
        out = _gather_rows(self.feat, input_nodes, num_input)
        return out, {"hit_rate": 1.0, "miss_bytes": 0}


class LabelSource:
    """Labels in device memory as int32, negative labels clipped to 0."""

    def __init__(self, label, device):
        if isinstance(label, torch.Tensor):
            lab = label.to(device=device, dtype=torch.int32)
        else:
            lab = torch.from_numpy(np.asarray(label).astype(np.int32)).to(device)
        self.label = torch.clamp(lab, min=0).contiguous()

    def extract(self, output_nodes: torch.Tensor, num_output):
        return _gather_rows(self.label[:, None], output_nodes, num_output)[:, 0]
