"""Weights of the JAX package's flax ``GNN`` as a state dict of the port's.

Flax ``Dense`` kernels are ``(in, out)`` and PyTorch weights ``(out, in)``,
so kernels are transposed.  In each ``SAGEConv_{i}`` flax names the self
transform ``Dense_0`` (no bias) and the neighbour transform ``Dense_1``
(with bias), in the order ``SAGEConv.__call__`` creates them.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_flax(params_np) -> dict:
    """``params_np``: the flax params tree (``{"SAGEConv_0": {"Dense_0":
    {"kernel": ...}, ...}}``) as numpy arrays."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {}
    i = 0
    while f"SAGEConv_{i}" in params_np:
        dense_self = params_np[f"SAGEConv_{i}"]["Dense_0"]
        dense_neigh = params_np[f"SAGEConv_{i}"]["Dense_1"]
        pre = f"layers.{i}."
        state[pre + "fc_self.weight"] = t(dense_self["kernel"]).T.contiguous()
        state[pre + "fc_neigh.weight"] = t(dense_neigh["kernel"]).T.contiguous()
        state[pre + "fc_neigh.bias"] = t(dense_neigh["bias"])
        i += 1
    if i == 0:
        raise ValueError("no SAGEConv_{i} layers in the flax params")
    return state
