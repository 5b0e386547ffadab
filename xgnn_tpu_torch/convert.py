"""Weights of the JAX package's flax ``GNN`` as a state dict of the port's.

Flax ``Dense`` kernels are ``(in, out)`` and PyTorch weights ``(out, in)``,
so kernels are transposed.  In each ``SAGEConv_{i}`` flax names the self
transform ``Dense_0`` (no bias) and the neighbour transform ``Dense_1``
(with bias), in the order ``SAGEConv.__call__`` creates them, and so does
each ``PinSAGEConv_{i}``.  An ``MLPConv_{i}`` holds one ``Dense_0`` (with
bias).  A ``GCNConv_{i}`` holds ``Dense_0`` (no bias) and its own ``bias``; a
``GATConv_{i}`` holds ``kernel`` ``(in, H, d)``, ``attn_l`` and ``attn_r``
``(H, d)``, which the port keeps in the same layout.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _sage(p, pre):
    return {
        pre + "fc_self.weight": _t(p["Dense_0"]["kernel"]).T.contiguous(),
        pre + "fc_neigh.weight": _t(p["Dense_1"]["kernel"]).T.contiguous(),
        pre + "fc_neigh.bias": _t(p["Dense_1"]["bias"]),
    }


def _gcn(p, pre):
    return {
        pre + "fc.weight": _t(p["Dense_0"]["kernel"]).T.contiguous(),
        pre + "bias": _t(p["bias"]),
    }


def _mlp(p, pre):
    return {
        pre + "fc.weight": _t(p["Dense_0"]["kernel"]).T.contiguous(),
        pre + "fc.bias": _t(p["Dense_0"]["bias"]),
    }


def _gat(p, pre):
    return {pre + name: _t(p[name]) for name in ("kernel", "attn_l",
                                                 "attn_r")}


_LAYERS = {"SAGEConv": _sage, "PinSAGEConv": _sage, "GCNConv": _gcn,
           "GATConv": _gat, "MLPConv": _mlp}


def params_from_flax(params_np) -> dict:
    """``params_np``: the flax params tree (``{"SAGEConv_0": {"Dense_0":
    {"kernel": ...}, ...}}``) as numpy arrays."""
    for name, convert in _LAYERS.items():
        if f"{name}_0" in params_np:
            break
    else:
        raise ValueError("no layers of " + ", ".join(
            f"{n}_{{i}}" for n in _LAYERS) + " in the flax params")
    state = {}
    i = 0
    while f"{name}_{i}" in params_np:
        state.update(convert(params_np[f"{name}_{i}"], f"layers.{i}."))
        i += 1
    return state
