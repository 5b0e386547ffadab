"""Full-graph layer-wise inference and its accuracy (offline evaluation).

The port of ``xgnn_tpu/inference.py``: each layer is computed exactly over
all neighbours of all nodes, with no sampling, so the accuracy carries no
sampling noise.  A layer aggregates through K6 (``ops/spmm.py``):

- GraphSAGE and PinSAGE (uniform weights at evaluation): ``h W_self +
  mean(h) W_neigh + b``, the mean over the CSR row (K6a's mean form);
- GCN: ``hw = h W`` first, scaled by ``1 / sqrt(max(deg, 1))`` on both
  sides of K6a's sum, then ``+ bias``, where ``deg`` is the CSR row's
  degree over the full graph;
- GAT: ``feat = h W`` as ``(N, H, D)``, its two score terms ``el`` and
  ``er``, and K6b's segment softmax; the last layer has one head.

A float16 table (an F16 feature file) stays float16, as JAX keeps it, and
layer 0 rounds where JAX's does: SAGE's and PinSAGE's mean is K6a's
float16 form (each segment of 2048 edges summed in float32 and rounded,
then added in float16), GCN's ``deg`` and ``1 / sqrt(max(deg, 1))`` are
float16, and the products with the float32 weights (the Dense layers,
GAT's transform) widen the rows exactly, as JAX's promotion does.  Every
later layer is float32.

ReLU between layers, ELU for GAT; no dropout.  The MLP has no full-graph
layer and is refused, as the JAX lookup refuses it.  JAX builds a
degree-bucketed plan of the graph for the TPU (``build_spmm_plan``,
``materialize_plan_ids``); the port reads the CSR in place and has none.
It runs on the card unless given ``device="cpu"``, with the model's weights
on that device, and never waits on the host inside its layers.
"""

from __future__ import annotations

import torch

from .device import feature_dtype, resolve, to_tensor
from .models.gnn import GATConv, GCNConv, SAGEConv
from .ops.spmm import gat_aggregate_csr, spmm_csr


def _sage(layer, indptr, indices, h, num_node):
    h_neigh = spmm_csr(indptr, indices, h, num_node=num_node, mean=True)
    return layer.fc_self(h) + layer.fc_neigh(h_neigh)


def _gcn(layer, indptr, indices, h, num_node):
    deg = (indptr[1: num_node + 1] - indptr[:num_node]).to(h.dtype)
    inv_sqrt = (1.0 / torch.sqrt(torch.clamp(deg, min=1.0)))[:, None]
    agg = spmm_csr(indptr, indices, layer.fc(h) * inv_sqrt, num_node=num_node)
    return agg * inv_sqrt + layer.bias


def _gat(layer, indptr, indices, h, num_node):
    heads, d = layer.num_heads, layer.out_dim
    w = layer.kernel.reshape(layer.kernel.shape[0], heads * d)
    feat = (h.to(w.dtype) @ w).reshape(-1, heads, d)
    el = (feat * layer.attn_l).sum(-1)
    er = (feat * layer.attn_r).sum(-1)
    out = gat_aggregate_csr(indptr, indices, feat, el, er, num_node=num_node)
    return out.reshape(num_node, heads * d)


def _layer_fn(layer):
    # PinSAGEConv is a SAGEConv: uniform weights at evaluation
    for cls, fn in ((SAGEConv, _sage), (GCNConv, _gcn), (GATConv, _gat)):
        if isinstance(layer, cls):
            return fn
    raise ValueError(f"full_graph_inference: no full-graph form of "
                     f"{type(layer).__name__} (graphsage, pinsage, gcn and "
                     "gat have one)")


@torch.no_grad()
def full_graph_inference(model, indptr, indices, feat, num_node=None,
                         device=None) -> torch.Tensor:
    """``(num_node, num_class)`` float32 logits of every node by exact
    layer-wise propagation.  ``indptr``, ``indices`` and ``feat`` are
    tensors or numpy arrays (``feat`` float32, or float16 kept so); pass
    ``num_node`` for an ``indptr`` longer than the graph."""
    dev = resolve(device)
    fns = [_layer_fn(layer) for layer in model.layers]
    if num_node is None:
        num_node = indptr.shape[0] - 1
    if not (isinstance(indptr, torch.Tensor) and indptr.dtype == torch.int32):
        # an int32 tensor cannot hold such an offset: nothing to read
        num_edge = int(indptr[num_node])
        if num_edge >= 2**31:
            raise ValueError(
                f"full-graph inference over {num_edge} edges needs >= 2^31 "
                "edge offsets, which the kernels keep int32; run it on a "
                "node-range partition of the graph (offsets rebased per "
                "range) instead")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"full_graph_inference: the model is on "
                             f"{p.device}, the inference on {dev}; move it "
                             "with model.to(...)")
    indptr = to_tensor(indptr, dev, torch.int32)
    indices = to_tensor(indices, dev, torch.int32)
    h = to_tensor(feat, dev, feature_dtype(feat))
    last = len(fns) - 1
    for i, (fn, layer) in enumerate(zip(fns, model.layers)):
        h = fn(layer, indptr, indices, h, num_node)
        if i != last:
            h = model.activation(h)
    return h.float()


def evaluate_full(model, indptr, indices, feat, label, node_set,
                  device=None) -> float:
    """The share of ``node_set`` whose full-graph prediction (the first
    largest logit) is its label."""
    logits = full_graph_inference(model, indptr, indices, feat, device=device)
    pred = torch.argmax(logits, dim=-1)
    sel = to_tensor(node_set, pred.device, torch.long)
    ok = (pred[sel] == to_tensor(label, pred.device)[sel].to(pred.dtype)
          ).sum()
    return float(ok) / len(node_set)

