"""GraphSAGE over dense-fanout sampled blocks.

The port of the GraphSAGE path of ``xgnn_tpu/models/gnn.py``:
``masked_mean_stream`` and ``_take_dst`` (together in :func:`_dst_and_mean`),
``SAGEConv`` and ``GNN`` (dropout before every layer but the first, ReLU
between layers, float32 logits).  The fanout reduce is kernel K4
(``ops/fanout.py``) and the direct-extract dst gather is kernel K1
(``ops/gather.py``).  The other convolutions of the zoo are ROADMAP open
item 9.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.fanout import fanout_reduce, prefix_fanout_reduce
from ..ops.gather import gather_rows
from ..types import Block


def _dst_and_mean(block: Block, h_src: torch.Tensor, weights=None):
    """``(h_dst, h_neigh)``: the dst rows of a block and the masked mean of
    its picks.  A local-id block's dst rows are the prefix
    ``h_src[:dst_cap]``, which K4 returns with the sum so that the gradient
    w.r.t. ``h_src`` is one backward launch; a direct-extract block gathers
    them by global id with zero rows for EMPTY (``Block.dst_ids``, K1)."""
    if block.dst_ids is None:
        h_dst, s, denom = prefix_fanout_reduce(h_src, block.neigh, weights)
    else:
        h_dst = gather_rows(h_src, block.dst_ids)
        s, denom = fanout_reduce(h_src, block.neigh, weights)
    return h_dst, s / torch.clamp(denom, min=1e-9)


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's default Dense kernel init: variance_scaling(1, fan_in,
    truncated_normal), a normal truncated at two standard deviations whose
    spread is corrected back to ``1/sqrt(fan_in)``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class Dense(nn.Module):
    """``x @ weight.T + bias``, allocated without drawing from the global
    random stream (``reset_parameters`` of the owner fills it)."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool):
        super().__init__()
        self.in_features = in_dim
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, self.weight, self.bias)


class SAGEConv(nn.Module):
    """GraphSAGE mean aggregator: ``W_self h_dst + W_neigh mean(h_N) + b``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc_self = Dense(in_dim, out_dim, bias=False)
        self.fc_neigh = Dense(in_dim, out_dim, bias=True)

    def reset_parameters(self, generator: torch.Generator):
        in_dim = self.fc_self.in_features
        with torch.no_grad():
            _lecun_normal_(self.fc_self.weight, in_dim, generator)
            _lecun_normal_(self.fc_neigh.weight, in_dim, generator)
            self.fc_neigh.bias.zero_()

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        h_dst, h_neigh = _dst_and_mean(block, h_src)
        return self.fc_self(h_dst) + self.fc_neigh(h_neigh)


def apply_dropout(h: torch.Tensor, p: float, generator: torch.Generator):
    """flax ``nn.Dropout``: keep with probability ``1 - p`` and scale by
    ``1 / (1 - p)``; the mask comes from ``generator``."""
    if p <= 0.0:
        return h
    if p >= 1.0:
        return torch.zeros_like(h)
    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - p
    return torch.where(keep, h / (1.0 - p), torch.zeros((), device=h.device))


class GNN(nn.Module):
    """Multi-layer GraphSAGE over blocks ordered outermost first."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, dropout: float = 0.5):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1]) for i in range(num_layers)
        )
        self.dropout = dropout

    def reset_parameters(self, generator: torch.Generator):
        for layer in self.layers:
            layer.reset_parameters(generator)

    def forward(self, blocks: Sequence[Block], x: torch.Tensor,
                train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            if i != 0 and train:
                h = apply_dropout(h, self.dropout, generator)
            h = layer(blocks[i], h)
            if i != last:
                h = torch.relu(h)
        return h.float()


def build_model(config, feat_dim: int, num_class: int,
                generator: Optional[torch.Generator] = None) -> GNN:
    """The config's model with flax-style initial weights drawn from
    ``generator`` (a CPU generator; move the model to its device after)."""
    if config.model != "graphsage":
        raise NotImplementedError(
            f"model {config.model!r}: ROADMAP open item 9 (model zoo)"
        )
    model = GNN(feat_dim, config.num_hidden, num_class, config.num_layer,
                dropout=config.dropout)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    model.reset_parameters(generator)
    return model
