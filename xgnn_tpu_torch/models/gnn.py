"""GraphSAGE, PinSAGE, GCN, GAT and MLP over dense-fanout sampled blocks.

The port of ``xgnn_tpu/models/gnn.py``'s ``_take_dst``,
``masked_mean_stream`` (with the dst rows in :func:`_dst_and_mean`),
``SAGEConv``, ``PinSAGEConv``, ``GCNConv``, ``GATConv``, ``MLPConv`` and
``GNN`` (dropout before every layer but the first, ELU between GAT layers
and ReLU between the others, float32 logits).  The fanout reduce is kernel
K4 (``ops/fanout.py``: its mean form for SAGE and PinSAGE, whose visit
counts ride on it as per-pick weights, its sum form for GCN), the
direct-extract dst gather kernel K1 (``ops/gather.py``),
GCN's pick multiplicity kernel K7 (``ops/degree.py``) and GAT's
edge-softmax aggregate kernel K5 (``ops/attend.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.attend import PER_HEAD, SHARED, gat_attend, gat_attend_prefix
from ..ops.degree import pick_multiplicity
from ..ops.fanout import fanout_reduce, masked_mean, prefix_masked_mean
from ..ops.gather import gather_rows
from ..types import Block


def _take_dst(block: Block, h_src: torch.Tensor) -> torch.Tensor:
    """The dst rows of a block: the prefix of ``h_src`` (a local-id block)
    or a gather by global id with zero rows for EMPTY (a direct-extract
    block, K1)."""
    if block.dst_ids is None:
        return h_src[: block.dst_cap]
    return gather_rows(h_src, block.dst_ids)


def _dst_and_mean(block: Block, h_src: torch.Tensor, weights=None):
    """``(h_dst, h_neigh)``: the dst rows of a block and the masked mean of
    its picks (``masked_mean_stream``, one K4 launch with its division).  A
    local-id block's dst rows are the prefix ``h_src[:dst_cap]``, which K4
    returns with the mean so that the gradient w.r.t. ``h_src`` is one
    backward launch; a direct-extract block gathers them by global id with
    zero rows for EMPTY (``Block.dst_ids``, K1)."""
    if block.dst_ids is None:
        h_dst, h_neigh, _ = prefix_masked_mean(h_src, block.neigh, weights)
    else:
        h_dst = _take_dst(block, h_src)
        h_neigh, _ = masked_mean(h_src, block.neigh, weights)
    return h_dst, h_neigh


def _lecun_normal_(w: torch.Tensor, fan_in: int, generator: torch.Generator):
    """flax's ``lecun_normal``: variance_scaling(1, fan_in,
    truncated_normal), a normal truncated at two standard deviations whose
    spread is corrected back to ``1/sqrt(fan_in)``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def _glorot_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                     generator: torch.Generator):
    """flax's ``glorot_uniform``: uniform in ``+-sqrt(6 / (fan_in +
    fan_out))``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(w, -limit, limit, generator=generator)


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


class PinSAGEConv(SAGEConv):
    """SAGE aggregation weighted by the random walk's visit counts
    (``block.weights``, which need no gradient)."""

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        h_dst, h_neigh = _dst_and_mean(block, h_src, block.weights)
        return self.fc_self(h_dst) + self.fc_neigh(h_neigh)


class GCNConv(nn.Module):
    """Graph convolution with the symmetric norm over the sampled block
    (DGL ``GraphConv(norm='both')``): ``b + deg_dst^-1/2 sum_k
    cnt_k^-1/2 h_k W``, where ``cnt_k`` is the multiplicity of pick k's id
    in the block (K7) and rides K4's per-pick weights.  The transform runs
    first when it narrows the rows (``in > out``, the logits), else after
    the aggregate.  No activation inside: ``GNN`` applies it."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = Dense(in_dim, out_dim, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            _lecun_normal_(self.fc.weight, self.fc.in_features, generator)
            self.bias.zero_()

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        neigh, n = block.neigh, h_src.shape[0]
        cnt = pick_multiplicity(neigh, n)
        w = torch.rsqrt(torch.clamp(cnt.to(torch.float32), min=1.0))
        in_deg = ((neigh >= 0) & (neigh < n)).sum(1).to(torch.float32)
        if h_src.shape[1] > self.bias.shape[0]:
            agg, _ = fanout_reduce(self.fc(h_src), neigh, w)
        else:
            agg, _ = fanout_reduce(h_src, neigh, w)
            agg = self.fc(agg)
        agg = agg * (1.0 / torch.sqrt(torch.clamp(in_deg, min=1.0)))[:, None]
        return agg + self.bias


class GATConv(nn.Module):
    """Graph attention (DGL ``GATConv``) over a block's picks.  The score
    projections fold into the kernel (``wl = kernel . attn_l`` per head, so
    ``el_dst = h_dst @ wl``), and the edge softmax and weighted sum are one
    pass of K5.  When ``in > H*d`` the table is transformed first and K5
    attends per head over its slices; otherwise K5 aggregates the
    input-width rows for every head (shared mode) and the transform runs
    over the dst rows only.  The JAX package's contraction and per-pick
    forms of that second case, and ``gat_select_path`` choosing among
    them, shape the same function for the TPU; the port has K5's one form
    (ROADMAP section 3).  On a local-id block in shared mode K5 forms
    ``el_dst`` from the prefix ``h_src[:D]`` itself
    (``gat_attend_prefix``), so the prefix's gradient joins the table's in
    one sum.  Output ``(D, H*d)``, head-major."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int = 1):
        super().__init__()
        self.num_heads, self.out_dim = num_heads, out_dim
        self.kernel = nn.Parameter(torch.empty(in_dim, num_heads, out_dim))
        self.attn_l = nn.Parameter(torch.empty(num_heads, out_dim))
        self.attn_r = nn.Parameter(torch.empty(num_heads, out_dim))

    def reset_parameters(self, generator: torch.Generator):
        in_dim, h, d = self.kernel.shape
        with torch.no_grad():
            # flax's lecun_normal over (in, H, d) takes fan_in = H * in
            _lecun_normal_(self.kernel, h * in_dim, generator)
            _glorot_uniform_(self.attn_l, h, d, generator)
            _glorot_uniform_(self.attn_r, h, d, generator)

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        h, d = self.num_heads, self.out_dim
        in_dim = h_src.shape[1]
        wl = torch.einsum("ihd,hd->ih", self.kernel, self.attn_l)
        if in_dim > h * d:
            feat = h_src @ self.kernel.reshape(in_dim, h * d)
            out = gat_attend(feat, block.neigh, _take_dst(block, h_src) @ wl,
                             self.attn_r.contiguous(), PER_HEAD)
            return out.reshape(block.dst_cap, h * d)
        wr = torch.einsum("ihd,hd->ih", self.kernel, self.attn_r).contiguous()
        if block.dst_ids is None:
            agg = gat_attend_prefix(h_src, block.neigh, wl.contiguous(), wr)
        else:
            agg = gat_attend(h_src, block.neigh, _take_dst(block, h_src) @ wl,
                             wr, SHARED)
        out = torch.einsum("bhi,ihd->bhd", agg, self.kernel)
        return out.reshape(block.dst_cap, h * d)


class MLPConv(nn.Module):
    """The feature-only control: ``W h_dst + b``, the sampled neighbours
    ignored."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc = Dense(in_dim, out_dim, bias=True)

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            _lecun_normal_(self.fc.weight, self.fc.in_features, generator)
            self.fc.bias.zero_()

    def forward(self, block: Block, h_src: torch.Tensor) -> torch.Tensor:
        return self.fc(_take_dst(block, h_src))


def apply_dropout(h: torch.Tensor, p: float, generator: torch.Generator):
    """flax ``nn.Dropout``: keep with probability ``1 - p`` and scale by
    ``1 / (1 - p)``; the mask comes from ``generator``."""
    if p <= 0.0:
        return h
    if p >= 1.0:
        return torch.zeros_like(h)
    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - p
    return torch.where(keep, h / (1.0 - p), torch.zeros((), device=h.device))


_CONVS = {"graphsage": SAGEConv, "gcn": GCNConv, "gat": GATConv,
          "pinsage": PinSAGEConv, "mlp": MLPConv}


class GNN(nn.Module):
    """A multi-layer GNN of one convolution over blocks ordered outermost
    first.  GAT puts ``num_heads`` heads of ``hidden_dim // num_heads`` on
    the hidden layers and one head on the logits."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 num_layers: int, dropout: float = 0.5,
                 conv: str = "graphsage", num_heads: int = 1):
        super().__init__()
        layers, width = [], in_dim
        for i in range(num_layers):
            last = i == num_layers - 1
            if conv == "gat":
                heads = 1 if last else num_heads
                dim = out_dim if last else hidden_dim // max(num_heads, 1)
                layers.append(GATConv(width, dim, heads))
                width = heads * dim
            else:
                dim = out_dim if last else hidden_dim
                layers.append(_CONVS[conv](width, dim))
                width = dim
        self.layers = nn.ModuleList(layers)
        self.dropout = dropout
        self.activation = (nn.functional.elu if conv == "gat"
                           else torch.relu)

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
                h = self.activation(h)
        return h.float()


def build_model(config, feat_dim: int, num_class: int,
                generator: Optional[torch.Generator] = None) -> GNN:
    """The config's model with flax-style initial weights drawn from
    ``generator`` (a CPU generator; move the model to its device after).
    PinSAGE has ``num_layer_pinsage`` layers, the others ``num_layer``."""
    num_layers = (config.num_layer_pinsage if config.model == "pinsage"
                  else config.num_layer)
    model = GNN(feat_dim, config.num_hidden, num_class, num_layers,
                dropout=config.dropout, conv=config.model,
                num_heads=config.num_head)
    if generator is None:
        generator = torch.Generator().manual_seed(config.seed)
    model.reset_parameters(generator)
    return model
