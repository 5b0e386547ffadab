"""K4: the fanout gather-reduce, ``(sum, denom)`` over a block's picks.

The port of ``xgnn_tpu/models/gnn.py``'s ``fanout_reduce`` (the ``loop``
contract) with its gradient:

- ``sum[i] = sum_k m[i,k] * h_src[neigh[i,k]]`` and ``denom[i] = sum_k
  m[i,k]``, where ``m`` is 1 for a valid pick (in ``[0, N)``; EMPTY is not)
  times ``weights`` when given;
- the gradient w.r.t. ``h_src`` scatter-adds ``m[i,k] * grad_sum[i]`` into
  row ``neigh[i,k]``.  ``denom`` carries none, and weights that require a
  gradient are refused (ROADMAP K4 weight gradient).

The CUDA kernels are ``csrc/fanout.cu``.  :func:`fanout_reduce_plain` and
:func:`fanout_backward_plain` are their plain PyTorch versions, which the
wrappers take only for tensors on the CPU.  An ``h_src`` that needs no
gradient (the feature table on the direct-extract layer) launches no
backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_FWD, _BWD = "fanout_fwd", "fanout_bwd"


def _pick_mask(col: torch.Tensor, num_rows: int, weights_k):
    valid = (col >= 0) & (col < num_rows)
    m = valid.to(torch.float32)[:, None]
    if weights_k is not None:
        m = m * weights_k[:, None]
    return valid, m


def fanout_reduce_plain(h_src: torch.Tensor, neigh: torch.Tensor,
                        weights: Optional[torch.Tensor] = None):
    """K passes of gather and multiply-add, in pick order."""
    n, f = h_src.shape
    d, fanout = neigh.shape
    acc = torch.zeros((d, f), dtype=torch.float32, device=h_src.device)
    denom = torch.zeros((d, 1), dtype=torch.float32, device=h_src.device)
    zero = torch.zeros((), dtype=h_src.dtype, device=h_src.device)
    for k in range(fanout):
        col = neigh[:, k]
        valid, m = _pick_mask(col, n,
                              None if weights is None else weights[:, k])
        rows = torch.where(valid[:, None], h_src[torch.where(valid, col, 0)],
                           zero)
        acc = acc + rows * m
        denom = denom + m
    return acc, denom


def fanout_backward_plain(grad_sum: torch.Tensor, neigh: torch.Tensor,
                          weights: Optional[torch.Tensor], num_rows: int):
    grad_h = torch.zeros((num_rows, grad_sum.shape[1]), dtype=torch.float32,
                         device=grad_sum.device)
    for k in range(neigh.shape[1]):
        col = neigh[:, k]
        valid, m = _pick_mask(
            col, num_rows, None if weights is None else weights[:, k]
        )
        grad_h.index_add_(0, torch.where(valid, col, 0), grad_sum * m)
    return grad_h


def _check(rows, neigh, weights):
    """``rows`` is ``h_src`` for the forward and ``grad_sum`` for the
    backward."""
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise ValueError(
            f"fanout_reduce: rows must be 2-D float32, got {rows.dtype} "
            f"{tuple(rows.shape)}"
        )
    if neigh.dim() != 2 or neigh.dtype != torch.int32:
        raise ValueError(
            f"fanout_reduce: neigh must be 2-D int32, got {neigh.dtype} "
            f"{tuple(neigh.shape)}"
        )
    tensors = [rows, neigh]
    if weights is not None:
        if weights.dtype != torch.float32 or weights.shape != neigh.shape:
            raise ValueError(
                "fanout_reduce: weights must be float32 of neigh's shape"
            )
        if weights.requires_grad:
            raise NotImplementedError(
                "fanout_reduce: no gradient w.r.t. weights yet (ROADMAP K4 "
                "weight gradient)"
            )
        tensors.append(weights)
    if any(t.device != rows.device for t in tensors):
        raise ValueError("fanout_reduce: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fanout_reduce: tensors must be contiguous")
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fanout_reduce: no kernel for {rows.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward(h_src, neigh, weights):
    if h_src.device.type == "cpu":
        return fanout_reduce_plain(h_src, neigh, weights)
    lib = _build.load("fanout")
    d, fanout = neigh.shape
    out = torch.empty((d, h_src.shape[1]), dtype=torch.float32,
                      device=h_src.device)
    denom = torch.empty((d, 1), dtype=torch.float32, device=h_src.device)
    if d:
        rc = lib.xg_fanout_fwd(
            h_src.data_ptr(), neigh.data_ptr(), _ptr(weights), out.data_ptr(),
            denom.data_ptr(), h_src.shape[0], d, fanout, h_src.shape[1],
            _build.stream_handle(h_src.device),
        )
        _build.check(rc, _FWD)
        _build.LAUNCHES.add(_FWD)
    return out, denom


def fanout_backward(grad_sum: torch.Tensor, neigh: torch.Tensor,
                    weights: Optional[torch.Tensor], num_rows: int):
    """The gradient w.r.t. ``h_src`` ``(num_rows, F)`` of
    :func:`fanout_reduce`'s sum, given ``grad_sum`` ``(D, F)``."""
    _check(grad_sum, neigh, weights)
    if grad_sum.device.type == "cpu":
        return fanout_backward_plain(grad_sum, neigh, weights, num_rows)
    lib = _build.load("fanout")
    d, fanout = neigh.shape
    grad_h = torch.zeros((num_rows, grad_sum.shape[1]), dtype=torch.float32,
                         device=grad_sum.device)
    if d:
        rc = lib.xg_fanout_bwd(
            grad_sum.data_ptr(), neigh.data_ptr(), _ptr(weights),
            grad_h.data_ptr(), num_rows, d, fanout, grad_sum.shape[1],
            _build.stream_handle(grad_sum.device),
        )
        _build.check(rc, _BWD)
        _build.LAUNCHES.add(_BWD)
    return grad_h


class _FanoutReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h_src, neigh, weights):
        out, denom = _forward(h_src, neigh, weights)
        ctx.save_for_backward(neigh, weights)
        ctx.num_rows = h_src.shape[0]
        ctx.mark_non_differentiable(denom)
        return out, denom

    @staticmethod
    def backward(ctx, grad_sum, grad_denom):
        del grad_denom
        if not ctx.needs_input_grad[0]:
            return None, None, None
        neigh, weights = ctx.saved_tensors
        return (
            fanout_backward(grad_sum.contiguous(), neigh, weights,
                            ctx.num_rows),
            None,
            None,
        )


def fanout_reduce(h_src: torch.Tensor, neigh: torch.Tensor,
                  weights: Optional[torch.Tensor] = None):
    """``(sum (D, F), denom (D, 1))`` of the valid picks of ``neigh``
    ``(D, K)`` over the rows of ``h_src`` ``(N, F)``."""
    _check(h_src, neigh, weights)
    return _FanoutReduce.apply(h_src, neigh, weights)
