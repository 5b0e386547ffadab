"""K4: the fanout gather-reduce, ``(sum, denom)`` over a block's picks.

The port of ``xgnn_tpu/models/gnn.py``'s ``fanout_reduce`` (the ``loop``
contract) with its gradient:

- ``sum[i] = sum_k m[i,k] * h_src[neigh[i,k]]`` and ``denom[i] = sum_k
  m[i,k]``, where ``m`` is 1 for a valid pick (in ``[0, N)``; EMPTY is not)
  times ``weights`` when given;
- the gradient w.r.t. ``h_src`` adds ``m[i,k] * grad_sum[i]`` into row
  ``neigh[i,k]``.  ``denom`` carries none, and weights that require a
  gradient are refused (ROADMAP K4 weight gradient).

A local-id block's dst rows are the prefix ``h_src[:D]`` of its src rows
(``_take_dst`` in the JAX package).  :func:`prefix_fanout_reduce` returns
that prefix with the sum, so the gradient w.r.t. ``h_src`` of both is one
backward pass, which adds ``grad_dst`` into rows ``r < D``: autograd then
builds no zero-filled slice gradient and adds nothing after the kernel.

The CUDA kernels are ``csrc/fanout.cu``; the backward sums each src row in
ascending ``k``, then ascending ``i``, without atomics, so its result is the
same from run to run.  :func:`fanout_reduce_plain` and
:func:`fanout_backward_plain` are their plain PyTorch versions, which the
wrappers take only for tensors on the CPU.  An ``h_src`` that needs no
gradient (the feature table on the direct-extract layer) launches no
backward.  Launches are counted as ``fanout_fwd`` and ``fanout_bwd``, one
each per call of the forward and of the backward.
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
                          weights: Optional[torch.Tensor], num_rows: int,
                          grad_dst: Optional[torch.Tensor] = None):
    """K ``index_add_`` passes in pick order, then ``grad_dst`` into the
    prefix.  On the CPU ``index_add_`` adds in index order, so every row is
    summed in ascending ``k``, then ascending ``i``, as the kernel sums it."""
    grad_h = torch.zeros((num_rows, grad_sum.shape[1]), dtype=torch.float32,
                         device=grad_sum.device)
    for k in range(neigh.shape[1]):
        col = neigh[:, k]
        valid, m = _pick_mask(
            col, num_rows, None if weights is None else weights[:, k]
        )
        grad_h.index_add_(0, torch.where(valid, col, 0), grad_sum * m)
    if grad_dst is not None:
        grad_h[: grad_dst.shape[0]] += grad_dst
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


def _scratch_len(num_rows: int, num_picks: int) -> int:
    """int32 scratch of the backward, as ``xg_fanout_bwd`` lays it out:
    counts and the long-row count, offsets, one sum per 1024 rows, the
    pick keys by src row, the long-row list (rows of more than 32 picks)."""
    return (2 * num_rows + 2 + -(-num_rows // 1024) + num_picks
            + num_picks // 33 + 1)


def fanout_backward(grad_sum: torch.Tensor, neigh: torch.Tensor,
                    weights: Optional[torch.Tensor], num_rows: int,
                    grad_dst: Optional[torch.Tensor] = None):
    """The gradient w.r.t. ``h_src`` ``(num_rows, F)`` of
    :func:`fanout_reduce`'s sum, given ``grad_sum`` ``(D, F)``, plus
    ``grad_dst`` ``(D, F)`` in rows ``< D`` when given (the gradient of the
    prefix :func:`prefix_fanout_reduce` returns)."""
    _check(grad_sum, neigh, weights)
    d, fanout = neigh.shape
    width = grad_sum.shape[1]
    if grad_sum.shape[0] != d:
        raise ValueError(f"fanout_backward: grad_sum has {grad_sum.shape[0]} "
                         f"rows for {d} dst rows")
    if grad_dst is not None:
        if (grad_dst.dtype != torch.float32 or grad_dst.shape != (d, width)
                or grad_dst.device != grad_sum.device
                or not grad_dst.is_contiguous()):
            raise ValueError(
                f"fanout_backward: grad_dst must be contiguous float32 "
                f"{(d, width)} on {grad_sum.device}"
            )
        if d > num_rows:
            raise ValueError(f"fanout_backward: a prefix of {d} rows of "
                             f"{num_rows}")
    if grad_sum.device.type == "cpu":
        return fanout_backward_plain(grad_sum, neigh, weights, num_rows,
                                     grad_dst)
    lib = _build.load("fanout")
    grad_h = torch.empty((num_rows, width), dtype=torch.float32,
                         device=grad_sum.device)
    if num_rows and width:
        n_scratch = _scratch_len(num_rows, d * fanout)
        scratch = torch.empty((n_scratch,), dtype=torch.int32,
                              device=grad_sum.device)
        rc = lib.xg_fanout_bwd(
            grad_sum.data_ptr(), neigh.data_ptr(), _ptr(weights),
            _ptr(grad_dst), grad_h.data_ptr(), scratch.data_ptr(), n_scratch,
            num_rows, d, fanout, width, _build.stream_handle(grad_sum.device),
        )
        _build.check(rc, _BWD)
        _build.LAUNCHES.add(_BWD)
    return grad_h


class _FanoutReduce(torch.autograd.Function):
    """``(sum, denom)``, or ``(h_src[:D], sum, denom)`` with ``prefix``."""

    @staticmethod
    def forward(ctx, h_src, neigh, weights, prefix):
        out, denom = _forward(h_src, neigh, weights)
        ctx.save_for_backward(neigh, weights)
        ctx.num_rows = h_src.shape[0]
        ctx.prefix = prefix
        ctx.mark_non_differentiable(denom)
        if prefix:
            # a view, not a copy: autograd makes a view that a custom
            # Function returns an output of this node (and refuses in-place
            # changes to it), so its gradient arrives in backward below
            return h_src.narrow(0, 0, neigh.shape[0]), out, denom
        return out, denom

    @staticmethod
    def backward(ctx, *grads):
        # autograd materialises the gradient of an unused output as zeros,
        # so none of these is None
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if ctx.prefix:
            grad_dst, grad_sum = grads[0].contiguous(), grads[1]
        else:
            grad_dst, grad_sum = None, grads[0]
        neigh, weights = ctx.saved_tensors
        grad_h = fanout_backward(grad_sum.contiguous(), neigh, weights,
                                 ctx.num_rows, grad_dst)
        return grad_h, None, None, None


def fanout_reduce(h_src: torch.Tensor, neigh: torch.Tensor,
                  weights: Optional[torch.Tensor] = None):
    """``(sum (D, F), denom (D, 1))`` of the valid picks of ``neigh``
    ``(D, K)`` over the rows of ``h_src`` ``(N, F)``."""
    _check(h_src, neigh, weights)
    return _FanoutReduce.apply(h_src, neigh, weights, False)


def prefix_fanout_reduce(h_src: torch.Tensor, neigh: torch.Tensor,
                         weights: Optional[torch.Tensor] = None):
    """``(h_dst (D, F), sum (D, F), denom (D, 1))`` for a local-id block:
    ``h_dst`` is the prefix ``h_src[:D]`` (a view), and the gradient
    w.r.t. ``h_src`` of ``h_dst`` and ``sum`` together is one backward
    launch."""
    _check(h_src, neigh, weights)
    if neigh.shape[0] > h_src.shape[0]:
        raise ValueError(f"prefix_fanout_reduce: {neigh.shape[0]} dst rows "
                         f"are not a prefix of {h_src.shape[0]} src rows")
    return _FanoutReduce.apply(h_src, neigh, weights, True)
