"""K4: the fanout gather-reduce over a block's picks, as a sum or a mean.

The port of ``xgnn_tpu/models/gnn.py``'s ``fanout_reduce`` (the ``loop``
contract) and ``masked_mean_stream``, with their gradients:

- ``sum[i] = sum_k m[i,k] * h_src[neigh[i,k]]`` and ``denom[i] = sum_k
  m[i,k]``, where ``m`` is 1 for a valid pick (in ``[0, N)``; EMPTY is not)
  times ``weights`` when given; the mean form returns
  ``sum[i] / max(denom[i], 1e-9)`` in place of the sum, divided in the
  kernel, so the sum never reaches device memory;
- the gradient w.r.t. ``h_src`` adds ``m[i,k] * grad[i]`` into row
  ``neigh[i,k]``, where ``grad`` is the sum's gradient, or the mean's
  divided by ``max(denom[i], 1e-9)``.  ``denom`` carries none, and weights
  that require a gradient are refused (ROADMAP K4 weight gradient).
  The kernel (:func:`segment_sum`) and :func:`fanout_backward_plain` also
  take a rank-1 term: per-pick scalars ``c`` and one row ``u`` add ``(sum
  of c over row r's picks) * u`` to row ``r``.  K5 (``ops/attend.py``)
  sums its table's gradient at one head so.

``h_src`` may be bfloat16 (layer 0 under ``feat_dtype`` or
``compute_dtype`` "bfloat16") or float16 (layer 0 over an F16 feature file
under ``compute_dtype`` "float32", whose values JAX's ``astype`` gives
exactly): the rows are read in their 2-byte type and summed in float32, so
the sum, the mean and ``denom`` are float32, as in the JAX loop, K14
(``ops/fanout.fanout_reduce_tiled``) and the chunked form.  Such a source
is layer 0's input and needs no gradient: the forward refuses one that
requires it.

A local-id block's dst rows are the prefix ``h_src[:D]`` of its src rows
(``_take_dst`` in the JAX package).  :func:`prefix_fanout_reduce` and
:func:`prefix_masked_mean` return that prefix with the sum or the mean, so
the gradient w.r.t. ``h_src`` of both is one backward pass, which adds
``grad_dst`` into rows ``r < D``: autograd then builds no zero-filled slice
gradient and adds nothing after the kernel.

The CUDA kernels are ``csrc/fanout.cu``; the backward sums each src row in
ascending ``k``, then ascending ``i``, then adds the rank-1 term and then
the prefix's gradient, without atomics, so its result is the same from run
to run.  :func:`fanout_reduce_plain`,
:func:`masked_mean_plain` and :func:`fanout_backward_plain` are their plain
PyTorch versions, which the wrappers take only for tensors on the CPU.
When ``h_src`` needs no gradient (the feature table on the direct-extract
layer, or under ``torch.no_grad``) the forward launches its kernel without
``autograd.Function`` and no backward follows.  Launches are counted as
``fanout_fwd`` (``fanout_fwd_bf16`` and ``fanout_fwd_f16`` over a
bfloat16 and a float16 table) and
``fanout_bwd``, one each per call of the forward (either form) and of the
backward.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_FWD, _BWD = "fanout_fwd", "fanout_bwd"
# the forward's launch names and element codes (csrc/fanout.cu's Elem) by
# the table's type
_FWD_FORMS = {torch.float32: (_FWD, 0),
              torch.bfloat16: ("fanout_fwd_bf16", 1),
              torch.float16: ("fanout_fwd_f16", 2)}
MEAN_EPS = 1e-9  # masked_mean_stream's floor under the denominator
_lib = None


def _library():
    global _lib
    if _lib is None:
        _lib = _build.load("fanout")
    return _lib


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


def masked_mean_plain(h_src: torch.Tensor, neigh: torch.Tensor,
                      weights: Optional[torch.Tensor] = None):
    """``masked_mean_stream``: the plain sum over ``max(denom, 1e-9)``."""
    s, denom = fanout_reduce_plain(h_src, neigh, weights)
    return s / torch.clamp(denom, min=MEAN_EPS), denom


def fanout_backward_plain(grad_sum: torch.Tensor, neigh: torch.Tensor,
                          weights: Optional[torch.Tensor], num_rows: int,
                          grad_dst: Optional[torch.Tensor] = None,
                          denom: Optional[torch.Tensor] = None,
                          c: Optional[torch.Tensor] = None,
                          u: Optional[torch.Tensor] = None):
    """K ``index_add_`` passes in pick order, then the rank-1 term ``(sum
    of c over the row's picks) * u`` when ``c`` is given, then ``grad_dst``
    into the prefix; with ``denom`` (the mean form's gradient) ``grad_sum``
    is first divided by ``max(denom, 1e-9)``, as autograd divides it
    through the plain mean.  On the CPU ``index_add_`` adds in index order,
    so every row is summed in ascending ``k``, then ascending ``i``, as the
    kernel sums it; ``c`` rides as one more column of the same passes, so
    its sums run in that order too."""
    if denom is not None:
        grad_sum = grad_sum / torch.clamp(denom, min=MEAN_EPS)
    width = grad_sum.shape[1]
    extra = int(c is not None)
    grad_h = torch.zeros((num_rows, width + extra), dtype=torch.float32,
                         device=grad_sum.device)
    for k in range(neigh.shape[1]):
        col = neigh[:, k]
        valid, m = _pick_mask(
            col, num_rows, None if weights is None else weights[:, k]
        )
        src = grad_sum * m
        if extra:
            src = torch.cat([src, torch.where(valid, c[:, k], 0.0)[:, None]],
                            1)
        grad_h.index_add_(0, torch.where(valid, col, 0), src)
    if extra:
        grad_h = grad_h[:, :width] + grad_h[:, width:] * u
    if grad_dst is not None:
        grad_h[: grad_dst.shape[0]] += grad_dst
    return grad_h


def _check(rows, neigh, weights, dtypes=(torch.float32,)):
    """``rows`` is ``h_src`` for the forward (float32, bfloat16 or
    float16) and ``grad_sum`` for the backward (float32)."""
    if rows.dim() != 2 or rows.dtype not in dtypes:
        raise ValueError(
            f"fanout_reduce: rows must be 2-D {' or '.join(map(str, dtypes))},"
            f" got {rows.dtype} {tuple(rows.shape)}"
        )
    if neigh.dim() != 2 or neigh.dtype != torch.int32:
        raise ValueError(
            f"fanout_reduce: neigh must be 2-D int32, got {neigh.dtype} "
            f"{tuple(neigh.shape)}"
        )
    dev = rows.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fanout_reduce: no kernel for {dev}")
    if neigh.device != dev:
        raise ValueError("fanout_reduce: tensors on different devices")
    if not (rows.is_contiguous() and neigh.is_contiguous()):
        raise ValueError("fanout_reduce: tensors must be contiguous")
    if weights is not None:
        if (weights.dtype != torch.float32 or weights.shape != neigh.shape
                or weights.device != dev or not weights.is_contiguous()):
            raise ValueError("fanout_reduce: weights must be contiguous "
                             "float32 of neigh's shape on its device")
        if weights.requires_grad:
            raise NotImplementedError(
                "fanout_reduce: no gradient w.r.t. weights yet (ROADMAP K4 "
                "weight gradient)"
            )


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _forward(h_src, neigh, weights, mean: bool):
    """``(out (D, F), denom (D, 1))``: the sum, or with ``mean`` the masked
    mean."""
    if h_src.device.type == "cpu":
        plain = masked_mean_plain if mean else fanout_reduce_plain
        return plain(h_src, neigh, weights)
    d, fanout = neigh.shape
    f = h_src.shape[1]
    dev = h_src.device
    # two allocations: one shared by two views took more host time
    # (tools/time_fanout.py)
    out = torch.empty((d, f), dtype=torch.float32, device=dev)
    denom = torch.empty((d, 1), dtype=torch.float32, device=dev)
    if d:
        name, elem = _FWD_FORMS[h_src.dtype]
        rc = _library().xg_fanout_fwd(
            h_src.data_ptr(), neigh.data_ptr(), _ptr(weights), out.data_ptr(),
            denom.data_ptr(), h_src.shape[0], d, fanout, f, int(mean), elem,
            _build.stream_handle(dev),
        )
        _build.check(rc, name)
        _build.LAUNCHES.add(name)
    return out, denom


def _scratch_len(num_rows: int, num_picks: int) -> int:
    """int32 scratch of the backward, as ``xg_fanout_bwd`` lays it out:
    counts and the long-row count, offsets, one sum per 1024 rows, the
    pick keys by src row, the long-row list (rows of more than 32 picks)."""
    return (2 * num_rows + 2 + -(-num_rows // 1024) + num_picks
            + num_picks // 33 + 1)


def fanout_backward(grad_sum: torch.Tensor, neigh: torch.Tensor,
                    weights: Optional[torch.Tensor], num_rows: int,
                    grad_dst: Optional[torch.Tensor] = None,
                    denom: Optional[torch.Tensor] = None):
    """The gradient w.r.t. ``h_src`` ``(num_rows, F)`` of
    :func:`fanout_reduce`'s sum, given ``grad_sum`` ``(D, F)``, plus
    ``grad_dst`` ``(D, F)`` in rows ``< D`` when given (the gradient of the
    prefix :func:`prefix_fanout_reduce` returns).  With ``denom`` ``(D, 1)``,
    the forward's, ``grad_sum`` is the gradient of :func:`masked_mean`'s
    mean, divided by ``max(denom, 1e-9)`` in the kernel as it is read."""
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
    if denom is not None and (
            denom.dtype != torch.float32 or denom.numel() != d
            or denom.device != grad_sum.device or not denom.is_contiguous()):
        raise ValueError(f"fanout_backward: denom must be contiguous float32 "
                         f"with {d} entries on {grad_sum.device}")
    if grad_sum.device.type == "cpu":
        return fanout_backward_plain(grad_sum, neigh, weights, num_rows,
                                     grad_dst, denom)
    grad_h = segment_sum(grad_sum, neigh, weights, num_rows, grad_dst, denom)
    if num_rows and width:
        _build.LAUNCHES.add(_BWD)
    return grad_h


def segment_sum(grad_sum, neigh, weights, num_rows: int, grad_dst=None,
                denom=None, c=None, u=None):
    """:func:`fanout_backward`'s kernel on checked CUDA tensors, without
    its launch count: K5's backward sums its table's gradient with it and
    counts that launch as its own.  ``grad_dst`` ``(P, F)``, ``P <=
    num_rows``, goes into rows ``< P`` (K5 at several heads passes its
    picks as ``D * K`` rows of one pick, and its prefix is ``D`` rows).
    With ``c`` ``(D, K)`` and ``u`` ``(F,)`` (not with ``denom``), row ``r``
    also gets ``(sum of c over its picks) * u``, before ``grad_dst``: the
    rank-1 term of ``fanout_backward_plain``."""
    d, fanout = neigh.shape
    width = grad_sum.shape[1]
    grad_h = torch.empty((num_rows, width), dtype=torch.float32,
                         device=grad_sum.device)
    if num_rows and width:
        n_scratch = _scratch_len(num_rows, d * fanout)
        scratch = torch.empty((n_scratch,), dtype=torch.int32,
                              device=grad_sum.device)
        rc = _library().xg_fanout_bwd(
            grad_sum.data_ptr(), neigh.data_ptr(), _ptr(weights),
            _ptr(grad_dst), _ptr(denom), _ptr(c), _ptr(u), grad_h.data_ptr(),
            scratch.data_ptr(), n_scratch, num_rows, d, fanout, width,
            0 if grad_dst is None else grad_dst.shape[0],
            _build.stream_handle(grad_sum.device),
        )
        _build.check(rc, _BWD)
    return grad_h


class _FanoutReduce(torch.autograd.Function):
    """``(out, denom)``, or ``(h_src[:D], out, denom)`` with ``prefix``;
    ``out`` is the sum, or with ``mean`` the masked mean."""

    @staticmethod
    def forward(ctx, h_src, neigh, weights, prefix, mean):
        out, denom = _forward(h_src, neigh, weights, mean)
        ctx.save_for_backward(neigh, weights, denom if mean else None)
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
            return None, None, None, None, None
        if ctx.prefix:
            grad_dst, grad_out = grads[0].contiguous(), grads[1]
        else:
            grad_dst, grad_out = None, grads[0]
        neigh, weights, denom = ctx.saved_tensors
        grad_h = fanout_backward(grad_out.contiguous(), neigh, weights,
                                 ctx.num_rows, grad_dst, denom)
        return grad_h, None, None, None, None


def _reduce(h_src, neigh, weights, prefix: bool, mean: bool):
    _check(h_src, neigh, weights, tuple(_FWD_FORMS))
    if prefix and neigh.shape[0] > h_src.shape[0]:
        raise ValueError(f"fanout_reduce: {neigh.shape[0]} dst rows are not "
                         f"a prefix of {h_src.shape[0]} src rows")
    if h_src.requires_grad and torch.is_grad_enabled():
        if h_src.dtype != torch.float32:
            raise NotImplementedError(
                f"fanout_reduce: no gradient w.r.t. a {h_src.dtype} source "
                "(layer 0's table or extracted rows need none, in JAX too)")
        return _FanoutReduce.apply(h_src, neigh, weights, prefix, mean)
    # no gradient to track: the launch alone, without autograd's wrapping
    out, denom = _forward(h_src, neigh, weights, mean)
    if prefix:
        return h_src.narrow(0, 0, neigh.shape[0]), out, denom
    return out, denom


def fanout_reduce(h_src: torch.Tensor, neigh: torch.Tensor,
                  weights: Optional[torch.Tensor] = None):
    """``(sum (D, F), denom (D, 1))`` of the valid picks of ``neigh``
    ``(D, K)`` over the rows of ``h_src`` ``(N, F)``."""
    return _reduce(h_src, neigh, weights, False, False)


def masked_mean(h_src: torch.Tensor, neigh: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
    """``(mean (D, F), denom (D, 1))``: JAX's ``masked_mean_stream``, the
    sum of :func:`fanout_reduce` over ``max(denom, 1e-9)`` in one launch."""
    return _reduce(h_src, neigh, weights, False, True)


def prefix_fanout_reduce(h_src: torch.Tensor, neigh: torch.Tensor,
                         weights: Optional[torch.Tensor] = None):
    """``(h_dst (D, F), sum (D, F), denom (D, 1))`` for a local-id block:
    ``h_dst`` is the prefix ``h_src[:D]`` (a view), and the gradient
    w.r.t. ``h_src`` of ``h_dst`` and ``sum`` together is one backward
    launch."""
    return _reduce(h_src, neigh, weights, True, False)


def prefix_masked_mean(h_src: torch.Tensor, neigh: torch.Tensor,
                       weights: Optional[torch.Tensor] = None):
    """``(h_dst (D, F), mean (D, F), denom (D, 1))``: ``_take_dst`` and
    ``masked_mean_stream`` of a local-id block, as
    :func:`prefix_fanout_reduce` with the mean."""
    return _reduce(h_src, neigh, weights, True, True)
