"""K2: uniform neighbour sampling without replacement (khop0, khop2, khop3).

The port of ``xgnn_tpu/ops/sampling.py``'s ``_frontier_meta`` and
``sample_khop0``.  The reference's khop0, khop2 and khop3 all draw a uniform
K-subset of the neighbours (all of them when ``deg <= K``), so the three
share one partial Fisher-Yates.  Each call maps a padded frontier ``(B,)``
to a neighbour matrix ``(B, K)`` with ``EMPTY_KEY`` padding, with static
shapes and no host sync.

Given the same uniforms ``u`` the picks equal the JAX package's exactly:
the draw ``t = j + min(floor(u[:, j] * span), span - 1)`` is computed in
float32 as there.

The CUDA kernel is ``csrc/sampling.cu``.  :func:`sample_khop0_plain` is its
plain PyTorch version: the wrapper takes it only for tensors on the CPU.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as C
from . import _build

EMPTY = C.EMPTY_KEY
_NAME = "sample_khop"
MAX_FANOUT = 64  # the kernel keeps at most this many records per row


def _frontier_meta(indptr: torch.Tensor, frontier: torch.Tensor):
    """Per-node CSR slice ``(start, deg)``; EMPTY entries get degree 0."""
    valid = frontier != EMPTY
    node = torch.where(valid, frontier, 0)
    start = indptr[node]
    deg = torch.where(valid, indptr[node + 1] - start, 0)
    return node, start, deg, valid


def sample_khop0_plain(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Partial Fisher-Yates over the virtual array ``A = [0..deg)``: at step
    ``j`` draw ``t`` in ``[j, deg)``, emit ``A[t]`` and set ``A[t] = A[j]``.
    Only displaced entries are recorded, at most ``K`` of them, so each pick
    is resolved by a scan over the records.

    ``u``: ``(B, fanout)`` float32 uniforms; drawn from ``generator`` when
    not given.
    """
    b = frontier.shape[0]
    _, start, deg, _ = _frontier_meta(indptr, frontier)
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)

    rec_pos = []  # displaced positions, one per step
    rec_val = []  # the value stored at that position
    picks = []

    def lookup(x):
        v = x
        for p, w in zip(rec_pos, rec_val):
            v = torch.where(x == p, w, v)
        return v

    for j in range(fanout):
        span = torch.clamp(deg - j, min=1)
        # float32 u times int32 span stays float32, as in the JAX kernel
        t = j + torch.minimum(torch.floor(u[:, j] * span).to(torch.int32),
                              span - 1)
        pick = lookup(t)
        a_j = lookup(torch.full_like(t, j))
        rec_pos.append(t)
        rec_val.append(a_j)
        picks.append(pick)

    off = torch.stack(picks, dim=1)
    live = torch.arange(fanout, device=frontier.device)[None, :] < deg[:, None]
    # rows past their degree read edge 0 (a valid address), then mask
    pos = torch.where(live, start[:, None] + off, 0)
    return torch.where(live, indices[pos], EMPTY)


def _check(indptr, indices, frontier, fanout, u):
    for name, t in (("indptr", indptr), ("indices", indices),
                    ("frontier", frontier)):
        if t.dim() != 1 or t.dtype != torch.int32:
            # an int64 indptr (2^31 edges or more) is not taken
            raise ValueError(
                f"sample_khop: {name} must be 1-D int32, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    if indptr.shape[0] < 1:
        raise ValueError("sample_khop: indptr needs num_node + 1 entries")
    if not 1 <= fanout <= MAX_FANOUT:
        raise ValueError(
            f"sample_khop: fanout {fanout} outside [1, {MAX_FANOUT}]"
        )
    tensors = [indptr, indices, frontier]
    if u is not None:
        if u.dtype != torch.float32 or tuple(u.shape) != (frontier.shape[0],
                                                          fanout):
            raise ValueError(
                f"sample_khop: u must be float32 ({frontier.shape[0]}, "
                f"{fanout}), got {u.dtype} {tuple(u.shape)}"
            )
        tensors.append(u)
    if any(t.device != frontier.device for t in tensors):
        raise ValueError("sample_khop: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sample_khop: tensors must be contiguous")
    if frontier.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sample_khop: no kernel for {frontier.device}")


def sample_khop0(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(B, fanout)`` int32 picks for the ``(B,)`` int32 frontier, EMPTY
    past each row's degree.  ``u``: ``(B, fanout)`` float32 uniforms; drawn
    from ``generator`` when not given, as the plain version draws them."""
    _check(indptr, indices, frontier, fanout, u)
    if frontier.device.type == "cpu":
        return sample_khop0_plain(indptr, indices, frontier, fanout,
                                  generator, u=u)
    b = frontier.shape[0]
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)
    lib = _build.load("sampling")
    out = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    if b:
        rc = lib.xg_sample_khop(
            indptr.data_ptr(), indices.data_ptr(), frontier.data_ptr(),
            u.data_ptr(), out.data_ptr(), indptr.shape[0] - 1, b, fanout,
            _build.stream_handle(frontier.device),
        )
        _build.check(rc, _NAME)
        _build.LAUNCHES.add(_NAME)
    return out


sample_khop2 = sample_khop0
sample_khop3 = sample_khop0
