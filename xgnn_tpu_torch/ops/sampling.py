"""K2 and K8a: uniform neighbour sampling without and with replacement.

The port of ``xgnn_tpu/ops/sampling.py``'s ``_frontier_meta``,
``sample_khop0`` (K2), ``sample_uniform_wr`` and ``sample_khop1`` with
``_dedup_rows`` (K8a).  The reference's khop0, khop2 and khop3 all draw a
uniform K-subset of the neighbours (all of them when ``deg <= K``), so the
three share one partial Fisher-Yates.  khop1 draws K picks with replacement
(``sample_uniform_wr``), sorts each row and writes EMPTY over every repeat;
the row is not compacted.  Each call maps a padded frontier ``(B,)`` to a
neighbour matrix ``(B, K)`` with ``EMPTY_KEY`` padding, with static shapes
and no host sync.  A frontier id outside ``[0, num_node)`` has degree 0.

Given the same uniforms ``u`` the picks equal the JAX package's exactly:
the draws ``t = j + min(floor(u[:, j] * span), span - 1)`` (K2) and
``min(floor(u[:, j] * deg), deg - 1)`` (K8a) are computed in float32 as
there.

The CUDA kernels are ``csrc/sampling.cu``.  :func:`sample_khop0_plain`,
:func:`sample_uniform_wr_plain` and :func:`sample_khop1_plain` are their
plain PyTorch versions: the wrappers take them only for tensors on the CPU.
Launches are counted as ``sample_khop`` (K2) and ``sample_wr`` (K8a, both
forms).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as C
from . import _build

EMPTY = C.EMPTY_KEY
_NAME, _WR = "sample_khop", "sample_wr"
MAX_FANOUT = 64  # the kernels keep at most this many picks per row


def _frontier_meta(indptr: torch.Tensor, frontier: torch.Tensor):
    """Per-node CSR slice ``(start, deg)``; EMPTY entries (and any id
    outside ``[0, num_node)``) get degree 0."""
    valid = (frontier >= 0) & (frontier < indptr.shape[0] - 1)
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


def sample_uniform_wr_plain(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K independent uniform picks per row, duplicates kept: offset
    ``min(floor(u * deg), deg - 1)``; a row of degree 0 is all EMPTY."""
    _, start, deg, _ = _frontier_meta(indptr, frontier)
    if u is None:
        u = torch.rand((frontier.shape[0], fanout), generator=generator,
                       device=frontier.device)
    off = torch.floor(u * deg[:, None]).to(torch.int32)
    off = torch.minimum(off, torch.clamp(deg - 1, min=0)[:, None])
    live = deg[:, None] > 0
    pos = torch.where(live, start[:, None] + off, 0)
    return torch.where(live, indices[pos], EMPTY)


def _dedup_rows(nbr: torch.Tensor) -> torch.Tensor:
    """Each row sorted (EMPTY last), with EMPTY over every repeat of the
    value before it."""
    s = torch.sort(nbr, dim=1).values
    dup = torch.zeros_like(s, dtype=torch.bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    return torch.where(dup, EMPTY, s)


def sample_khop1_plain(indptr, indices, frontier, fanout, generator=None,
                       *, u=None) -> torch.Tensor:
    """khop1: the with-replacement draw, then each row's repeats masked."""
    return _dedup_rows(sample_uniform_wr_plain(indptr, indices, frontier,
                                               fanout, generator, u=u))


def _check(indptr, indices, frontier, fanout, u, what=_NAME):
    for name, t in (("indptr", indptr), ("indices", indices),
                    ("frontier", frontier)):
        if t.dim() != 1 or t.dtype != torch.int32:
            # an int64 indptr (2^31 edges or more) is not taken
            raise ValueError(
                f"{what}: {name} must be 1-D int32, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    if indptr.shape[0] < 1:
        raise ValueError(f"{what}: indptr needs num_node + 1 entries")
    if not 1 <= fanout <= MAX_FANOUT:
        raise ValueError(
            f"{what}: fanout {fanout} outside [1, {MAX_FANOUT}]"
        )
    tensors = [indptr, indices, frontier]
    if u is not None:
        if u.dtype != torch.float32 or tuple(u.shape) != (frontier.shape[0],
                                                          fanout):
            raise ValueError(
                f"{what}: u must be float32 ({frontier.shape[0]}, "
                f"{fanout}), got {u.dtype} {tuple(u.shape)}"
            )
        tensors.append(u)
    if any(t.device != frontier.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")
    if frontier.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {frontier.device}")


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


def _sample_wr(indptr, indices, frontier, fanout, generator, u, dedup):
    _check(indptr, indices, frontier, fanout, u, _WR)
    if frontier.device.type == "cpu":
        plain = sample_khop1_plain if dedup else sample_uniform_wr_plain
        return plain(indptr, indices, frontier, fanout, generator, u=u)
    b = frontier.shape[0]
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)
    lib = _build.load("sampling")
    out = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    if b:
        rc = lib.xg_sample_wr(
            indptr.data_ptr(), indices.data_ptr(), frontier.data_ptr(),
            u.data_ptr(), out.data_ptr(), indptr.shape[0] - 1, b, fanout,
            int(dedup), _build.stream_handle(frontier.device),
        )
        _build.check(rc, _WR)
        _build.LAUNCHES.add(_WR)
    return out


def sample_uniform_wr(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``(B, fanout)`` int32 picks drawn with replacement, duplicates kept,
    EMPTY on rows of degree 0.  ``u`` as for :func:`sample_khop0`."""
    return _sample_wr(indptr, indices, frontier, fanout, generator, u, False)


def sample_khop1(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The :func:`sample_uniform_wr` picks, each row sorted with EMPTY over
    every repeat (``[5, 3, 3]`` becomes ``[3, EMPTY, 5]``)."""
    return _sample_wr(indptr, indices, frontier, fanout, generator, u, True)
