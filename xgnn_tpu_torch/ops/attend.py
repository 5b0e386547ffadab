"""K5: GAT's edge-softmax aggregate over a block's picks, with its gradient.

The port of ``GATConv._online_attend`` of ``xgnn_tpu/models/gnn.py``
(with the score and payload functions of its aggregate-first and
transform-first paths).  For dst row ``b``, head ``h`` and its valid picks
``k`` (a pick is valid when it lies in ``[0, N)``; EMPTY is not):

- ``pre_k = el_dst[b, h] + score_h(table[neigh[b, k]])`` and ``e_k =
  leaky_relu(pre_k, 0.2)``;
- ``out[b, h] = sum_k exp(e_k - m) payload_h(row_k) / max(s, 1e-9)`` with
  ``m = max_k e_k`` and ``s = sum_k exp(e_k - m)``: the exact softmax over
  the valid picks; a row with no valid pick gives zeros.

Two modes, as the JAX paths shape the table:

- ``"shared"`` (aggregate first): ``proj`` is ``wr`` ``(W, H)``; ``score_h
  = row . wr[:, h]`` and every head's payload is the whole W-wide row, so
  ``out`` is ``(D, H, W)``.
- ``"per_head"`` (transform first): the table is ``h_src @ kernel``, ``(N,
  H*d)``, and ``proj`` is ``attn_r`` ``(H, d)``; head ``h`` scores its slice
  ``row[h*d:(h+1)*d] . attn_r[h]`` and its payload is that slice, so ``out``
  is ``(D, H, d)``.

The gradient is the exact softmax gradient (the running max carries none,
as in the JAX package): with ``a_k = exp(e_k - m) / s``, ``ga_k = g_out .
payload_k``, ``dot = sum_k a_k ga_k / sum_k a_k`` (which is ``g_out .
out``, so the backward never reads ``out``), ``g_e_k = a_k (ga_k - dot)``
and ``g_pre_k = g_e_k leaky'(pre_k)``; ``g_el_dst`` sums ``g_pre_k`` over
the picks, ``g_proj`` sums ``g_pre_k row_k`` over every pick of the block,
and the table's row ``r`` gets, over its picks, ``a_k g_out[b, h]`` on the
payload and ``g_pre_k proj[:, h]`` through the score.

The CUDA kernels are ``csrc/attend.cu``; the table's gradient is summed by
src row with ``csrc/fanout.cu``'s segmented backward (K4's).  At one head
the row pass writes ``a_k`` and ``g_pre_k``, two floats a pick, and the
sum is K4's weighted backward over ``g_out`` with weights ``a`` plus its
rank-1 term, ``(sum of g_pre over the row's picks) * proj``; at more heads
it writes one gradient row a pick, which K4 sums as rows of one pick.
:func:`attend_forward_plain` and :func:`attend_backward_plain` are the
plain PyTorch versions, which the wrappers take only for tensors on the
CPU; the plain backward sums the table's gradient in the kernels'
association (``fanout_backward_plain``).  Launches are counted as
``attend_fwd`` and ``attend_bwd``, one each per call of the forward and of
the backward.  The backward also runs when the table needs no gradient
(the feature table at layer 0), for ``g_el_dst`` and ``g_proj``.

:func:`gat_attend_prefix` is the shared mode of a local-id block, whose
dst rows are the prefix ``h_src[:D]``: it forms ``el_dst = h_src[:D] @
wl`` itself, so that the prefix's gradient ``g_el_dst @ wl.T`` goes into
the table's sum as K4's ``grad_dst`` and autograd makes no zero-filled
gradient of ``h_src`` for the slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .fanout import _ptr, fanout_backward_plain, segment_sum

SHARED, PER_HEAD = "shared", "per_head"
NEGATIVE_SLOPE = 0.2
# the kernels' limits, a mirror of fits() in csrc/attend.cu (the source),
# kept here so that the CPU path refuses the same shapes: at most MAX_HEADS
# heads, a table at most MAX_WIDTH wide and, in shared mode, at most
# MAX_ROW floats of an output row with H rounded up to a power of two
MAX_HEADS = 8
MAX_ROW = 2048
MAX_WIDTH = 512
# blocks of the backward's row pass (fixed for a given D, so its sums of
# g_proj run in the same order on every call)
_BWD_WARPS, _BWD_MAX_BLOCKS = 8, 132 * 8

_FWD, _BWD = "attend_fwd", "attend_bwd"


def _geometry(table, proj, mode):
    """``(H, W')``: heads and payload width."""
    if mode == SHARED:
        return proj.shape[1], table.shape[1]
    h = proj.shape[0]
    return h, table.shape[1] // max(h, 1)


def _score(rows, proj, mode, h):
    if mode == SHARED:
        return rows @ proj
    return (rows.reshape(rows.shape[0], h, -1) * proj).sum(-1)


def _payload(rows, mode, h):
    if mode == SHARED:
        return rows[:, None, :]
    return rows.reshape(rows.shape[0], h, -1)


def _leaky(x):
    return torch.where(x >= 0, x, NEGATIVE_SLOPE * x)


def _pick_rows(table, col):
    valid = (col >= 0) & (col < table.shape[0])
    return valid, table[torch.where(valid, col, 0)]


def attend_forward_plain(table, neigh, el_dst, proj, mode):
    """K passes of the JAX online softmax.  Returns ``(out (D, H, W'), m,
    s)``, with ``m`` 0 for a row without a valid pick."""
    h, wp = _geometry(table, proj, mode)
    d, fanout = neigh.shape
    dev = table.device
    m = torch.full((d, h), -torch.inf, dtype=torch.float32, device=dev)
    s = torch.zeros((d, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((d, h, wp), dtype=torch.float32, device=dev)
    for k in range(fanout):
        valid, rows = _pick_rows(table, neigh[:, k])
        e = _leaky(el_dst + _score(rows, proj, mode, h))
        e = torch.where(valid[:, None], e, -torch.inf)
        m_new = torch.maximum(m, e)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        scale = torch.exp(m - m_safe)
        w = torch.exp(e - m_safe)
        s = s * scale + w
        acc = acc * scale[:, :, None] + _payload(rows, mode, h) * w[:, :, None]
        m = m_new
    out = acc / torch.clamp(s, min=1e-9)[:, :, None]
    return out, torch.where(torch.isfinite(m), m, 0.0), s


def _pick_terms(g_out, table, neigh, el_dst, proj, m, den, mode, k):
    """Pick ``k`` of every dst row: ``(valid, rows, pre, a, ga)``."""
    h, _ = _geometry(table, proj, mode)
    valid, rows = _pick_rows(table, neigh[:, k])
    pre = el_dst + _score(rows, proj, mode, h)
    a = torch.where(valid[:, None], torch.exp(_leaky(pre) - m) / den, 0.0)
    ga = (g_out * _payload(rows, mode, h)).sum(-1)
    return valid, rows, pre, a, ga


def attend_dot_plain(g_out, table, neigh, el_dst, proj, m, s, mode):
    """``sum_k a_k (g_out . payload_k) / sum_k a_k`` per dst row and head:
    ``g_out . out`` without ``out``, from the forward's ``m`` and ``s``.
    The ratio keeps it exact where ``m`` and ``s`` come from scores summed
    in another order (the kernel's): ``sum_k a_k`` is then 1 only to their
    rounding, which ``|dot|`` would multiply."""
    den = torch.clamp(s, min=1e-9)
    dot = torch.zeros_like(el_dst)
    total = torch.zeros_like(el_dst)
    for k in range(neigh.shape[1]):
        _, _, _, a, ga = _pick_terms(g_out, table, neigh, el_dst, proj, m,
                                     den, mode, k)
        dot = dot + a * ga
        total = total + a
    return torch.where(total > 0, dot / torch.where(total > 0, total, 1.0),
                       0.0)


def _rank1_row(proj, mode):
    """``u`` of the one-head table gradient's rank-1 term: ``wr[:, 0]``
    (shared) or ``attn_r[0]`` (per head), each contiguous."""
    return proj[:, 0] if mode == SHARED else proj[0]


def attend_backward_plain(g_out, table, neigh, el_dst, proj, m, s, mode,
                          need_table: bool,
                          wl: Optional[torch.Tensor] = None):
    """``(g_table or None, g_el_dst, g_proj)`` pass by pass over the picks.
    The table's gradient is summed as the kernels sum it: at one head from
    ``a`` and ``g_pre`` a pick, ``fanout_backward_plain`` over ``g_out``
    with weights ``a`` and the rank-1 term ``(sum g_pre) * proj``; at more
    heads from one gradient row a pick, summed as rows of one pick.  With
    ``wl`` (shared mode, ``el_dst = table[:D] @ wl``) the prefix's gradient
    ``g_el_dst @ wl.T`` is added to rows ``< D`` last."""
    h, _ = _geometry(table, proj, mode)
    d, fanout = neigh.shape
    dot = attend_dot_plain(g_out, table, neigh, el_dst, proj, m, s, mode)
    den = torch.clamp(s, min=1e-9)
    g_el = torch.zeros_like(el_dst)
    g_proj = torch.zeros_like(proj)
    per_pick, a_cols, c_cols = [], [], []
    for k in range(fanout):
        valid, rows, pre, a, ga = _pick_terms(g_out, table, neigh, el_dst,
                                              proj, m, den, mode, k)
        g_e = a * (ga - dot)
        g_pre = torch.where(pre >= 0, g_e, NEGATIVE_SLOPE * g_e)
        g_el = g_el + g_pre
        if mode == SHARED:
            g_proj = g_proj + rows.T @ g_pre
        else:
            g_proj = g_proj + (g_pre[:, :, None]
                               * rows.reshape(d, h, -1)).sum(0)
        if need_table and h == 1:
            a_cols.append(a[:, 0])
            c_cols.append(torch.where(valid, g_pre[:, 0], 0.0))
        elif need_table:
            if mode == SHARED:
                v = (a[:, :, None] * g_out).sum(1) + g_pre @ proj.T
            else:
                v = (a[:, :, None] * g_out
                     + g_pre[:, :, None] * proj).reshape(d, -1)
            per_pick.append(torch.where(valid[:, None], v, 0.0))
    if not need_table:
        return None, g_el, g_proj
    grad_dst = None if wl is None else g_el @ wl.T
    n = table.shape[0]
    if h == 1:
        g_table = fanout_backward_plain(
            g_out.reshape(d, table.shape[1]), neigh, torch.stack(a_cols, 1),
            n, grad_dst, c=torch.stack(c_cols, 1), u=_rank1_row(proj, mode))
    else:
        rows_v = torch.stack(per_pick, 1).reshape(d * fanout, -1)
        g_table = fanout_backward_plain(rows_v, neigh.reshape(-1, 1), None,
                                        n, grad_dst)
    return g_table, g_el, g_proj


def _check(table, neigh, el_dst, proj, mode):
    if mode not in (SHARED, PER_HEAD):
        raise ValueError(f"gat_attend: mode must be {SHARED!r} or "
                         f"{PER_HEAD!r}, got {mode!r}")
    for name, t, dim in (("table", table, 2), ("el_dst", el_dst, 2),
                         ("proj", proj, 2)):
        if t.dim() != dim or t.dtype != torch.float32:
            raise ValueError(f"gat_attend: {name} must be {dim}-D float32, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if neigh.dim() != 2 or neigh.dtype != torch.int32:
        raise ValueError(f"gat_attend: neigh must be 2-D int32, got "
                         f"{neigh.dtype} {tuple(neigh.shape)}")
    n, width = table.shape
    d = neigh.shape[0]
    h, wp = _geometry(table, proj, mode)
    if el_dst.shape != (d, h):
        raise ValueError(f"gat_attend: el_dst {tuple(el_dst.shape)} for "
                         f"{d} dst rows and {h} heads")
    want = (width, h) if mode == SHARED else (h, wp)
    if h < 1 or proj.shape != want or (mode == PER_HEAD and h * wp != width):
        raise ValueError(f"gat_attend: proj {tuple(proj.shape)} does not fit "
                         f"a table {width} wide in mode {mode!r}")
    tensors = (table, neigh, el_dst, proj)
    if any(t.device != table.device for t in tensors):
        raise ValueError("gat_attend: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("gat_attend: tensors must be contiguous")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gat_attend: no kernel for {table.device}")
    h_pow2 = 1 << max(h - 1, 0).bit_length()
    if (h > MAX_HEADS or width > MAX_WIDTH
            or (mode == SHARED and h_pow2 * wp > MAX_ROW)):
        raise NotImplementedError(
            f"gat_attend: {h} heads of {wp} floats from a table {width} "
            f"wide; the kernel keeps at most {MAX_HEADS} heads, a table "
            f"{MAX_WIDTH} wide and, in shared mode, {MAX_ROW} floats of an "
            "output row with the heads rounded up to a power of two "
            "(ROADMAP K5 wide rows)")
    if n >= 2**31 - 1 or d * neigh.shape[1] >= 2**31 - 1:
        raise ValueError("gat_attend: sizes past int32")


def attend_forward(table: torch.Tensor, neigh: torch.Tensor,
                   el_dst: torch.Tensor, proj: torch.Tensor, mode: str):
    """``(out (D, H, W'), m, s)`` of :func:`gat_attend` without its
    autograd node: the kernel's forward, with the max and sum per row and
    head that the backward takes."""
    _check(table, neigh, el_dst, proj, mode)
    return _forward(table, neigh, el_dst, proj, mode)


def _forward(table, neigh, el_dst, proj, mode):
    if table.device.type == "cpu":
        return attend_forward_plain(table, neigh, el_dst, proj, mode)
    lib = _build.load("attend")
    h, wp = _geometry(table, proj, mode)
    d, fanout = neigh.shape
    dev = table.device
    out = torch.empty((d, h, wp), dtype=torch.float32, device=dev)
    m = torch.empty((d, h), dtype=torch.float32, device=dev)
    s = torch.empty((d, h), dtype=torch.float32, device=dev)
    if d:
        rc = lib.xg_attend_fwd(
            table.data_ptr(), neigh.data_ptr(), el_dst.data_ptr(),
            proj.data_ptr(), out.data_ptr(), m.data_ptr(), s.data_ptr(),
            table.shape[0], d, fanout, table.shape[1], h,
            int(mode == SHARED), NEGATIVE_SLOPE, _build.stream_handle(dev),
        )
        _build.check(rc, _FWD)
        _build.LAUNCHES.add(_FWD)
    return out, m, s


def _bwd_blocks(num_dst: int) -> int:
    """Blocks of the backward's row pass: one partial of ``g_proj`` each."""
    return max(1, min(-(-num_dst // _BWD_WARPS), _BWD_MAX_BLOCKS))


def attend_backward(g_out: torch.Tensor, table: torch.Tensor,
                    neigh: torch.Tensor, el_dst: torch.Tensor,
                    proj: torch.Tensor, m: torch.Tensor, s: torch.Tensor,
                    mode: str, need_table: bool,
                    wl: Optional[torch.Tensor] = None):
    """``(g_table or None, g_el_dst, g_proj)`` of :func:`gat_attend`, given
    ``g_out`` and the forward's ``m`` and ``s``.  With ``wl`` ``(W, H)``
    (shared mode; ``el_dst`` is ``table[:D] @ wl``), ``g_table`` also holds
    the prefix's gradient ``g_el_dst @ wl.T`` in rows ``< D``."""
    _check(table, neigh, el_dst, proj, mode)
    h, wp = _geometry(table, proj, mode)
    d, fanout = neigh.shape
    for name, t, shape in (("g_out", g_out, (d, h, wp)), ("m", m, (d, h)),
                           ("s", s, (d, h))):
        if (t.shape != shape or t.dtype != torch.float32
                or t.device != table.device or not t.is_contiguous()):
            raise ValueError(f"attend_backward: {name} must be contiguous "
                             f"float32 {shape} on {table.device}")
    if wl is not None and (mode != SHARED or wl.shape != proj.shape
                           or d > table.shape[0]):
        raise ValueError("attend_backward: wl is the dst prefix's (W, H) "
                         "projection of a shared-mode table")
    if table.device.type == "cpu":
        return attend_backward_plain(g_out, table, neigh, el_dst, proj, m, s,
                                     mode, need_table, wl)
    g_el, g_proj, a, g_pre, per_pick = _bwd_rows(
        g_out, table, neigh, el_dst, proj, m, s, mode, need_table)
    g_table = None
    if need_table:
        grad_dst = None if wl is None else (g_el @ wl.T).contiguous()
        n = table.shape[0]
        if h == 1:
            g_table = segment_sum(g_out.view(d, table.shape[1]), neigh, a,
                                  n, grad_dst, c=g_pre,
                                  u=_rank1_row(proj, mode))
        else:
            g_table = segment_sum(per_pick, neigh.view(-1, 1), None, n,
                                  grad_dst)
    _build.LAUNCHES.add(_BWD)
    return g_table, g_el, g_proj


def _bwd_rows(g_out, table, neigh, el_dst, proj, m, s, mode,
              need_table: bool):
    """The backward's dst-row pass on the card: ``(g_el, g_proj, a, g_pre,
    per_pick)``, with ``a`` and ``g_pre`` ``(D, K)`` at one head and
    ``per_pick`` ``(D * K, W)`` at more, when the table needs a gradient
    (else None)."""
    lib = _build.load("attend")
    h, _ = _geometry(table, proj, mode)
    d, fanout = neigh.shape
    dev = table.device
    n, width = table.shape
    g_el = torch.empty_like(el_dst)
    g_proj = torch.empty_like(proj)
    blocks = _bwd_blocks(d)
    partials = torch.empty((blocks, proj.numel()), dtype=torch.float32,
                           device=dev)
    a = g_pre = per_pick = None
    if need_table and h == 1:
        a = torch.empty((d, fanout), dtype=torch.float32, device=dev)
        g_pre = torch.empty((d, fanout), dtype=torch.float32, device=dev)
    elif need_table:
        per_pick = torch.empty((d * fanout, width), dtype=torch.float32,
                               device=dev)
    rc = lib.xg_attend_bwd(
        table.data_ptr(), neigh.data_ptr(), el_dst.data_ptr(),
        proj.data_ptr(), m.data_ptr(), s.data_ptr(), g_out.data_ptr(),
        g_el.data_ptr(), g_proj.data_ptr(), partials.data_ptr(),
        _ptr(per_pick), _ptr(a), _ptr(g_pre), blocks, n, d, fanout, width, h,
        int(mode == SHARED), NEGATIVE_SLOPE, _build.stream_handle(dev),
    )
    _build.check(rc, _BWD)
    return g_el, g_proj, a, g_pre, per_pick


class _Attend(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, neigh, el_dst, proj, mode):
        out, m, s = _forward(table, neigh, el_dst, proj, mode)
        ctx.save_for_backward(table, neigh, el_dst, proj, m, s)
        ctx.mode = mode
        return out

    @staticmethod
    def backward(ctx, g_out):
        need_table, _, need_el, need_proj, _ = ctx.needs_input_grad
        if not (need_table or need_el or need_proj):
            return None, None, None, None, None
        table, neigh, el_dst, proj, m, s = ctx.saved_tensors
        g_table, g_el, g_proj = attend_backward(
            g_out.contiguous(), table, neigh, el_dst, proj, m, s, ctx.mode,
            need_table)
        return (g_table, None, g_el if need_el else None,
                g_proj if need_proj else None, None)


def gat_attend(table: torch.Tensor, neigh: torch.Tensor,
               el_dst: torch.Tensor, proj: torch.Tensor,
               mode: str) -> torch.Tensor:
    """The normalised edge-softmax aggregate ``(D, H, W')`` of ``neigh``
    ``(D, K)``'s picks over ``table`` ``(N, W)``, in mode ``"shared"``
    (``proj`` is ``wr`` ``(W, H)``, ``W' = W``) or ``"per_head"`` (``proj``
    is ``attn_r`` ``(H, d)``, ``W = H * d``, ``W' = d``)."""
    _check(table, neigh, el_dst, proj, mode)
    return _Attend.apply(table, neigh, el_dst, proj, mode)


class _AttendPrefix(torch.autograd.Function):

    """``el_dst`` comes in formed (``h_src[:D] @ wl``, untracked); its
    gradient goes to ``h_src``'s prefix and to ``wl`` here."""

    @staticmethod
    def forward(ctx, h_src, neigh, el_dst, wl, wr):
        out, m, s = _forward(h_src, neigh, el_dst, wr, SHARED)
        ctx.save_for_backward(h_src, neigh, el_dst, wl, wr, m, s)
        return out

    @staticmethod
    def backward(ctx, g_out):
        need_h, _, _, need_wl, need_wr = ctx.needs_input_grad
        if not (need_h or need_wl or need_wr):
            return None, None, None, None, None
        h_src, neigh, el_dst, wl, wr, m, s = ctx.saved_tensors
        g_table, g_el, g_wr = attend_backward(
            g_out.contiguous(), h_src, neigh, el_dst, wr, m, s, SHARED,
            need_h, wl)
        g_wl = h_src[: neigh.shape[0]].T @ g_el if need_wl else None
        return g_table, None, None, g_wl, g_wr if need_wr else None


def gat_attend_prefix(h_src: torch.Tensor, neigh: torch.Tensor,
                      wl: torch.Tensor, wr: torch.Tensor) -> torch.Tensor:
    """:func:`gat_attend` in shared mode on a local-id block, with ``el_dst
    = h_src[:D] @ wl`` formed inside: ``wl`` and ``wr`` are ``(W, H)``.
    The gradient w.r.t. ``h_src`` of the prefix and of the picks is one
    sum by src row (K4's, with the prefix's gradient as its ``grad_dst``).
    With no gradient to track, the forward's launch alone."""
    d = neigh.shape[0]
    if (wl.shape != wr.shape or wl.dtype != wr.dtype or wl.device != wr.device
            or d > h_src.shape[0]):
        raise ValueError(f"gat_attend_prefix: wl {tuple(wl.shape)} and wr "
                         f"{tuple(wr.shape)} for {d} dst rows of a table "
                         f"{tuple(h_src.shape)}")
    with torch.no_grad():
        el_dst = h_src[:d] @ wl
    _check(h_src, neigh, el_dst, wr, SHARED)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (h_src, wl, wr)):
        return _AttendPrefix.apply(h_src, neigh, el_dst, wl, wr)
    return _forward(h_src, neigh, el_dst, wr, SHARED)[0]
