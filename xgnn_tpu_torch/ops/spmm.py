"""K6: full-graph aggregation over a CSR graph, for layer-wise inference.

The port of ``xgnn_tpu/ops/spmm.py``:

- :func:`spmm_csr` (K6a): ``out[v] = sum over the CSR row v of h[u]``, or
  with ``mean`` that sum times ``1 / max(deg(v), 1)`` (an empty row is a
  zero row);
- :func:`segment_max_csr`: ``out[v] = max over the row of vals[u]``, with
  ``init`` for an empty row (plain PyTorch: on the card it lives inside
  K6b);
- :func:`gat_aggregate_csr` (K6b): GAT's exact segment-softmax aggregate,
  ``e = leaky(el[v] + er[u])``, ``w = exp(e - max_row e)``, ``out[v] =
  sum w * feat[u] / max(sum w, 1e-9)`` per head, 0 on an empty row.

Ids outside ``[0, N)`` are clipped into it, as ``jnp.take(mode="clip")``
does.  JAX's degree-bucketed plan (``build_spmm_plan``,
``spmm_csr_planned``, ``gat_aggregate_planned``) computes the same
functions in another order for the TPU's transaction costs; the port has
one form of each (ROADMAP section 3).

K6a also takes a float16 ``h`` (full-graph inference's layer 0 over an
F16 feature file, whose table JAX keeps in float16) and then rounds where
JAX's plan rounds (``xgnn_tpu/ops/spmm.py:374-394``, ``:455``): each
segment of :data:`SEGMENT` edges from a row's start is summed in float32
in CSR order and rounded to float16, the mean form multiplies it by the
float32 ``1 / max(deg, 1)`` and rounds again, and a row's segments are
added into a float16 accumulator in the order of JAX's buckets (a last
partial segment of at most :data:`SEGMENT_FIRST_MAX` edges first, then
the others from the row's start), each addition rounded.  The result is
float16.

The CUDA kernels are ``csrc/spmm.cu``: a warp a row in CSR order, rows
longer than :data:`HUB_CAP` edges summed by a block in a fixed order, so
two launches give the same bits; the float16 form's rows of more than
:data:`SEGMENT` edges get a block whose warps sum their segments.  The
``*_plain`` functions are their plain
PyTorch versions, which walk the edges in chunks of ``chunk`` (a gather and
an ``index_add_`` a chunk, as JAX's scan does), so that they also run at
products scale on the card; the wrappers take them only for tensors on the
CPU.  On the CPU ``index_add_`` adds in index order, so the plain sum runs
in CSR order from 0, as the kernel's does.  Launches are counted as
``spmm_csr`` (``spmm_csr_f16`` for the float16 form) and
``gat_aggregate_csr``.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from . import _build

_SPMM, _GAT = "spmm_csr", "gat_aggregate_csr"
_SPMM_F16 = "spmm_csr_f16"
# rows with more edges than this are summed by a block of warps, each over
# a contiguous part of the row, the parts added in warp order (the largest
# degree of the products graph is 18,969)
HUB_CAP = 2048
# the float16 form's segments: JAX's plan cuts rows at max_cap 2048 edges,
# and its fine buckets run from the smallest cap up, so a row's last
# partial segment of at most 1536 edges (the cap below 2048) is added
# first, a longer one after the full segments
SEGMENT, SEGMENT_FIRST_MAX = 2048, 1536
GAT_EPS = 1e-9  # gat_aggregate_csr's floor under the softmax's sum
SEGMENT_MAX_INIT = -1e30


def _edge_chunks(indptr, indices, num_node: int, num_rows: int, chunk: int):
    """``(rows, nbrs)`` of each chunk of edges: the CSR row of each edge
    (``num_node`` for an edge past the last row) and its neighbour id,
    clipped into ``[0, num_rows)``."""
    bounds = indptr[: num_node + 1].long()
    num_edge = indices.shape[0]
    for e0 in range(0, num_edge, chunk):
        e1 = min(num_edge, e0 + chunk)
        eids = torch.arange(e0, e1, device=indices.device)
        rows = torch.searchsorted(bounds, eids, right=True) - 1
        nbrs = torch.clamp(indices[e0:e1].long(), 0, max(num_rows - 1, 0))
        yield rows, nbrs


def inverse_degree(indptr, num_node: int) -> torch.Tensor:
    """``1 / max(deg, 1)`` in float32, the mean's factor."""
    deg = (indptr[1: num_node + 1] - indptr[:num_node]).float()
    return 1.0 / torch.clamp(deg, min=1.0)


def spmm_csr_plain(indptr, indices, h, *, num_node: int, chunk: int = 1 << 20,
                   mean: bool = False) -> torch.Tensor:
    """A gather and an ``index_add_`` a chunk of edges (one more row takes
    the edges past the last)."""
    acc = torch.zeros((num_node + 1, h.shape[1]), dtype=h.dtype,
                      device=h.device)
    for rows, nbrs in _edge_chunks(indptr, indices, num_node, h.shape[0],
                                   chunk):
        acc.index_add_(0, rows, h[nbrs])
    out = acc[:num_node]
    if mean:
        out = out * inverse_degree(indptr, num_node)[:, None]
    return out


def spmm_csr_f16_plain(indptr, indices, h, *, num_node: int,
                       chunk: int = 1 << 20,
                       mean: bool = False) -> torch.Tensor:
    """The float16 form: each segment's float32 sum by ``index_add_`` a
    chunk of edges (in CSR order on the CPU), rounded to float16 (and with
    ``mean`` times the inverse degree, rounded again), then the segments
    added into a float16 accumulator a round at a time, in JAX's order."""
    dev = h.device
    bounds = indptr[: num_node + 1].long()
    deg = bounds[1:] - bounds[:-1]
    nseg = (deg + SEGMENT - 1) // SEGMENT
    base = torch.cumsum(nseg, 0) - nseg  # each row's first segment
    total = int(nseg.sum())
    acc = torch.zeros((total + 1, h.shape[1]), dtype=torch.float32,
                      device=dev)
    num_edge = indices.shape[0]
    for e0 in range(0, num_edge, chunk):
        e1 = min(num_edge, e0 + chunk)
        eids = torch.arange(e0, e1, device=dev)
        rows = torch.searchsorted(bounds, eids, right=True) - 1
        live = rows < num_node  # edges past the last row go to row total
        at = torch.clamp(rows, max=max(num_node - 1, 0))
        seg = torch.where(live, base[at] + (eids - bounds[at]) // SEGMENT,
                          total)
        nbrs = torch.clamp(indices[e0:e1].long(), 0, max(h.shape[0] - 1, 0))
        acc.index_add_(0, seg, h[nbrs].float())
    part = acc[:total].half()
    if mean:
        seg_row = torch.repeat_interleave(
            torch.arange(num_node, device=dev), nseg)
        part = (part.float()
                * inverse_degree(indptr, num_node)[seg_row, None]).half()
    out = torch.zeros((num_node, h.shape[1]), dtype=torch.float16,
                      device=dev)
    rem = deg % SEGMENT
    first = (rem != 0) & (rem <= SEGMENT_FIRST_MAX)
    for j in range(int(nseg.max()) if num_node else 0):
        rows = torch.nonzero(nseg > j)[:, 0]
        if j == 0:
            sg = torch.where(first[rows], nseg[rows] - 1, 0)
        else:
            sg = torch.where(first[rows], j - 1, j)
        out[rows] = (out[rows].float() + part[base[rows] + sg].float()).half()
    return out


def segment_max_csr(indptr, indices, vals, *, num_node: int,
                    chunk: int = 1 << 20,
                    init: float = SEGMENT_MAX_INIT) -> torch.Tensor:
    """``out[v] = max over the row of vals[u]`` (``vals`` is ``(N, H)``),
    ``init`` where the row is empty; plain PyTorch on every device."""
    acc = torch.full((num_node + 1, vals.shape[1]), init, dtype=vals.dtype,
                     device=vals.device)
    for rows, nbrs in _edge_chunks(indptr, indices, num_node, vals.shape[0],
                                   chunk):
        v = vals[nbrs]
        acc.scatter_reduce_(0, rows[:, None].expand_as(v), v, "amax")
    return acc[:num_node]


def gat_aggregate_csr_plain(indptr, indices, feat, el, er, *, num_node: int,
                            chunk: int = 1 << 19,
                            negative_slope: float = 0.2) -> torch.Tensor:
    """JAX's two passes: the row max of the scores through
    :func:`segment_max_csr` (``leaky`` is monotone, so it is ``leaky(el[v]
    + max er[u])``), then the weights and the weighted rows a chunk of
    edges at a time."""
    _, heads, d = feat.shape
    m = F.leaky_relu(
        el[:num_node] + segment_max_csr(indptr, indices, er, num_node=num_node,
                                        chunk=chunk),
        negative_slope)
    s_num = torch.zeros((num_node + 1, heads, d), dtype=feat.dtype,
                        device=feat.device)
    s_den = torch.zeros((num_node + 1, heads), dtype=feat.dtype,
                        device=feat.device)
    for rows, nbrs in _edge_chunks(indptr, indices, num_node, feat.shape[0],
                                   chunk):
        at = torch.clamp(rows, max=num_node - 1)
        e = F.leaky_relu(el[at] + er[nbrs], negative_slope)
        w = torch.exp(e - m[at])
        s_num.index_add_(0, rows, feat[nbrs] * w[..., None])
        s_den.index_add_(0, rows, w)
    return s_num[:num_node] / torch.clamp(s_den[:num_node],
                                          min=GAT_EPS)[..., None]


def _check_csr(name, indptr, indices, num_node, table,
               dtypes=(torch.float32,)):
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError(f"{name}: indptr and indices must be int32, got "
                         f"{indptr.dtype} and {indices.dtype}")
    if indptr.dim() != 1 or indices.dim() != 1:
        raise ValueError(f"{name}: indptr and indices must be 1-D")
    if not 0 <= num_node <= indptr.shape[0] - 1:
        raise ValueError(f"{name}: num_node {num_node} does not fit an "
                         f"indptr of {indptr.shape[0]} entries")
    if table.dtype not in dtypes:
        raise ValueError(f"{name}: rows must be "
                         f"{' or '.join(map(str, dtypes))}, got {table.dtype}")
    if not (indptr.device == indices.device == table.device):
        raise ValueError(f"{name}: indptr on {indptr.device}, indices on "
                         f"{indices.device}, rows on {table.device}")
    if table.shape[0] == 0:
        raise ValueError(f"{name}: a table of no rows")
    if table.requires_grad:
        # full-graph inference runs under no_grad; no path trains through it
        raise NotImplementedError(f"{name} has no backward")
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for {table.device}")


def _contiguous(*tensors):
    return [t.contiguous() for t in tensors]


def spmm_csr(indptr, indices, h, *, num_node: int, chunk: int = 1 << 20,
             mean: bool = False) -> torch.Tensor:
    """``(num_node, F)``: the sum (or mean) of ``h``'s rows over each CSR
    row, of ``h``'s type (float32, or float16 rounded as JAX's plan rounds:
    module docstring).  ``chunk`` sets the plain version's edges a pass
    (the CPU's); the kernel reads each row's edges in place."""
    if h.dim() != 2:
        raise ValueError(f"spmm_csr: h must be 2-D, got {tuple(h.shape)}")
    _check_csr(_SPMM, indptr, indices, num_node, h,
               (torch.float32, torch.float16))
    half = h.dtype == torch.float16
    if h.device.type == "cpu":
        plain = spmm_csr_f16_plain if half else spmm_csr_plain
        return plain(indptr, indices, h, num_node=num_node, chunk=chunk,
                     mean=mean)
    indptr, indices, h = _contiguous(indptr, indices, h)
    out = torch.empty((num_node, h.shape[1]), dtype=h.dtype, device=h.device)
    if half and num_node and h.shape[1]:
        rc = _build.load("spmm").xg_spmm_csr_f16(
            indptr.data_ptr(), indices.data_ptr(), h.data_ptr(),
            out.data_ptr(), num_node, h.shape[0], h.shape[1], int(mean),
            SEGMENT, SEGMENT_FIRST_MAX, _build.stream_handle(h.device))
        _build.check(rc, _SPMM_F16)
        _build.LAUNCHES.add(_SPMM_F16)
    elif num_node and h.shape[1]:
        rc = _build.load("spmm").xg_spmm_csr(
            indptr.data_ptr(), indices.data_ptr(), h.data_ptr(),
            out.data_ptr(), num_node, h.shape[0], h.shape[1], int(mean),
            HUB_CAP, _build.stream_handle(h.device))
        _build.check(rc, _SPMM)
        _build.LAUNCHES.add(_SPMM)
    return out


def gat_aggregate_csr(indptr, indices, feat, el, er, *, num_node: int,
                      chunk: int = 1 << 19,
                      negative_slope: float = 0.2) -> torch.Tensor:
    """``(num_node, H, D)``: each head's softmax-weighted mean of ``feat``
    ``(N, H, D)`` over each CSR row, with scores ``leaky(el[v] + er[u])``
    from ``el`` and ``er`` ``(N, H)``."""
    if feat.dim() != 3:
        raise ValueError(f"gat_aggregate_csr: feat must be (N, H, D), got "
                         f"{tuple(feat.shape)}")
    n, heads, d = feat.shape
    for name, t in (("el", el), ("er", er)):
        if (t.shape != (n, heads) or t.dtype != torch.float32
                or t.device != feat.device):
            raise ValueError(f"gat_aggregate_csr: {name} must be float32 "
                             f"({n}, {heads}) on {feat.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    _check_csr(_GAT, indptr, indices, num_node, feat)
    if num_node > n:
        raise ValueError(f"gat_aggregate_csr: {num_node} rows but el has {n}")
    if feat.device.type == "cpu":
        return gat_aggregate_csr_plain(indptr, indices, feat, el, er,
                                       num_node=num_node, chunk=chunk,
                                       negative_slope=negative_slope)
    indptr, indices, feat, el, er = _contiguous(indptr, indices, feat, el, er)
    out = torch.empty((num_node, heads, d), dtype=feat.dtype,
                      device=feat.device)
    if num_node and heads * d:
        rc = _build.load("spmm").xg_gat_csr(
            indptr.data_ptr(), indices.data_ptr(), feat.data_ptr(),
            el.data_ptr(), er.data_ptr(), out.data_ptr(), num_node, n, heads,
            d, float(negative_slope), HUB_CAP,
            _build.stream_handle(feat.device))
        _build.check(rc, _GAT)
        _build.LAUNCHES.add(_GAT)
    return out
