"""K2, K8a and K8b: uniform and weighted neighbour sampling.

The port of ``xgnn_tpu/ops/sampling.py``'s ``_frontier_meta``,
``sample_khop0`` (K2), ``sample_uniform_wr`` and ``sample_khop1`` with
``_dedup_rows`` (K8a), and the weighted samplers (K8b):
``sample_weighted_khop``, ``sample_weighted_khop_hash_dedup`` and
``sample_weighted_khop_prefix`` with ``build_coarse_cdf``.  The reference's
khop0, khop2 and khop3 all draw a uniform K-subset of the neighbours (all
of them when ``deg <= K``), so the three share one partial Fisher-Yates.
khop1 draws K picks with replacement (``sample_uniform_wr``), sorts each
row and writes EMPTY over every repeat; the row is not compacted.  The
weighted samplers draw with replacement too, by alias tables or by a search
in row-local prefix sums, but for the hash-dedup form, which keeps the
first K distinct of ``HASH_DEDUP_ROUNDS * K`` alias draws.  Each call maps
a padded frontier ``(B,)`` to a neighbour matrix ``(B, K)`` with
``EMPTY_KEY`` padding, with static shapes and no host sync.  A frontier id
outside ``[0, num_node)`` (``[0, tier.csr.num_node)`` on a tiered topology)
has degree 0.

Given the same uniforms ``u`` (and ``coin``) the picks equal the JAX
package's exactly: the draws ``t = j + min(floor(u[:, j] * span), span -
1)`` (K2), ``min(floor(u[:, j] * deg), deg - 1)`` (K8a, the alias slot)
and the prefix target ``u * total`` are computed in float32 as there.  The
port's tables carry no tile padding.

A tiered topology (``tier=``, a :class:`~xgnn_tpu_torch.store.topology.
Tier`): the device CSR holds the hot node-id prefix ``[0,
tier.num_cache_node)`` only, and a frontier id ``num_cache_node <= v <
tier.csr.num_node`` (a cold row) reads its start, degree, picks and tables
from the whole graph's CSR in pinned, mapped host memory
(``tier.csr``, int64 offsets), in the same launch as the hot rows.  A cold
row takes the same uniforms as a hot row, so a tiered call picks what the
untiered call over the whole CSR picks.  The device CSR's ``indptr`` stays
int32 (an int64 one is refused); the host CSR's is int64.

The cold form (:func:`sample_cold`) is the same tiered kernels with no
device CSR: it draws a frontier's cold rows from the tier's host CSR and
writes EMPTY on every other row, reading no device row.  The partitioned
topology's requesting rank serves its cold rows with it
(``parallel/dist_topology.py``), where the device CSR is the rank's part
of the hot prefix, by local row.

The CUDA kernels are ``csrc/sampling.cu`` (K2, K8a) and ``csrc/weighted.cu``
(K8b).  The ``*_plain`` functions are their plain PyTorch versions: the
wrappers take them only for tensors on the CPU.  Launches are counted as
``sample_khop`` (K2), ``sample_wr`` (K8a, both forms), ``sample_prefix``
and ``sample_alias`` (K8b, the alias count covering both forms), and the
cold form's as the same names with ``_cold``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import constants as C
from . import _build

EMPTY = C.EMPTY_KEY
_NAME, _WR = "sample_khop", "sample_wr"
_PREFIX, _ALIAS = "sample_prefix", "sample_alias"
MAX_FANOUT = 64  # the kernels keep at most this many picks per row
HASH_DEDUP_ROUNDS = 4  # alias draws a pick of the hash-dedup form
MAX_DRAWS = 256  # the hash-dedup kernel keeps at most this many draws a row
COARSE_LANES = 128  # width of a coarse CDF row


def _frontier_meta(indptr: torch.Tensor, frontier: torch.Tensor):
    """Per-node CSR slice ``(start, deg)``; EMPTY entries (and any id
    outside ``[0, num_node)``) get degree 0."""
    valid = (frontier >= 0) & (frontier < indptr.shape[0] - 1)
    node = torch.where(valid, frontier, 0)
    start = indptr[node]
    deg = torch.where(valid, indptr[node + 1] - start, 0)
    return node, start, deg, valid


def _on(t: Optional[torch.Tensor], like: torch.Tensor):
    return None if t is None else t.to(like.device)


def _tables(csr, names, hot):
    """The device graph's tensors ``hot`` (``csr`` None), or the host CSR's
    of the same ``names``."""
    return tuple(hot) if csr is None else tuple(csr.host(n) for n in names)


def _per_tier(frontier: torch.Tensor, tier, run):
    """The plain form of a tiered call: ``run(csr, rows)`` over the device
    graph for every row (``csr`` None; a cold id has degree 0 there), then
    over the host CSR (``csr``, its tensors on the CPU) for the cold rows
    alone, each row's result taken from its own tier."""
    out = run(None, frontier)
    cold = (frontier >= tier.num_cache_node) & (frontier < tier.csr.num_node)
    got = run(tier.csr, torch.where(cold, frontier, EMPTY).cpu())
    mask = cold.reshape(cold.shape + (1,) * (out.dim() - cold.dim()))
    return torch.where(mask, got.to(out.device), out)


def _check_tier(tier, indptr, frontier, names, what):
    """A tier fits the device graph (its hot prefix is that graph's rows)
    and, for a CUDA frontier, its host arrays ``names`` are mapped for that
    device."""
    if tier is None:
        return
    num_node = indptr.shape[0] - 1
    if tier.num_cache_node != num_node or tier.csr.num_node < num_node:
        raise ValueError(
            f"{what}: a tier of {tier.num_cache_node} hot rows of "
            f"{tier.csr.num_node} for a device graph of {num_node} rows")
    _check_tier_arrays(tier, frontier, names, what)


def _check_tier_arrays(tier, frontier, names, what):
    """The tier's host arrays ``names`` exist and, for a CUDA frontier, are
    mapped for its device."""
    for name in names:
        if tier.csr.host(name) is None:
            raise ValueError(f"{what}: the tier's host CSR has no {name}")
        if (frontier.device.type == "cuda"
                and (tier.csr.device != frontier.device
                     or tier.csr.dev_ptr(name) is None)):
            raise ValueError(
                f"{what}: the tier's {name} is not mapped for "
                f"{frontier.device} (MappedHostCSR(..., device=...))")


def _cold_args(tier, indptr, names):
    """The kernels' tier arguments: the host arrays' device addresses and
    the whole graph's node count; null and the device graph's node count
    when there is no tier."""
    if tier is None:
        return [None] * len(names) + [indptr.shape[0] - 1]
    return [tier.csr.dev_ptr(n) for n in names] + [tier.csr.num_node]


def sample_khop0_plain(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
    tier=None,
) -> torch.Tensor:
    """Partial Fisher-Yates over the virtual array ``A = [0..deg)``: at step
    ``j`` draw ``t`` in ``[j, deg)``, emit ``A[t]`` and set ``A[t] = A[j]``.
    Only displaced entries are recorded, at most ``K`` of them, so each pick
    is resolved by a scan over the records.

    ``u``: ``(B, fanout)`` float32 uniforms; drawn from ``generator`` when
    not given.  ``tier``: the cold rows read from its host CSR.
    """
    b = frontier.shape[0]
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)
    if tier is not None:
        return _per_tier(frontier, tier, lambda csr, rows: sample_khop0_plain(
            *_tables(csr, ("indptr", "indices"), (indptr, indices)), rows,
            fanout, u=_on(u, rows)))
    _, start, deg, _ = _frontier_meta(indptr, frontier)

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
    tier=None,
) -> torch.Tensor:
    """K independent uniform picks per row, duplicates kept: offset
    ``min(floor(u * deg), deg - 1)``; a row of degree 0 is all EMPTY."""
    if u is None:
        u = torch.rand((frontier.shape[0], fanout), generator=generator,
                       device=frontier.device)
    if tier is not None:
        return _per_tier(frontier, tier,
                         lambda csr, rows: sample_uniform_wr_plain(
                             *_tables(csr, ("indptr", "indices"),
                                      (indptr, indices)),
                             rows, fanout, u=_on(u, rows)))
    _, start, deg, _ = _frontier_meta(indptr, frontier)
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
                       *, u=None, tier=None) -> torch.Tensor:
    """khop1: the with-replacement draw, then each row's repeats masked."""
    return _dedup_rows(sample_uniform_wr_plain(indptr, indices, frontier,
                                               fanout, generator, u=u,
                                               tier=tier))


def _check(indptr, indices, frontier, fanout, u, what=_NAME, tier=None,
           tier_arrays=("indptr", "indices")):
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
    _check_tier(tier, indptr, frontier, tier_arrays, what)


def sample_khop0(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
    tier=None,
) -> torch.Tensor:
    """``(B, fanout)`` int32 picks for the ``(B,)`` int32 frontier, EMPTY
    past each row's degree.  ``u``: ``(B, fanout)`` float32 uniforms; drawn
    from ``generator`` when not given, as the plain version draws them.
    ``tier``: the tiered topology's cold side (module docstring)."""
    _check(indptr, indices, frontier, fanout, u, tier=tier)
    if frontier.device.type == "cpu":
        return sample_khop0_plain(indptr, indices, frontier, fanout,
                                  generator, u=u, tier=tier)
    b = frontier.shape[0]
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)
    lib = _build.load("sampling")
    out = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    if b:
        rc = lib.xg_sample_khop(
            indptr.data_ptr(), indices.data_ptr(), frontier.data_ptr(),
            u.data_ptr(), out.data_ptr(), indptr.shape[0] - 1, b, fanout,
            *_cold_args(tier, indptr, ("indptr", "indices")),
            _build.stream_handle(frontier.device),
        )
        _build.check(rc, _NAME)
        _build.LAUNCHES.add(_NAME)
    return out


sample_khop2 = sample_khop0
sample_khop3 = sample_khop0


def _sample_wr(indptr, indices, frontier, fanout, generator, u, dedup,
               tier):
    _check(indptr, indices, frontier, fanout, u, _WR, tier)
    if frontier.device.type == "cpu":
        plain = sample_khop1_plain if dedup else sample_uniform_wr_plain
        return plain(indptr, indices, frontier, fanout, generator, u=u,
                     tier=tier)
    b = frontier.shape[0]
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)
    lib = _build.load("sampling")
    out = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    if b:
        rc = lib.xg_sample_wr(
            indptr.data_ptr(), indices.data_ptr(), frontier.data_ptr(),
            u.data_ptr(), out.data_ptr(), indptr.shape[0] - 1, b, fanout,
            int(dedup), *_cold_args(tier, indptr, ("indptr", "indices")),
            _build.stream_handle(frontier.device),
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
    tier=None,
) -> torch.Tensor:
    """``(B, fanout)`` int32 picks drawn with replacement, duplicates kept,
    EMPTY on rows of degree 0.  ``u`` and ``tier`` as for
    :func:`sample_khop0`."""
    return _sample_wr(indptr, indices, frontier, fanout, generator, u, False,
                      tier)


def sample_khop1(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
    tier=None,
) -> torch.Tensor:
    """The :func:`sample_uniform_wr` picks, each row sorted with EMPTY over
    every repeat (``[5, 3, 3]`` becomes ``[3, EMPTY, 5]``)."""
    return _sample_wr(indptr, indices, frontier, fanout, generator, u, True,
                      tier)


# ------------------------------------------------------------------ K8b
def _mask_rows(nbr: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """EMPTY over every row of degree 0."""
    return torch.where(deg[:, None] > 0, nbr, EMPTY)


def _alias_uniforms(frontier, draws, generator, u, coin):
    """``u`` and ``coin``, each ``(B, draws)``, drawn in that order from
    ``generator`` when not given."""
    if u is None:
        shape = (frontier.shape[0], draws)
        u = torch.rand(shape, generator=generator, device=frontier.device)
        coin = torch.rand(shape, generator=generator, device=frontier.device)
    return u, coin


def _alias_draws(indptr, indices, prob_table, alias_table, frontier, u,
                 coin):
    """The alias draw at every entry of ``u``, rows of degree 0 not yet
    masked, with the rows' ``(start, deg)``.  ``alias_table`` holds global
    ids: its entry is the pick itself, never looked up in ``indices``."""
    _, start, deg, _ = _frontier_meta(indptr, frontier)
    slot = torch.minimum(torch.floor(u * deg[:, None]).to(torch.int32),
                         torch.clamp(deg - 1, min=0)[:, None])
    # rows of degree 0 read edge 0 (a valid address), then are masked
    edge = torch.where(deg[:, None] > 0, start[:, None] + slot, 0)
    val = torch.where(coin >= prob_table[edge], alias_table[edge],
                      indices[edge])
    return val, start, deg


_ALIAS_ARRAYS = ("indptr", "indices", "prob_table", "alias_table")
_PREFIX_ARRAYS = ("indptr", "indices", "prob_prefix_table")


def sample_weighted_khop_plain(indptr, indices, prob_table, alias_table,
                               frontier, fanout, generator=None, *, u=None,
                               coin=None, tier=None) -> torch.Tensor:
    """K alias draws a row, duplicates kept."""
    u, coin = _alias_uniforms(frontier, fanout, generator, u, coin)
    if tier is not None:
        return _per_tier(frontier, tier,
                         lambda csr, rows: sample_weighted_khop_plain(
                             *_tables(csr, _ALIAS_ARRAYS,
                                      (indptr, indices, prob_table,
                                       alias_table)),
                             rows, fanout, u=_on(u, rows),
                             coin=_on(coin, rows)))
    val, _, deg = _alias_draws(indptr, indices, prob_table, alias_table,
                               frontier, u, coin)
    return _mask_rows(val, deg)


def sample_weighted_khop_hash_dedup_plain(
        indptr, indices, prob_table, alias_table, frontier, fanout,
        generator=None, *, u=None, coin=None,
        rounds: int = HASH_DEDUP_ROUNDS, tier=None) -> torch.Tensor:
    """The first K distinct values of ``rounds * K`` alias draws, in draw
    order, EMPTY after them when fewer appear; a row of ``deg <= K`` is the
    whole row in CSR order.  First occurrences by two stable sorts, as the
    JAX function finds them."""
    m = rounds * fanout
    u, coin = _alias_uniforms(frontier, m, generator, u, coin)
    if tier is not None:
        return _per_tier(
            frontier, tier,
            lambda csr, rows: sample_weighted_khop_hash_dedup_plain(
                *_tables(csr, _ALIAS_ARRAYS,
                         (indptr, indices, prob_table, alias_table)),
                rows, fanout, u=_on(u, rows), coin=_on(coin, rows),
                rounds=rounds))
    val, start, deg = _alias_draws(indptr, indices, prob_table, alias_table,
                                   frontier, u, coin)
    val_s, idx_s = torch.sort(val, dim=1, stable=True)
    lead = torch.ones_like(val_s, dtype=torch.bool)
    lead[:, 1:] = val_s[:, 1:] != val_s[:, :-1]
    first_slot = torch.where(lead, idx_s, m)  # repeats sort to the back
    ord_slot, order = torch.sort(first_slot, dim=1, stable=True)
    ord_val = torch.gather(val_s, 1, order)
    picked = torch.where(ord_slot[:, :fanout] < m, ord_val[:, :fanout], EMPTY)
    j = torch.arange(fanout, device=frontier.device)[None, :]
    live = j < deg[:, None]
    full = torch.where(live, indices[torch.where(live, start[:, None] + j, 0)],
                       EMPTY)
    out = torch.where((deg <= fanout)[:, None], full, picked)
    return _mask_rows(out, deg)


def _coarse_pos(j, deg, lanes: int):
    """Offset of the j-th coarse quantile of a row, ``ceil((j+1)*deg/lanes)
    - 1``, without overflow (``deg = q*lanes + r``)."""
    q, r = deg // lanes, deg % lanes
    return (j + 1) * q + ((j + 1) * r + lanes - 1) // lanes - 1


_COARSE_CHUNK = 1 << 18  # rows a step: about 1 GB of int64 temporaries


def build_coarse_cdf(indptr: torch.Tensor, prob_prefix_table: torch.Tensor,
                     num_node: int, lanes: int = COARSE_LANES
                     ) -> torch.Tensor:
    """``(num_node, lanes)`` float32, ``C[v, j] = prefix[start_v +
    ceil((j+1)*deg_v/lanes) - 1]``: each row's CDF at ``lanes`` evenly
    spaced offsets, 0 on rows of degree 0.  A one-time build, in steps of
    ``_COARSE_CHUNK`` rows."""
    dev = indptr.device
    out = torch.zeros((num_node, lanes), dtype=torch.float32, device=dev)
    n = prob_prefix_table.shape[0]
    if n == 0:
        return out
    j = torch.arange(lanes, dtype=torch.int64, device=dev)[None, :]
    for lo in range(0, num_node, _COARSE_CHUNK):
        hi = min(lo + _COARSE_CHUNK, num_node)
        start = indptr[lo:hi].to(torch.int64)[:, None]
        d = indptr[lo + 1:hi + 1].to(torch.int64)[:, None] - start
        e = _coarse_pos(j, torch.clamp(d, min=1), lanes)
        pos = start + torch.minimum(torch.clamp(e, min=0),
                                    torch.clamp(d - 1, min=0))
        c = prob_prefix_table[torch.clamp(pos, 0, n - 1)]
        out[lo:hi] = torch.where(d > 0, c, 0.0)
    return out


def _search_depth(span: Optional[int]) -> int:
    """Binary steps that resolve an interval of ``span`` entries (32 when
    it is not known), as the JAX function sizes its search."""
    if span is None:
        return 32
    return min(32, max(1, int(math.ceil(math.log2(max(span, 2)))) + 1))


def sample_weighted_khop_prefix_plain(
        indptr, indices, prob_prefix_table, frontier, fanout,
        generator=None, max_deg: Optional[int] = None, coarse_cdf=None, *,
        u=None, tier=None) -> torch.Tensor:
    """Per pick the smallest offset with ``prefix[start+off] > u * total``,
    clamped to ``deg - 1``: a binary search over the row, started from the
    coarse row's bucket when ``coarse_cdf`` is given; ``max_deg`` sizes the
    search.  A tier's cold rows are searched whole (no coarse row, 32
    steps)."""
    b = frontier.shape[0]
    if u is None:
        u = torch.rand((b, fanout), generator=generator,
                       device=frontier.device)
    if tier is not None:
        return _per_tier(
            frontier, tier,
            lambda csr, rows: sample_weighted_khop_prefix_plain(
                *_tables(csr, _PREFIX_ARRAYS,
                         (indptr, indices, prob_prefix_table)),
                rows, fanout, max_deg=max_deg if csr is None else None,
                coarse_cdf=coarse_cdf if csr is None else None,
                u=_on(u, rows)))
    node, start, deg, _ = _frontier_meta(indptr, frontier)
    live = (deg > 0)[:, None]
    safe = torch.clamp(deg, min=1)[:, None]
    table = prob_prefix_table
    total = table[torch.where(live, start[:, None] + safe - 1, 0)]
    x = u * total  # float32, rounded to nearest, as the JAX product
    if coarse_cdf is None:
        lo = torch.zeros((b, fanout), dtype=torch.int64,
                         device=frontier.device)
        hi = (safe - 1).to(torch.int64).expand(b, fanout)
        steps = _search_depth(max_deg)
    else:
        lanes = coarse_cdf.shape[1]
        # the count of coarse values <= x (the row is nondecreasing), with
        # x rounded up to total kept in the last bucket
        j = torch.searchsorted(coarse_cdf[node], x.contiguous(), right=True)
        j = torch.clamp(j, max=lanes - 1)
        prev = torch.minimum(torch.clamp(_coarse_pos(j - 1, safe, lanes),
                                         min=-1), safe - 1)
        lo = torch.where(j > 0, prev + 1, 0)
        hi = torch.minimum(torch.clamp(_coarse_pos(j, safe, lanes), min=0),
                           safe - 1)
        steps = _search_depth(None if max_deg is None
                              else -(-max_deg // lanes))
    for _ in range(steps):
        mid = (lo + hi) >> 1
        right = table[torch.where(live, start[:, None] + mid, 0)] <= x
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(right, hi, mid)
    off = torch.minimum(lo, safe - 1)
    return _mask_rows(indices[torch.where(live, start[:, None] + off, 0)],
                      deg)


def _check_weighted(indptr, indices, frontier, fanout, tables, draws, what,
                    tier):
    """``tables``: ``(name, tensor, dtype)`` of edge-aligned tables;
    ``draws``: ``(width, u, ...)``, the uniforms each ``(B, width)``."""
    _check(indptr, indices, frontier, fanout, None, what, tier,
           ("indptr", "indices") + tuple(name for name, _, _ in tables))
    width, *us = draws
    tensors = []
    for name, t, dtype in tables:
        if (t is None or t.dtype != dtype
                or tuple(t.shape) != tuple(indices.shape)):
            raise ValueError(
                f"{what}: {name} must be {dtype} {tuple(indices.shape)}, "
                f"got {None if t is None else (t.dtype, tuple(t.shape))}"
            )
        tensors.append(t)
    if any(t is None for t in us) and any(t is not None for t in us):
        raise ValueError(f"{what}: give u and coin together")
    for t in us:
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != (frontier.shape[0],
                                                          width):
            raise ValueError(
                f"{what}: u must be float32 ({frontier.shape[0]}, {width}), "
                f"got {t.dtype} {tuple(t.shape)}"
            )
        tensors.append(t)
    if any(t.device != frontier.device for t in tensors):
        raise ValueError(f"{what}: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: tensors must be contiguous")


def sample_weighted_khop_prefix(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    prob_prefix_table: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    max_deg: Optional[int] = None,
    coarse_cdf: Optional[torch.Tensor] = None,
    *,
    u: Optional[torch.Tensor] = None,
    tier=None,
) -> torch.Tensor:
    """``(B, fanout)`` int32 picks drawn with replacement, each neighbour
    with the probability of its weight, by a search in the row-local
    inclusive prefix sums ``prob_prefix_table``; EMPTY on rows of degree 0.

    Every row of ``prob_prefix_table`` must be nondecreasing (sums of
    positive weights, as ``synthetic_device.prefix_table`` makes them): the
    kernel searches a row held in shared memory and counts a hub's bucket,
    the plain version searches the table, and the two agree on such rows.
    ``coarse_cdf`` (:func:`build_coarse_cdf`, 128 wide) serves the kernel's
    rows of more than 128 entries, which are gathered otherwise;
    ``max_deg`` sizes the plain version's search.  ``u`` and ``tier`` as
    for :func:`sample_khop0`: a cold row is searched in the host CSR's
    ``prob_prefix_table``, ``coarse_cdf`` covers the hot rows only."""
    _check_weighted(indptr, indices, frontier, fanout,
                    [("prob_prefix_table", prob_prefix_table, torch.float32)],
                    (fanout, u), _PREFIX, tier)
    num_node = indptr.shape[0] - 1
    if coarse_cdf is not None and (
            coarse_cdf.dtype != torch.float32
            or tuple(coarse_cdf.shape) != (num_node, COARSE_LANES)
            or coarse_cdf.device != frontier.device
            or not coarse_cdf.is_contiguous()):
        raise ValueError(
            f"{_PREFIX}: coarse_cdf must be contiguous float32 ({num_node}, "
            f"{COARSE_LANES}) on {frontier.device}, got {coarse_cdf.dtype} "
            f"{tuple(coarse_cdf.shape)} on {coarse_cdf.device}"
        )
    if frontier.device.type == "cpu":
        return sample_weighted_khop_prefix_plain(
            indptr, indices, prob_prefix_table, frontier, fanout, generator,
            max_deg, coarse_cdf, u=u, tier=tier)
    b = frontier.shape[0]
    if u is None:
        u = torch.rand((b, fanout), generator=generator, device=frontier.device)
    lib = _build.load("weighted")
    out = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    if b:
        rc = lib.xg_sample_prefix(
            indptr.data_ptr(), indices.data_ptr(),
            prob_prefix_table.data_ptr(),
            None if coarse_cdf is None else coarse_cdf.data_ptr(),
            frontier.data_ptr(), u.data_ptr(), out.data_ptr(), num_node, b,
            fanout, *_cold_args(tier, indptr, _PREFIX_ARRAYS),
            _build.stream_handle(frontier.device),
        )
        _build.check(rc, _PREFIX)
        _build.LAUNCHES.add(_PREFIX)
    return out


def _sample_alias(indptr, indices, prob_table, alias_table, frontier, fanout,
                  generator, u, coin, rounds, tier):
    """Both alias forms: ``rounds`` is None without dedup."""
    dedup = rounds is not None
    draws = rounds * fanout if dedup else fanout
    if dedup and not (rounds >= 1 and draws <= MAX_DRAWS):
        raise ValueError(f"{_ALIAS}: {rounds} rounds of {fanout}: the "
                         f"kernel keeps 1 to {MAX_DRAWS} draws a row")
    _check_weighted(indptr, indices, frontier, fanout,
                    [("prob_table", prob_table, torch.float32),
                     ("alias_table", alias_table, torch.int32)],
                    (draws, u, coin), _ALIAS, tier)
    if frontier.device.type == "cpu":
        if dedup:
            return sample_weighted_khop_hash_dedup_plain(
                indptr, indices, prob_table, alias_table, frontier, fanout,
                generator, u=u, coin=coin, rounds=rounds, tier=tier)
        return sample_weighted_khop_plain(
            indptr, indices, prob_table, alias_table, frontier, fanout,
            generator, u=u, coin=coin, tier=tier)
    u, coin = _alias_uniforms(frontier, draws, generator, u, coin)
    lib = _build.load("weighted")
    b = frontier.shape[0]
    out = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    if b:
        rc = lib.xg_sample_alias(
            indptr.data_ptr(), indices.data_ptr(), prob_table.data_ptr(),
            alias_table.data_ptr(), frontier.data_ptr(), u.data_ptr(),
            coin.data_ptr(), out.data_ptr(), indptr.shape[0] - 1, b, fanout,
            draws, int(dedup), *_cold_args(tier, indptr, _ALIAS_ARRAYS),
            _build.stream_handle(frontier.device),
        )
        _build.check(rc, _ALIAS)
        _build.LAUNCHES.add(_ALIAS)
    return out


def sample_weighted_khop(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    prob_table: torch.Tensor,
    alias_table: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
    coin: Optional[torch.Tensor] = None,
    tier=None,
) -> torch.Tensor:
    """``(B, fanout)`` int32 alias draws, duplicates kept, EMPTY on rows of
    degree 0.  ``u``, ``coin``: ``(B, fanout)`` float32, the slot and the
    coin of each draw; drawn from ``generator`` (u first) when not given.
    ``tier`` as for :func:`sample_khop0`, its host CSR with alias tables."""
    return _sample_alias(indptr, indices, prob_table, alias_table, frontier,
                         fanout, generator, u, coin, None, tier)


def sample_weighted_khop_hash_dedup(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    prob_table: torch.Tensor,
    alias_table: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    u: Optional[torch.Tensor] = None,
    coin: Optional[torch.Tensor] = None,
    rounds: int = HASH_DEDUP_ROUNDS,
    tier=None,
) -> torch.Tensor:
    """``(B, fanout)`` int32: the first ``fanout`` distinct values of
    ``rounds * fanout`` alias draws in draw order, EMPTY after them when
    fewer appear (the bounded-rounds deviation of PARITY.md); a row of
    ``deg <= fanout`` is the whole row.  ``u``, ``coin``: ``(B, rounds *
    fanout)`` float32.  ``tier`` as for :func:`sample_weighted_khop`."""
    return _sample_alias(indptr, indices, prob_table, alias_table, frontier,
                         fanout, generator, u, coin, rounds, tier)


# ------------------------------------------------------- the cold form
# the cold form's kernel a form, by the samplers' forms: (library, entry
# point's base, the host arrays it reads)
COLD_FORMS = {
    "khop": ("sampling", _NAME, ("indptr", "indices")),
    "uniform_wr": ("sampling", _WR, ("indptr", "indices")),
    "khop1": ("sampling", _WR, ("indptr", "indices")),
    "alias": ("weighted", _ALIAS, _ALIAS_ARRAYS),
    "alias_dedup": ("weighted", _ALIAS, _ALIAS_ARRAYS),
    "prefix": ("weighted", _PREFIX, _PREFIX_ARRAYS),
}


def _cold_draws(form, frontier, fanout, generator, u, coin, rounds):
    """The cold form's uniforms, drawn as the form's sampler draws them
    where not given: ``(u, coin, width)``."""
    width = rounds * fanout if form == "alias_dedup" else fanout
    if form in ("alias", "alias_dedup"):
        u, coin = _alias_uniforms(frontier, width, generator, u, coin)
    elif u is None:
        u = torch.rand((frontier.shape[0], width), generator=generator,
                       device=frontier.device)
    return u, coin, width


def sample_cold_plain(form: str, tier, frontier: torch.Tensor, fanout: int,
                      generator: Optional[torch.Generator] = None, *,
                      u: Optional[torch.Tensor] = None,
                      coin: Optional[torch.Tensor] = None,
                      rounds: int = HASH_DEDUP_ROUNDS) -> torch.Tensor:
    """The cold half of a tiered call (``_per_tier``'s): the ``form``'s
    plain sampler over the host CSR for the frontier's cold ids, EMPTY
    rows elsewhere."""
    u, coin, _ = _cold_draws(form, frontier, fanout, generator, u, coin,
                             rounds)
    csr = tier.csr
    cold = (frontier >= tier.num_cache_node) & (frontier < csr.num_node)
    rows = torch.where(cold, frontier, EMPTY).cpu()
    uc, cc = _on(u, rows), _on(coin, rows)
    ip, ix = csr.host("indptr"), csr.host("indices")
    if form == "khop":
        out = sample_khop0_plain(ip, ix, rows, fanout, u=uc)
    elif form == "uniform_wr":
        out = sample_uniform_wr_plain(ip, ix, rows, fanout, u=uc)
    elif form == "khop1":
        out = sample_khop1_plain(ip, ix, rows, fanout, u=uc)
    elif form == "alias":
        out = sample_weighted_khop_plain(
            ip, ix, csr.host("prob_table"), csr.host("alias_table"), rows,
            fanout, u=uc, coin=cc)
    elif form == "alias_dedup":
        out = sample_weighted_khop_hash_dedup_plain(
            ip, ix, csr.host("prob_table"), csr.host("alias_table"), rows,
            fanout, u=uc, coin=cc, rounds=rounds)
    else:
        out = sample_weighted_khop_prefix_plain(
            ip, ix, csr.host("prob_prefix_table"), rows, fanout, u=uc)
    return out.to(frontier.device)


def sample_cold(form: str, tier, frontier: torch.Tensor, fanout: int,
                generator: Optional[torch.Generator] = None, *,
                u: Optional[torch.Tensor] = None,
                coin: Optional[torch.Tensor] = None,
                rounds: int = HASH_DEDUP_ROUNDS) -> torch.Tensor:
    """The cold form of the tiered samplers: ``(B, fanout)`` int32, the
    picks that the tiered call of ``form`` (a key of :data:`COLD_FORMS`)
    gives each frontier id in ``[tier.num_cache_node, tier.csr.num_node)``,
    read from the tier's host CSR, and EMPTY on every other row.  No device
    CSR is read: the partitioned topology's requesting rank serves its cold
    rows with it, whatever part of the hot prefix it holds.  ``u`` (and
    ``coin``; ``(B, rounds * fanout)`` for ``alias_dedup``) as the form's
    sampler takes them, drawn from ``generator`` where not given.  One
    launch, counted as ``<sampler>_cold``."""
    if form not in COLD_FORMS:
        raise ValueError(f"sample_cold: no form {form!r}")
    lib_name, base, names = COLD_FORMS[form]
    what = f"{base}_cold"
    if frontier.dim() != 1 or frontier.dtype != torch.int32:
        raise ValueError(f"{what}: frontier must be 1-D int32, got "
                         f"{frontier.dtype} {tuple(frontier.shape)}")
    if not 1 <= fanout <= MAX_FANOUT:
        raise ValueError(f"{what}: fanout {fanout} outside [1, {MAX_FANOUT}]")
    if form == "alias_dedup" and not (rounds >= 1
                                      and rounds * fanout <= MAX_DRAWS):
        raise ValueError(f"{what}: {rounds} rounds of {fanout}: the kernel "
                         f"keeps 1 to {MAX_DRAWS} draws a row")
    if frontier.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for {frontier.device}")
    if not 0 <= tier.num_cache_node <= tier.csr.num_node:
        raise ValueError(f"{what}: a hot prefix of {tier.num_cache_node} "
                         f"rows of {tier.csr.num_node}")
    _check_tier_arrays(tier, frontier, names, what)
    b = frontier.shape[0]
    width = rounds * fanout if form == "alias_dedup" else fanout
    for t in (u, coin):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (b, width)
                              or t.device != frontier.device
                              or not t.is_contiguous()):
            raise ValueError(f"{what}: u and coin must be contiguous "
                             f"float32 ({b}, {width}) on {frontier.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if frontier.device.type == "cpu":
        return sample_cold_plain(form, tier, frontier, fanout, generator,
                                 u=u, coin=coin, rounds=rounds)
    frontier = frontier.contiguous()
    u, coin, width = _cold_draws(form, frontier, fanout, generator, u, coin,
                                 rounds)
    lib = _build.load(lib_name)
    out = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    if b:
        ncn = tier.num_cache_node
        cold = _cold_args(tier, None, names)
        stream = _build.stream_handle(frontier.device)
        if base == _NAME:
            rc = lib.xg_sample_khop(None, None, frontier.data_ptr(),
                                    u.data_ptr(), out.data_ptr(), ncn, b,
                                    fanout, *cold, stream)
        elif base == _WR:
            rc = lib.xg_sample_wr(None, None, frontier.data_ptr(),
                                  u.data_ptr(), out.data_ptr(), ncn, b,
                                  fanout, int(form == "khop1"), *cold,
                                  stream)
        elif base == _ALIAS:
            dedup = form == "alias_dedup"
            rc = lib.xg_sample_alias(None, None, None, None,
                                     frontier.data_ptr(), u.data_ptr(),
                                     coin.data_ptr(), out.data_ptr(), ncn, b,
                                     fanout, width, int(dedup), *cold,
                                     stream)
        else:
            rc = lib.xg_sample_prefix(None, None, None, None,
                                      frontier.data_ptr(), u.data_ptr(),
                                      out.data_ptr(), ncn, b, fanout, *cold,
                                      stream)
        _build.check(rc, what)
        _build.LAUNCHES.add(what)
    return out
