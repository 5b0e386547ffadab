"""The partitioned topology, sampled where it lives (the ``--use-dist-graph``
GGMS store of more than one card).

The port of ``xgnn_tpu/parallel/dist_topology.py``.  The CSR is
interleave-partitioned by node id (rank ``p`` owns rows ``p, p + P, ...``,
:func:`partition_part`), the weighted tables edge-aligned with each part's
edges, a coarse CDF built over its rows.  A sampling layer ships the
sampling to the owner:

    group the frontier by owner (K13-plan) -> all_to_all the ids -> the
    owner draws K neighbours a request from its local rows with the port's
    samplers -> all_to_all the (K,) picks back -> K1 picks them in request
    order, EMPTY where a request is EMPTY or overflowed.

The owner sends each sample type to the kernel the single store uses: K2
(khop0, khop2, khop3), K8a (khop1, the walk's with-replacement steps),
K8b (the alias draws, their hash-dedup form, and the prefix search over
its coarse CDF).  The random walk is unrolled as one exchange a step (the
first a fanout-W draw over the seeds), and its visits are counted and
ranked by K9's top-K (``ops/random_walk.walk_topk``).

The host cold tier (``dist_graph_percentage < 1``, a :class:`LocalTopo`
with a ``tier``): the partitioned CSR is the hot node-id prefix ``[0,
num_cache_node)`` only, and the whole graph's CSR lies in pinned host
memory, mapped for the rank's card (``store/topology.py``'s
``MappedHostCSR``; a host's ranks share one).  A layer sends only the hot
ids (K13-plan's ``hot_limit``: a cold id's pick is EMPTY, as an EMPTY
request's), and the requesting rank draws its cold ids itself, in place
from the host CSR, with the samplers' cold form (``ops/sampling.
sample_cold``: one launch a layer, EMPTY on every other row); the select
that masks the response's EMPTY picks takes the cold rows' picks there,
so merging them costs no pass of its own.  JAX serves the cold ids
through a host callback over their compacted list
(``ggms.cold_sample_callback``), with a ``cold_cap`` and its overflow;
here there is no compaction, no ``cold_cap`` and no cold overflow.  A
walker on a cold node steps from the host CSR on its own rank (K8a's
``uniform_wr`` cold form).

Random streams: JAX keys each request's uniforms by (key, node, slot),
and a cold row's by a hash of (key, node, position).  The owner here
draws its whole ``(P * seg, ...)`` buffer from the rank's generator, so
duplicate requests draw independently, as JAX's slot term makes them,
and the requesting rank draws its cold rows' from its own.  For the tests
every sampler takes its uniforms instead, in request order (``u=``,
``coin=``; for the walk ``u=(steps, restart)``): the hot rows' are sent
to their owners with the requests, the cold rows' used where they are.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..config import SampleType, UNIFORM_KHOP
from ..ops import random_walk, sampling, unique
from ..ops.gather import gather_rows
from ..sampler import _device_scalar
from ..store.topology import Tier
from ..types import Block, SampledBatch
from .exchange import local_rows_of, plan_exchange
from .mesh import Mesh

EMPTY = C.EMPTY_KEY
UNIFORM_WR = "uniform_wr"  # the walk's with-replacement step


@dataclasses.dataclass
class LocalTopo:
    """One rank's part of the topology: ``(rows + 1,)`` int32 local
    offsets, the ``(E_p,)`` int32 global ids of its rows' neighbours and
    the weighted tables edge-aligned with them; ``num_node`` is the whole
    graph's node count and ``max_deg`` its largest degree.  ``tier``: the
    host cold tier, when the parts hold the hot prefix only (its
    ``num_cache_node``)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    num_parts: int
    num_node: int
    prob: Optional[torch.Tensor] = None
    alias: Optional[torch.Tensor] = None
    prefix: Optional[torch.Tensor] = None
    coarse: Optional[torch.Tensor] = None
    max_deg: Optional[int] = None
    tier: Optional[Tier] = None


def partition_part(indptr: torch.Tensor, indices: torch.Tensor,
                   num_parts: int, part: int,
                   num_cache_node: Optional[int] = None,
                   prob: Optional[torch.Tensor] = None,
                   alias: Optional[torch.Tensor] = None,
                   prefix: Optional[torch.Tensor] = None) -> LocalTopo:
    """Part ``part`` of the interleave-partitioned CSR prefix ``[0,
    num_cache_node)`` on the tensors' device: its rows ``part, part + P,
    ...``, rebased offsets (int32; a part of 2^31 edges or more raises),
    and the edge-aligned tables.  At P = 1 the part is the prefix of the
    graph's own tensors (alias entries are global ids: no part needs a
    translation).  ``indices`` and the tables may lie on the host (a memory
    map of 2^31 edges or more among them) whatever ``indptr``'s device: the
    part is cut where they lie and moved to ``indptr``'s."""
    num_node = indptr.shape[0] - 1
    ncn = num_node if num_cache_node is None else num_cache_node
    max_deg = int((indptr[1:] - indptr[:-1]).max()) if num_node else 0
    rows = max(-(-ncn // num_parts), 1)
    coarse = None
    dev = indptr.device
    if num_parts == 1:
        edges = int(indptr[ncn])
        if edges >= 2**31:
            raise ValueError(f"partition 0 would own {edges} edges (>= 2^31)")
        local = indptr[:ncn + 1].to(torch.int32)
        if ncn == 0:
            local = torch.zeros(2, dtype=torch.int32, device=dev)
        tables = tuple(None if t is None else t[:edges].to(dev)
                       for t in (prob, alias, prefix))
        idx = indices[:edges].to(dev)
    else:
        own = torch.arange(part, ncn, num_parts, device=dev)
        starts = indptr[own].long()
        degs = indptr[own + 1].long() - starts
        li = torch.zeros(rows + 1, dtype=torch.int64, device=dev)
        li[1:own.shape[0] + 1] = torch.cumsum(degs, 0)
        li[own.shape[0] + 1:] = li[own.shape[0]]
        edges = int(li[-1])
        if edges >= 2**31:
            raise ValueError(
                f"partition {part} would own {edges} edges (>= 2^31): "
                "increase num_parts")
        eid = (torch.repeat_interleave(starts - li[:own.shape[0]], degs,
                                       output_size=edges)
               + torch.arange(edges, device=dev))
        local = li.to(torch.int32)
        eid = eid.to(indices.device)
        idx = indices[eid].to(dev)
        tables = tuple(None if t is None else t[eid].to(dev)
                       for t in (prob, alias, prefix))
    if tables[2] is not None:
        coarse = sampling.build_coarse_cdf(local, tables[2], rows)
    return LocalTopo(local, idx, num_parts, num_node, *tables, coarse,
                     max_deg)


class HostParts(NamedTuple):
    """Every part stacked, as JAX's ``partition_csr_host`` returns them:
    ``(P, rows + 1)`` offsets, ``(P, max_edges)`` ids and tables (zero
    padded), ``(P, rows, 128)`` coarse CDFs."""

    indptr: np.ndarray
    indices: np.ndarray
    prob: Optional[np.ndarray] = None
    alias: Optional[np.ndarray] = None
    prefix: Optional[np.ndarray] = None
    coarse: Optional[np.ndarray] = None


def partition_csr_host(indptr, indices, num_parts: int,
                       num_cache_node: Optional[int] = None, prob=None,
                       alias=None, prefix=None) -> HostParts:
    """Host-side: every part of :func:`partition_part`, stacked."""
    t = lambda a: None if a is None else torch.as_tensor(np.asarray(a))
    parts = [partition_part(t(indptr).long(), t(indices), num_parts, p,
                            num_cache_node, t(prob), t(alias), t(prefix))
             for p in range(num_parts)]
    width = max(max(int(q.indices.shape[0]) for q in parts), 1)

    def stack(name):
        if getattr(parts[0], name) is None:
            return None
        first = getattr(parts[0], name)
        out = torch.zeros((num_parts, width), dtype=first.dtype)
        for p, q in enumerate(parts):
            v = getattr(q, name)
            out[p, :v.shape[0]] = v
        return out.numpy()

    coarse = (None if parts[0].coarse is None
              else torch.stack([q.coarse for q in parts]).numpy())
    return HostParts(torch.stack([q.indptr for q in parts]).numpy(),
                     stack("indices"), stack("prob"), stack("alias"),
                     stack("prefix"), coarse)


def owner_sample(topo: LocalTopo, req: torch.Tensor, fanout: int,
                 sample_type, generator=None, u=None, coin=None
                 ) -> torch.Tensor:
    """K neighbours for each received global id (``(P * seg,)``, EMPTY
    padded) from this rank's local rows: ``(P * seg, K)`` global ids.
    ``u`` (and ``coin``) in the received order, as the samplers take
    them; drawn from ``generator`` when not given."""
    rows = local_rows_of(req, topo.num_parts)
    st = sample_type
    if st == UNIFORM_WR:
        return sampling.sample_uniform_wr(topo.indptr, topo.indices, rows,
                                          fanout, generator, u=u)
    if st in UNIFORM_KHOP:
        return sampling.sample_khop0(topo.indptr, topo.indices, rows, fanout,
                                     generator, u=u)
    if st == SampleType.KHOP1:
        return sampling.sample_khop1(topo.indptr, topo.indices, rows, fanout,
                                     generator, u=u)
    if st in (SampleType.WEIGHTED_KHOP, SampleType.WEIGHTED_KHOP_HASH_DEDUP):
        draw = (sampling.sample_weighted_khop
                if st == SampleType.WEIGHTED_KHOP
                else sampling.sample_weighted_khop_hash_dedup)
        return draw(topo.indptr, topo.indices, topo.prob, topo.alias, rows,
                    fanout, generator, u=u, coin=coin)
    if st == SampleType.WEIGHTED_KHOP_PREFIX:
        return sampling.sample_weighted_khop_prefix(
            topo.indptr, topo.indices, topo.prefix, rows, fanout, generator,
            max_deg=topo.max_deg, coarse_cdf=topo.coarse, u=u)
    raise NotImplementedError(st)


# the samplers' cold form (ops/sampling.sample_cold) of each sample type
_COLD_FORMS = {UNIFORM_WR: "uniform_wr", SampleType.KHOP0: "khop",
               SampleType.KHOP2: "khop", SampleType.KHOP3: "khop",
               SampleType.KHOP1: "khop1", SampleType.WEIGHTED_KHOP: "alias",
               SampleType.WEIGHTED_KHOP_HASH_DEDUP: "alias_dedup",
               SampleType.WEIGHTED_KHOP_PREFIX: "prefix"}


def _to_owners(vals: torch.Tensor, plan, mesh: Mesh, seg: int):
    """Request-order ``vals`` (a row a request) in each owner's received
    order: placed at the requests' slots of the send buffer and sent with
    them (EMPTY and overflowed requests' rows dropped, their slots 0)."""
    p = mesh.size
    buf = torch.zeros((p * seg + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    at = torch.where(plan.pick != EMPTY, plan.pick, p * seg).long()
    buf[at] = vals
    return mesh.all_to_all(buf[:p * seg])


def sample_layer_partitioned(topo: LocalTopo, frontier: torch.Tensor,
                             fanout: int, mesh: Mesh, seg_cap: int,
                             sample_type=SampleType.KHOP3, generator=None,
                             u=None, coin=None):
    """One sampling layer over the partitioned topology: ``(neigh, overflow)``,
    ``neigh`` ``(n, K)`` global ids in request order.  A segment never needs
    more slots than the frontier has entries: ``seg = min(seg_cap, n)``.
    With a tier (``topo.tier``) only the hot ids are sent; the cold ones
    are drawn here from the host CSR (the samplers' cold form) and take
    their place in the one select that masks the EMPTY picks.  ``u``,
    ``coin``: every row's uniforms in request order, as the sample type's
    sampler takes them (module docstring); drawn from ``generator`` where
    not given."""
    p = mesh.size
    seg = max(min(seg_cap, frontier.shape[0]), 1)
    tier = topo.tier
    plan = plan_exchange(frontier, p, seg,
                         None if tier is None else tier.num_cache_node)
    owner_u, owner_coin = (None if t is None else _to_owners(t, plan, mesh,
                                                              seg)
                           for t in (u, coin))
    req = mesh.all_to_all(plan.send.reshape(-1))
    drawn = owner_sample(topo, req, fanout, sample_type, generator, owner_u,
                         owner_coin)
    resp = mesh.all_to_all(drawn)
    picked = gather_rows(resp, plan.pick)
    rest = EMPTY
    if tier is not None:
        rest = sampling.sample_cold(_COLD_FORMS[sample_type], tier, frontier,
                                    fanout, generator, u=u, coin=coin)
    return torch.where((plan.pick != EMPTY)[:, None], picked, rest), \
        plan.overflow


def walk_visits_partitioned(topo: LocalTopo, frontier: torch.Tensor,
                            mesh: Mesh, seg_cap: int, *, num_random_walk: int,
                            random_walk_length: int, restart_prob: float,
                            generator=None, u=None):
    """Restart random walks over the partitioned topology: ``(visits,
    overflow)``, ``visits`` ``(B, W, L)`` int32 (walker ``w``'s step ``s``
    at ``[b, w, s]``, EMPTY where it had no step).  Step 0 is one fanout-W
    exchange over the seeds; each later step restarts a walker at its seed
    where ``u_restart < restart_prob`` (float32), then takes a fanout-1
    exchange over the ``B * W`` walkers; a walker with no step returns to
    its seed, and a walker on a cold node (``topo.tier``) steps from the
    host CSR on this rank.  ``u = (steps, u_restart)``, in request order:
    ``steps[0]`` ``(B, W)``, ``steps[s]`` ``(B * W, 1)``, ``u_restart``
    ``(L, B, W)``."""
    b = frontier.shape[0]
    w, l = num_random_walk, random_walk_length
    steps, u_restart = (None, None) if u is None else u
    seed2d = frontier[:, None].expand(b, w)
    # filled on the device: a copy from host memory cannot be captured
    p_restart = torch.full((), restart_prob, dtype=torch.float32,
                           device=frontier.device)
    overflow = torch.zeros((), dtype=torch.bool, device=frontier.device)
    visits = []
    cur = seed2d
    for s in range(l):
        us = None if steps is None else steps[s]
        if s == 0:
            nxt, of = sample_layer_partitioned(topo, frontier, w, mesh,
                                               seg_cap, UNIFORM_WR,
                                               generator, us)
        else:
            r = (torch.rand((b, w), generator=generator,
                            device=frontier.device)
                 if u_restart is None else u_restart[s])
            cur = torch.where(r < p_restart, seed2d, cur)
            flat, of = sample_layer_partitioned(
                topo, cur.reshape(-1), 1, mesh, seg_cap * w, UNIFORM_WR,
                generator, us)
            nxt = flat.reshape(b, w)
        overflow = overflow | of
        visits.append(nxt)
        cur = torch.where(nxt == EMPTY, seed2d, nxt)
    return torch.stack(visits, dim=2), overflow


def sample_random_walk_partitioned(topo: LocalTopo, frontier: torch.Tensor,
                                   fanout: int, mesh: Mesh, seg_cap: int,
                                   **walk):
    """The walks of :func:`walk_visits_partitioned` (its keyword arguments)
    and each seed's top-``fanout`` visits by K9's count and ranking:
    ``(neigh, weights, overflow)``, as ``ops/random_walk.sample_random_walk``
    returns them."""
    visits, overflow = walk_visits_partitioned(topo, frontier, mesh, seg_cap,
                                               **walk)
    neigh, weights = random_walk.walk_topk(visits, frontier, fanout)
    return neigh, weights, overflow


def sample_minibatch_partitioned(topo: LocalTopo, seeds: torch.Tensor,
                                 num_seed, mesh: Mesh, *, seg_cap: int,
                                 sample_type, fanouts: Sequence[int],
                                 capacities: Sequence[int],
                                 rw_params: tuple = (4, 3, 0.5),
                                 generator=None,
                                 u: Optional[Sequence] = None
                                 ) -> SampledBatch:
    """Multi-layer sampling over the partitioned topology (with its cold
    tier where ``topo.tier`` is set): each layer's draw through the owner
    exchange, the dedup and remap (K3) on the rank.  Each layer's segment
    is ``seg_cap`` (sized to the last frontier) scaled to its own
    frontier's capacity, at least 128.  ``u``: each layer's request-order
    uniforms, ``(u, coin)`` (coin None but for the alias forms), or the
    walk's ``(steps, u_restart)`` (:func:`walk_visits_partitioned`)."""
    dev = seeds.device
    frontier = seeds
    num_frontier = num_seed = _device_scalar(num_seed, dev)
    blocks = []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for layer, fanout in enumerate(fanouts):
        layer_seg = max(int(np.ceil(seg_cap * capacities[layer]
                                    / capacities[-1])), 128)
        weights = None
        if sample_type == SampleType.RANDOM_WALK:
            num_rw, rw_len, restart = rw_params
            nbr, weights, of = sample_random_walk_partitioned(
                topo, frontier, fanout, mesh, layer_seg,
                num_random_walk=num_rw, random_walk_length=rw_len,
                restart_prob=restart, generator=generator,
                u=None if u is None else u[layer])
        else:
            uc = (None, None) if u is None else u[layer]
            nbr, of = sample_layer_partitioned(topo, frontier, fanout, mesh,
                                               layer_seg, sample_type,
                                               generator, *uc)
        out_cap = capacities[layer + 1]
        uids, num_unique, local = unique.unique_seeded_split(
            frontier, nbr.reshape(-1), num_frontier, out_cap,
            num_node=topo.num_node)
        blocks.append(Block(neigh=local.reshape(nbr.shape),
                            num_dst=num_frontier, num_src=num_unique,
                            weights=weights))
        overflow = overflow | of | (num_unique > out_cap)
        frontier = uids
        num_frontier = torch.clamp(num_unique, max=out_cap)
    blocks.reverse()
    return SampledBatch(blocks=tuple(blocks), input_nodes=frontier,
                        num_input=num_frontier, output_nodes=seeds,
                        num_output=num_seed, overflow=overflow)
