"""The collocated multi-card step (XGNN's arch6), fused form.

The port of ``xgnn_tpu/parallel/collocated.py``'s fused shape
(``make_collocated_train_step``, lines 178-330, with ``_sample_any`` and
``_block0_via_picks``; ``make_fused_eval_step``, line 558): every rank
samples its own shard of the batch (over the replicated topology, or the
partitioned one through the owner exchange), reads its input rows from
the interleaved all-device feature store through the exchange, reads its
labels the same way, runs the forward and backward, and the ranks reduce
their gradients before the same update on every rank.

The reduction is JAX's seed-count-weighted sum, not DDP's plain mean:
``sum_r(g_r * w_r) / max(sum_r(w_r), 1)`` with ``w_r`` the rank's seed
count (``num_output``), and the same for the loss and the accuracy, so a
rank whose shard is exhausted (``num_output = 0``) weighs nothing.  The
gradients, the three weighted scalars and the overflow flag go in one
flattened ``all_reduce``; a step whose exchange or frontier overflowed on
any rank is skipped by every rank on the device, as the single store's
step is, and every rank learns it from the same reduction, so the ranks
stay in step for the engine's replay.

The two-phase GGMS form (a partial cache over the cards, the misses in host
memory; ``make_sample_split_step``, line 332, ``make_combine_train_step``,
:431, ``make_eval_step``, :511) keeps JAX's names, but no host gather lies
between its two halves: the sample-and-split half builds the input rows
whole, the cache's hits through the owner exchange over cache positions and
the misses read in place from pinned host memory by K11
(``parallel/ggms.py``), and the train half runs on them at once, on the
same stream.  With ``sanity_check`` each step adds JAX's ``"sanity"``
metric (``collocated.py:283-291, 399-402, 495-497``): ``ops/sanity``'s
violation flags of the rank's batch, max-reduced over the ranks in one more
``all_reduce``, so every rank reads the same flags and raises alike.  The
fused step's ``emit_input_nodes`` (JAX's node-access mode, :187, 292-296)
returns the rank's input frontier with its metrics; the sample-and-split
half always carries it, as JAX's packed batch does.  Nothing of either
waits on the host.  ``make_presample_step`` (:641) counts each rank's valid
inputs at their owner for the cache's ranking and for the calibration of
the capacities; ``make_presample_static_exact_step`` (:741) counts, for
``presample_static``, every node within L hops of each rank's seeds once a
batch, exactly, on either topology.  On a partitioned topology with a host
cold tier (``LocalTopo.tier``) every step samples through it: the topology
carries its cold side, so the steps take no tier arguments (JAX's
``num_cache_node``, ``host_sampler`` and ``cold_cap``).  JAX's
``put_replicated`` and ``put_sharded`` place a whole value on every chip of
one process's mesh; here each rank builds its own part where it runs
(``exchange.interleaved_part``, ``dist_topology.partition_part``).

Over DCN groups (``mesh`` a group's, ``mesh.make_mesh_2d``: JAX's
``dcn_axis``) the stores are partitioned over the group's ``G`` parts and
repeated in every group, so each exchange, and the exact presample's
gather and reduce by owner, stays in the group (``mesh``), while the
gradients' seed-weighted reduction, the metrics, the overflow flag, the
sanity flags and the frontier sizes are reduced over every rank
(``mesh.world``: JAX's ``grad_axes``).  Each rank counts its own batch
into its part's share of the access counts; the engine sums the groups'
shares (JAX's host sum over the group axis).  On a flat mesh the two are
one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import constants as C
import torch.distributed as dist

from ..ops import sanity
from ..ops.presample import (
    accumulate_freq,
    closure_expand,
    closure_known,
    closure_parts,
)
from ..ops.tiered import tiered_direct
from ..sampler import _layer_fanouts, _sample_minibatch
from ..train import Adam, loss_fn
from ..types import Block
from . import ggms
from .dist_topology import sample_minibatch_partitioned
from .exchange import (
    local_rows_of,
    partitioned_gather,
    partitioned_gather_indirect,
    plan_exchange,
)
from .mesh import Mesh

EMPTY = C.EMPTY_KEY


def rw_params(config) -> tuple:
    return (config.num_random_walk, config.random_walk_length,
            config.random_walk_restart_prob)


def sample_any(topo, seeds: torch.Tensor, num_seed, config, capacities,
               seg_cap: int, mesh: Mesh, use_dist_graph: bool,
               generator: Optional[torch.Generator] = None):
    """One rank's batch: over the partitioned topology (a ``LocalTopo``)
    through the owner exchange, or over the replicated one (a ``Graph``),
    every layer deduplicated (no direct extract: the first layer reads the
    exchange's response)."""
    fanouts, caps = _layer_fanouts(config), tuple(int(c) for c in capacities)
    if use_dist_graph:
        return sample_minibatch_partitioned(
            topo, seeds, num_seed, mesh, seg_cap=seg_cap,
            sample_type=config.sample_type, fanouts=fanouts, capacities=caps,
            rw_params=rw_params(config), generator=generator)
    return _sample_minibatch(topo, seeds, num_seed,
                             sample_type=config.sample_type, fanouts=fanouts,
                             capacities=caps, rw_params=rw_params(config),
                             generator=generator)


def block0_via_picks(block: Block, pick: torch.Tensor,
                     input_nodes: torch.Tensor) -> Block:
    """The input layer's block in direct-extract form against the
    exchange's response buffer: its picks and dst rows read the buffer
    through ``pick``, so no request-order copy of the rows exists.  EMPTY
    stays EMPTY, and a dst row past the valid frontier gets EMPTY (a zero
    row, as K1 gives it)."""
    valid = block.neigh != EMPTY
    safe = torch.clamp(torch.where(valid, block.neigh, 0), max=pick.shape[0]
                       - 1).long()
    neigh = torch.where(valid, pick[safe], EMPTY)
    dst = pick[:block.dst_cap]
    dst_ids = torch.where(input_nodes[:block.dst_cap] != EMPTY, dst, EMPTY)
    return dataclasses.replace(block, neigh=neigh, dst_ids=dst_ids)


def exchange_inputs(batch, feat_part: torch.Tensor, label_part: torch.Tensor,
                    mesh: Mesh, seg_cap: int):
    """``(blocks, x, labels, overflow)``: the batch's input rows through
    the exchange (``x`` the response buffer, the first block reading it
    through the pick), its labels in seed order, and the step's overflow
    (the exchanges' and the sampler's) on this rank."""
    xbuf, xpick, x_of = partitioned_gather_indirect(
        feat_part, batch.input_nodes, mesh, seg_cap)
    blocks = (block0_via_picks(batch.blocks[0], xpick, batch.input_nodes),
              ) + tuple(batch.blocks[1:])
    labels, l_of = partitioned_gather(label_part, batch.output_nodes, mesh,
                                      seg_cap)
    return blocks, xbuf, labels[:, 0], x_of | l_of | batch.overflow


def lane_loss_and_grads(model, params: Sequence[torch.Tensor], blocks, x,
                        labels, num_output, generator=None):
    """One rank's loss, accuracy and gradients, before any reduction."""
    logits = model(blocks, x, train=True, generator=generator)
    loss, acc = loss_fn(logits, labels, num_output)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), acc.detach(), grads


def weighted_flat(grads, loss, acc, num_output, overflow) -> torch.Tensor:
    """One lane's share of the seed-weighted reduction, flattened: its
    gradients, loss and accuracy times its seed count ``w``, then ``w`` and
    its overflow flag."""
    w = num_output.to(torch.float32).reshape(())
    return torch.cat([g.reshape(-1) * w for g in grads]
                     + [torch.stack([loss * w, acc * w, w,
                                     overflow.to(torch.float32)])])


def unflatten_weighted(flat: torch.Tensor, grads):
    """``(grads, loss, acc, skip)`` from the lanes' summed
    :func:`weighted_flat`: each sum over ``max(sum(w), 1)``, and whether
    any lane overflowed."""
    n = flat.shape[0] - 4
    wsum = torch.clamp(flat[n + 2], min=1.0)
    out, at = [], 0
    for g in grads:
        out.append((flat[at:at + g.numel()] / wsum).reshape(g.shape))
        at += g.numel()
    return out, flat[n] / wsum, flat[n + 1] / wsum, flat[n + 3] > 0


def reduce_weighted(mesh: Mesh, grads, loss, acc, num_output, overflow):
    """``(grads, loss, acc, skip)``: ``sum_r(v_r * w_r) / max(sum_r(w_r),
    1)`` of each, ``w_r`` the seed counts of every rank of the world, and
    whether any rank overflowed, all in one ``all_reduce``."""
    flat = weighted_flat(grads, loss, acc, num_output, overflow)
    mesh.world.all_reduce(flat)
    return unflatten_weighted(flat, grads)


def _train_on(model, opt: Adam, mesh: Mesh, blocks, x, labels, num_output,
              overflow, drop_generator):
    """One update from this rank's batch: the loss and gradients, their
    seed-weighted reduction and Adam's step, skipped on every rank where
    any overflowed; the metrics, the loss and accuracy NaN when skipped."""
    loss, acc, grads = lane_loss_and_grads(model, opt.params, blocks, x,
                                           labels, num_output,
                                           drop_generator)
    grads, loss, acc, skip = reduce_weighted(mesh, grads, loss, acc,
                                             num_output, overflow)
    opt.step(grads, skip)
    nan = torch.full_like(loss, float("nan"))
    return {"loss": torch.where(skip, nan, loss),
            "acc": torch.where(skip, nan, acc), "overflow": skip}


def reduced_flags(mesh: Mesh, flags: torch.Tensor) -> torch.Tensor:
    """A rank's sanity flags max-reduced over every rank of the world
    (every rank runs it, so the collectives meet), a device int32
    scalar."""
    flags = flags.to(torch.int32).reshape(1).clone()
    mesh.world.all_reduce(flags, dist.ReduceOp.MAX)
    return flags.reshape(())


def _count_correct(mesh: Mesh, logits, labels, num_output, overflow):
    """``(correct, total, overflow)`` summed over the ranks; a step that
    overflowed anywhere counts 0 of both."""
    n = logits.shape[0]
    mask = torch.arange(n, device=logits.device) < num_output
    correct = ((torch.argmax(logits, -1) == labels) & mask).sum()
    v = torch.stack([correct.to(torch.float32),
                     num_output.to(torch.float32).reshape(()),
                     overflow.to(torch.float32)])
    mesh.world.all_reduce(v)
    keep = (v[2] == 0).to(torch.float32)
    return v[0] * keep, v[1] * keep, v[2] > 0


def make_collocated_train_step(model, opt: Adam, config, mesh: Mesh,
                               capacities, seg_cap: int,
                               use_dist_graph: bool = False,
                               emit_input_nodes: bool = False):
    """The fused step: ``step(topo, feat_part, label_part, seeds, num_seed,
    generator, drop_generator) -> {"loss", "acc", "overflow",
    "num_input"}``, device scalars, all but the rank's input count equal on
    every rank (the loss and accuracy NaN where the step was skipped), with
    ``"sanity"`` (the ranks' max-reduced flags) under
    ``config.sanity_check`` and the rank's ``"input_nodes"`` under
    ``emit_input_nodes``.  Nothing waits on the host."""

    def step(topo, feat_part, label_part, seeds, num_seed, generator=None,
             drop_generator=None):
        batch = sample_any(topo, seeds, num_seed, config, capacities,
                           seg_cap, mesh, use_dist_graph, generator)
        blocks, x, labels, overflow = exchange_inputs(batch, feat_part,
                                                      label_part, mesh,
                                                      seg_cap)
        out = _train_on(model, opt, mesh, blocks, x, labels,
                        batch.num_output, overflow, drop_generator)
        out["num_input"] = batch.num_input
        if config.sanity_check:
            out["sanity"] = reduced_flags(mesh, sanity.check_batch(batch))
        if emit_input_nodes:
            out["input_nodes"] = batch.input_nodes
        return out

    return step


def make_fused_eval_step(model, config, mesh: Mesh, capacities,
                         seg_cap: int, use_dist_graph: bool = False):
    """The forward-only fused step: ``step(topo, feat_part, label_part,
    seeds, num_seed, generator) -> (correct, total, overflow)``, summed over
    the ranks; a step that overflowed anywhere counts 0 of both (the engine
    runs it again at grown capacities)."""

    @torch.no_grad()
    def step(topo, feat_part, label_part, seeds, num_seed, generator=None):
        batch = sample_any(topo, seeds, num_seed, config, capacities,
                           seg_cap, mesh, use_dist_graph, generator)
        blocks, x, labels, overflow = exchange_inputs(batch, feat_part,
                                                      label_part, mesh,
                                                      seg_cap)
        logits = model(blocks, x, train=False)
        return _count_correct(mesh, logits, labels, batch.num_output,
                              overflow)

    return step


# ------------------------------------------------------- the two-phase GGMS
def make_sample_split_step(config, mesh: Mesh, capacities, seg_cap: int,
                           use_dist_graph: bool = False,
                           partitioned_cache: bool = True):
    """The sampling half of the two-phase step: ``step(topo, posmap,
    cache_part, label_part, host, seeds, num_seed, generator) -> dict``
    with the batch's ``blocks``, its input rows ``x`` in input-node order
    (the cache's hits, then the misses read in place from the mapped host
    table ``host``: no host gather follows), its ``labels``, ``num_output``,
    ``num_input``, ``num_hit`` and ``num_miss`` (device int32), its
    ``input_nodes``, the step's ``overflow`` on this rank (the sampler's,
    the cache positions' exchange and the labels') and, under
    ``config.sanity_check``, the rank's ``sanity`` flags."""

    def step(topo, posmap, cache_part, label_part, host, seeds, num_seed,
             generator=None):
        batch = sample_any(topo, seeds, num_seed, config, capacities,
                           seg_cap, mesh, use_dist_graph, generator)
        hit_rows, miss_ids, miss_pos, counts, c_of = ggms.cache_split(
            posmap, cache_part, batch.input_nodes, batch.num_input, mesh,
            seg_cap, host, partitioned_cache)
        x = tiered_direct(hit_rows, miss_ids, miss_pos, counts, host)
        labels, l_of = partitioned_gather(label_part, batch.output_nodes,
                                          mesh, seg_cap)
        out = {"blocks": batch.blocks, "x": x, "labels": labels[:, 0],
               "num_output": batch.num_output, "num_input": batch.num_input,
               "input_nodes": batch.input_nodes,
               "num_hit": counts[0], "num_miss": counts[1],
               "overflow": batch.overflow | c_of | l_of}
        if config.sanity_check:
            out["sanity"] = sanity.check_batch(batch)
        return out

    return step


def make_combine_train_step(model, opt: Adam, config, mesh: Mesh):
    """The training half: ``step(outs, drop_generator) -> {"loss", "acc",
    "overflow", "num_input", "num_hit", "num_miss"}`` (and the max-reduced
    ``"sanity"`` under ``config.sanity_check``) on what
    :func:`make_sample_split_step` built, as the fused step trains (the
    input rows are whole already: JAX's ``combine_miss`` has nothing left
    to do)."""

    def step(outs, drop_generator=None):
        out = _train_on(model, opt, mesh, outs["blocks"], outs["x"],
                        outs["labels"], outs["num_output"], outs["overflow"],
                        drop_generator)
        out.update({k: outs[k] for k in ("num_input", "num_hit",
                                         "num_miss")})
        if config.sanity_check:
            out["sanity"] = reduced_flags(mesh, outs["sanity"])
        return out

    return step


def make_eval_step(model, mesh: Mesh):
    """The forward-only training half: ``step(outs) -> (correct, total,
    overflow)``, summed over the ranks as the fused eval step sums them."""

    @torch.no_grad()
    def step(outs):
        logits = model(outs["blocks"], outs["x"], train=False)
        return _count_correct(mesh, logits, outs["labels"],
                              outs["num_output"], outs["overflow"])

    return step


def make_presample_step(config, mesh: Mesh, capacities, seg_cap: int,
                        use_dist_graph: bool = False):
    """``step(freq_part, topo, seeds, num_seed, generator) -> (freq_part,
    sizes)``: sample this rank's shard, send each valid input to its owner
    (K13-plan, ``all_to_all_single``) and count it there into the owner's
    interleaved share of the access counts, ``freq_part`` ``(ceil(N / P),)``
    int32, in place (K12); ``sizes`` the batch's frontier sizes (the seeds,
    then each layer's sources from the last), max-reduced over every rank.
    Over DCN groups the owners are the group's: each group counts its own
    batches, and the engine sums the groups' shares.  The counting
    exchange's segment takes every input (``max(seg_cap,
    capacities[-1])``): an over-cap request would go uncounted, and the
    hottest nodes are the ones the ranking exists to find."""
    count_seg_cap = max(int(seg_cap), int(capacities[-1]))

    def step(freq_part, topo, seeds, num_seed, generator=None):
        batch = sample_any(topo, seeds, num_seed, config, capacities,
                           seg_cap, mesh, use_dist_graph, generator)
        ids = batch.input_nodes
        live = torch.arange(ids.shape[0], device=ids.device) < batch.num_input
        masked = torch.where(live, ids, EMPTY)
        seg = max(min(count_seg_cap, ids.shape[0]), 1)
        plan = plan_exchange(masked, mesh.size, seg)
        req = mesh.all_to_all(plan.send.reshape(-1))
        accumulate_freq(freq_part, local_rows_of(req, mesh.size),
                        req.shape[0])
        sizes = torch.stack(
            [batch.num_output.to(torch.int32).reshape(())]
            + [b.num_src.to(torch.int32).reshape(())
               for b in reversed(batch.blocks)])
        mesh.world.all_reduce(sizes, dist.ReduceOp.MAX)
        return freq_part, sizes

    return step


def make_presample_static_exact_step(config, mesh: Mesh, num_node: int,
                                     seed_cap: int,
                                     use_dist_graph: bool = False):
    """The exact all-neighbour presample over the cards (the reference's
    ``DoGPUSampleAllNeighbour``): ``step(freq_part, topo, seeds, num_seed,
    generator) -> (freq_part, sizes)`` adds to this rank's interleaved
    share of the counts, in place, 1 for every node within
    ``len(config.fanout)`` hops of each rank's first ``num_seed`` seeds (of
    at most ``seed_cap``), once a rank's batch; ``sizes`` is zeros (the
    closure runs after the calibration) and the generator is not read.

    Partitioned (``use_dist_graph``, no cold tier): the ranks' seeds are
    gathered, each rank marks the seeds it owns in a lane a rank, and a
    layer is K12b's partitioned form over the rank's local rows (their
    edges marked at their global destinations, owner-major, except the
    marks the rank knows are held: its known set, zeroed a batch) and one
    reduce by owner, which returns each rank its rows' marks from every
    rank.
    Replicated: the rank closes its own batch over the whole CSR with the
    single store's K12b, and one reduce by owner sums the lanes' marks into
    the shares.  JAX's ``psum_scatter``; gloo, with no reduce-scatter,
    reduces the whole buffer and keeps this rank's row.  Over DCN groups
    the gather and the reduces are the group's, over its own lanes; the
    engine sums the groups' shares."""
    num_layer = len(config.fanout)

    def step(freq_part, topo, seeds, num_seed, generator=None):
        del generator  # the closure draws nothing
        p, dev = mesh.size, freq_part.device
        rows = freq_part.shape[0]
        seeds = seeds.reshape(-1)[:seed_cap]
        live = torch.arange(seeds.shape[0], device=dev) < \
            torch.as_tensor(num_seed, device=dev)
        sg = torch.where(live, seeds, EMPTY)
        if use_dist_graph:
            every = mesh.all_gather(sg)  # (P lanes, S)
            mine = (every != EMPTY) & (torch.remainder(every, p)
                                       == mesh.rank)
            at = torch.where(mine, torch.div(every, p, rounding_mode="floor"),
                             rows).long()
            recv = torch.zeros((p, rows + 1), dtype=torch.uint8, device=dev)
            recv.scatter_(1, at, 1)
            recv = recv[:, :rows].contiguous()
            level = torch.zeros((p, rows), dtype=torch.uint8, device=dev)
            known = closure_known(rows, p, dev)
            for layer in range(num_layer):
                out = closure_parts(topo.indptr, topo.indices, level, recv,
                                    layer + 1, num_node, mesh.rank, known)
                recv = mesh.reduce_scatter(out)
            closure_parts(topo.indptr, topo.indices, level, recv,
                          num_layer + 1, num_node, mesh.rank, known,
                          counts=freq_part)
        else:
            mask = torch.zeros(rows * p, dtype=torch.int32, device=dev)
            closure_expand(topo.indptr, topo.indices, sg, num_layer,
                           mask[:num_node])
            # node r * P + o is owner o's row r
            freq_part += mesh.reduce_scatter(mask.view(rows, p).t())
        return freq_part, torch.zeros(num_layer + 1, dtype=torch.int32,
                                      device=dev)

    return step
