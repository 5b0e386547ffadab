"""XGNN's two-phase GGMS over the cards: a partial feature cache spread over
every card's memory, the other rows read in place from pinned host memory.

The port of ``xgnn_tpu/parallel/ggms.py``'s feature side: ``build_cache``
(line 217), ``cache_split`` (:134) and ``combine_miss`` (:206).  The top
``int(num_node * cache_percentage)`` nodes of a ranking get cache
positions ``0..K-1`` in rank order (``posmap``, replicated on every rank).
With a partitioned cache (``part_cache``, XGNN) position ``p`` lives on
rank ``p % P`` at row ``p // P``, so the hottest rows spread round-robin
over the cards; replicated (SGNN) every rank holds the whole cache.

A TPU program cannot read host memory, so JAX splits each step in two: its
program A serves the hits and compacts the miss ids, the host gathers the
miss rows, and its program B scatters them in.  An H100 reads pinned,
mapped host memory from a kernel, so here nothing waits on the host:

    K11's split in its position form (the cache position of each input,
    EMPTY on a miss; the exact counts; the compacted miss positions and
    ids) -> the owner exchange over cache positions (K13-plan, two
    ``all_to_all_single``, K1's serve and pick; zero rows at misses) ->
    K11's direct reads of the miss rows into the same rows.

Replicated, the split and the reads are the single store's K11 over the
rank's whole cache.  There is no miss bucket (JAX's ``miss_cap`` and its
overflow): the reads take as many rows as the count on the device says.
The host table is one copy a host, which the host's ranks share, each
registering it for its card
(:class:`~xgnn_tpu_torch.ops.tiered.MappedHostTable` with the engine's
mesh, ``store/host_shared.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..device import to_tensor
from ..ops.tiered import (
    MappedHostTable,
    tiered_combine_plain,
    tiered_extract,
    tiered_split,
    tiered_split_positions,
)
from .exchange import partitioned_gather
from .mesh import Mesh

EMPTY = C.EMPTY_KEY


def build_cache(host: MappedHostTable, ranking, cache_percentage: float,
                num_parts: int, part: int, device,
                dtype: Optional[torch.dtype] = None):
    """``(posmap, cache_part, num_cache)`` on ``device``: the node-to-
    position map ``(num_node,)`` int32, this rank's rows of the interleaved
    cache, ``shard_interleaved(rows, num_parts)[part]`` (``(ceil(K / P),
    F)``, zero padded; ``(1, F)`` zeros for an empty cache, as JAX's), and
    the cache size ``K``.  ``num_parts=1, part=0`` gives the whole cache
    (SGNN).  The rows are read from the host table by K11's all-miss form,
    in ``dtype`` (by default the host table's)."""
    num_node = host.tensor.shape[0]
    num_cache = int(num_node * min(max(cache_percentage, 0.0), 1.0))
    cache_ids = to_tensor(np.asarray(ranking[:num_cache]), device,
                          torch.int32)
    posmap = torch.full((num_node,), EMPTY, dtype=torch.int32, device=device)
    posmap[cache_ids.long()] = torch.arange(num_cache, dtype=torch.int32,
                                            device=device)
    rows = max(-(-num_cache // num_parts), 1)
    ids = torch.full((rows,), EMPTY, dtype=torch.int32, device=device)
    own = cache_ids[part::num_parts]
    ids[:own.shape[0]] = own
    cache_part, _ = tiered_extract(ids, rows, None, None, host, dtype)
    return posmap, cache_part, num_cache


def cache_split(posmap: torch.Tensor, cache_local: torch.Tensor,
                ids: torch.Tensor, num_input, mesh: Mesh, seg_cap: int,
                host: MappedHostTable, partitioned: bool = True):
    """``(hit_rows, miss_ids, miss_pos, counts, overflow)`` for this rank's
    requested ids (the first ``num_input`` read): the hit rows in request
    order with zero rows elsewhere, the misses' ids and positions in order
    (valid up to ``counts[1]``), the int32 ``(hits, misses)`` and the
    positions' exchange overflow.  Partitioned, the hits are served by
    their owners through the exchange; replicated (``cache_local`` the
    whole cache), by K11's split from the local cache, and nothing
    overflows."""
    if partitioned:
        pos, counts, miss_pos, miss_ids = tiered_split_positions(
            ids, num_input, posmap)
        hit_rows, overflow = partitioned_gather(cache_local, pos, mesh,
                                                seg_cap)
        return hit_rows, miss_ids, miss_pos, counts, overflow
    hit_rows, counts, miss_pos, miss_ids = tiered_split(
        ids, num_input, posmap, cache_local, host)
    return (hit_rows, miss_ids, miss_pos, counts,
            torch.zeros((), dtype=torch.bool, device=ids.device))


def combine_miss(hit_rows: torch.Tensor, miss_rows: torch.Tensor,
                 miss_pos: torch.Tensor, num_miss) -> torch.Tensor:
    """JAX's combine: a copy of ``hit_rows`` with ``miss_rows[j]`` (cast to
    its type) at ``miss_pos[j]`` for ``j < num_miss``; the plain
    counterpart of K11's direct reads, given the rows gathered on the
    host."""
    return tiered_combine_plain(hit_rows.clone(), miss_rows, miss_pos,
                                int(num_miss))
