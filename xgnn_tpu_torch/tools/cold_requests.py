"""A model of the requests that the tiered K8a and K9 send to mapped host
memory.

The model counts a request for each distinct 32-byte sector that one warp
load instruction's lanes touch: lanes that read one sector share its
request, and another instruction that reads the same sector counts again.
It is a model, not a measurement: the link may answer a request from L2 or
in a line of 128 bytes, so what the card answers a second
(``tools/host_reads.py``) need not be in this unit.  These functions count
one call, from the call's inputs and the whole graph's CSR (the positions
that the kernels read), for the kernels' warp design
(``csrc/sampling.cu`` ``cold_rows_wr``, ``csrc/random_walk.cu``
``walk_tiered``): a ballot compacts a warp's cold rows, and lanes 2r and
2r + 1 read cold row r's int64 indptr pair, 16 rows an instruction.  K8a's
draws take a lane each, a row's draws in neighbouring lanes, 32 to an
instruction.  K9 reads each cold seed's pair once before the walk (asked
for by the seed's first lane in the warp), then at each step the pairs of
the cold nodes other than the seed that its walkers stand on, and one
index instruction a step for the walkers on cold nodes.

``chip_smoke.py`` (phase 12) prints the count beside the distinct sectors.
"""

from __future__ import annotations

import torch

EMPTY = 2**31 - 1
WARP = 32
PAIRS = 16  # cold rows whose indptr pairs one instruction reads
WALK_THREADS = 256  # kWalkThreads in csrc/random_walk.cu
BLOCK_VISITS = 2048  # a walk block's visits, at most


def _distinct(instr: torch.Tensor, sector: torch.Tensor) -> int:
    """The distinct (instruction, sector) pairs: the requests."""
    if instr.numel() == 0:
        return 0
    key = instr.long() * (int(sector.max()) + 1) + sector.long()
    return int(torch.unique(key).numel())


def _pairs(instr: torch.Tensor, node: torch.Tensor) -> int:
    """The requests of indptr pair reads: node's two int64 words in one
    instruction ``instr``."""
    node = node.long()
    return _distinct(torch.cat([instr, instr]),
                     torch.cat([node * 8 // 32, (node + 1) * 8 // 32]))


def _ranks(warp: torch.Tensor) -> torch.Tensor:
    """Each element's rank among the earlier elements of its warp
    (``warp`` nondecreasing): its place after the ballot's compaction."""
    if warp.numel() == 0:
        return warp
    _, counts = torch.unique_consecutive(warp, return_counts=True)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    return torch.arange(warp.numel(), device=warp.device) - first


def _rows(indptr, node, num_node, num_total):
    """``(cold, start, deg)`` of each node: cold in ``[num_node,
    num_total)``; start and degree from the whole graph's ``indptr``
    (degree 0 outside the graph)."""
    ok = (node >= 0) & (node < num_total)
    at = torch.where(ok, node, 0).long()
    start = indptr[at].long()
    deg = torch.where(ok, indptr[at + 1].long() - start, 0)
    return ok & (node >= num_node), start, deg


def _offset(u, deg):
    """A draw's offset in a row of degree ``deg`` > 0, in float32 as the
    kernels take it (``draw_wr``, ``step_offset``); 0 where ``deg`` is 0."""
    off = torch.floor(u * deg.to(torch.float32)).long()
    return torch.minimum(off, deg - 1).clamp(min=0)


def wr_requests(indptr, frontier, u, num_node: int, num_total: int) -> int:
    """K8a's requests for one call (uniform_wr and khop1 read alike):
    ``frontier`` ``(B,)`` int32, ``u`` ``(B, K)`` float32 and the whole
    graph's ``indptr``, on one device; ``num_node`` the hot prefix's
    nodes."""
    k = u.shape[1]
    cold, start, deg = _rows(indptr, frontier, num_node, num_total)
    rows = torch.nonzero(cold).reshape(-1)
    v, start, deg = frontier[rows], start[rows], deg[rows]
    warp = rows // WARP
    r = _ranks(warp)
    live = deg > 0
    sector = ((start[:, None] + _offset(u[rows], deg[:, None])) * 4 // 32)
    # a draw's place among its warp's: lane draw % 32 of instruction
    # draw // 32
    draw = r[:, None] * k + torch.arange(k, device=u.device)
    return (_pairs(warp * 2 + r // PAIRS, v)
            + _distinct((warp[:, None] * k + draw // WARP)[live],
                        sector[live]))


def walk_requests(indptr, indices, frontier, u_step, u_restart,
                  restart_prob: float, num_node: int,
                  num_total: int) -> int:
    """K9's requests for one call: ``frontier`` ``(B,)`` int32, ``u_step``
    and ``u_restart`` ``(L, B, W)`` float32, and the whole graph's
    ``indptr`` and ``indices``, on one device.  Walker w of row b is thread
    ``(b % rows) * W + w`` of block ``b // rows``, as ``launch_walk`` lays
    them out."""
    steps, b, w = u_step.shape
    dev = frontier.device
    rows = WALK_THREADS // w
    if rows * w * steps > BLOCK_VISITS:
        rows = BLOCK_VISITS // (w * steps)
    row = torch.arange(b, device=dev)[:, None]
    walker = torch.arange(w, device=dev)[None, :]
    t = (row % rows) * w + walker
    warp = ((row // rows) * (WALK_THREADS // WARP) + t // WARP).reshape(-1)
    lane = (t % WARP).reshape(-1)
    seed = frontier[:, None].expand(b, w).reshape(-1)
    p = torch.tensor(restart_prob, dtype=torch.float32)
    seed_cold = _rows(indptr, seed, num_node, num_total)[0]
    lead = seed_cold & ((walker.expand(b, w).reshape(-1) == 0) | (lane == 0))
    g = warp[lead]
    n = _pairs(g * 2 + _ranks(g) // PAIRS, seed[lead])
    cur = seed
    for s in range(steps):
        if s:
            cur = torch.where(u_restart[s].reshape(-1) < p, seed, cur)
        cold, start, deg = _rows(indptr, cur, num_node, num_total)
        live = deg > 0
        pos = start + _offset(u_step[s].reshape(-1), deg)
        ask = cold & (cur != seed)
        g = warp[ask]
        n += _pairs(g * 2 + _ranks(g) // PAIRS, cur[ask])
        read = cold & live
        n += _distinct(warp[read], pos[read] * 4 // 32)
        nxt = torch.where(live, indices[torch.where(live, pos, 0)], EMPTY)
        cur = torch.where(nxt == EMPTY, seed, nxt)
    return n
