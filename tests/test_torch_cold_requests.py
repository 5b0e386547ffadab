"""The modelled request counts of the tiered K8a and K9 cold reads
(``xgnn_tpu_torch/tools/cold_requests.py``) against a count made warp by
warp and instruction by instruction, as the kernels send them, on a small
graph with cold rows of degree 0, repeated cold seeds, ids outside the
graph and a partial last warp."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xgnn_tpu_torch.tools import cold_requests  # noqa: E402

EMPTY = cold_requests.EMPTY
NUM_NODE, NUM_TOTAL = 400, 600  # hot prefix, whole graph


def _graph():
    rng = np.random.default_rng(3)
    deg = rng.integers(0, 40, NUM_TOTAL)
    deg[[401, 450, 599]] = 0  # cold rows of degree 0
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    indices = rng.integers(0, NUM_TOTAL, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _frontier(n, seed):
    """``n`` ids (``n`` >= 202; a partial last warp where 32 does not
    divide it)."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, NUM_TOTAL, n)
    f[40:75] = 500  # one cold seed again and again, across warps
    f[100:140] = rng.integers(NUM_NODE, NUM_TOTAL, 40)  # a cold warp
    f[[3, 77, 201]] = [EMPTY, -3, NUM_TOTAL + 2]
    f[[5, 6]] = [401, 599]
    return f.astype(np.int32)


def _offset(u, deg):
    return min(int(np.floor(np.float32(u) * np.float32(deg))), deg - 1)


def _row(indptr, v):
    if not 0 <= v < NUM_TOTAL:
        return 0, 0
    return int(indptr[v]), int(indptr[v + 1] - indptr[v])


def _cold(v):
    return NUM_NODE <= v < NUM_TOTAL


def _pair_sectors(nodes):
    return {s for v in nodes for s in (v * 8 // 32, (v + 1) * 8 // 32)}


def _wr_brute(indptr, frontier, u):
    b, k = u.shape
    total = 0
    for w0 in range(0, b, 32):
        cold = [i for i in range(w0, min(w0 + 32, b)) if _cold(frontier[i])]

        def sector(i, j):
            start, deg = _row(indptr, frontier[i])
            return None if deg == 0 else (start + _offset(u[i, j], deg)) // 8

        for h in (0, 16):  # lanes 2r, 2r + 1 read row r's pair
            total += len(_pair_sectors(frontier[i] for i in cold[h:h + 16]))
        draws = [sector(i, j) for i in cold for j in range(k)]
        for q in range(0, len(draws), 32):
            total += len({s for s in draws[q:q + 32] if s is not None})
    return total


def _walk_brute(indptr, indices, frontier, u_step, u_restart, p):
    steps, b, w = u_step.shape
    rows = 256 // w
    if rows * w * steps > 2048:
        rows = 2048 // (w * steps)
    # the warps of each block, each a list of (row, walker) by lane
    warps = {}
    for r in range(b):
        for k in range(w):
            t = (r % rows) * w + k
            warps.setdefault((r // rows, t // 32), []).append((r, k))
    p = np.float32(p)
    total = 0
    for lanes in warps.values():
        seed = {(r, k): int(frontier[r]) for r, k in lanes}
        cur = dict(seed)
        lead = [seed[(r, k)] for i, (r, k) in enumerate(lanes)
                if (k == 0 or i == 0) and _cold(seed[(r, k)])]
        for h in (0, 16):
            total += len(_pair_sectors(lead[h:h + 16]))
        for s in range(steps):
            if s:
                for r, k in lanes:
                    if np.float32(u_restart[s, r, k]) < p:
                        cur[(r, k)] = seed[(r, k)]
            on_cold = [(r, k) for r, k in lanes if _cold(cur[(r, k)])]
            ask = [cur[x] for x in on_cold if cur[x] != seed[x]]
            for h in (0, 16):
                total += len(_pair_sectors(ask[h:h + 16]))
            reads = set()
            for r, k in lanes:
                start, deg = _row(indptr, cur[(r, k)])
                nxt = EMPTY
                if deg > 0:
                    e = start + _offset(u_step[s, r, k], deg)
                    nxt = int(indices[e])
                    if _cold(cur[(r, k)]):
                        reads.add(e // 8)
                cur[(r, k)] = seed[(r, k)] if nxt == EMPTY else nxt
            total += len(reads)
    return total


@pytest.mark.parametrize("b", [300, 205])
@pytest.mark.parametrize("k", [5, 7, 15, 33])
def test_wr_requests_equal_a_count_lane_by_lane(b, k):
    indptr, _ = _graph()
    frontier = _frontier(b, k)
    u = np.random.default_rng(k).random((b, k), dtype=np.float32)
    u[10:20] = u[10:20, :1]  # every draw of these rows repeats
    got = cold_requests.wr_requests(
        torch.from_numpy(indptr), torch.from_numpy(frontier),
        torch.from_numpy(u), NUM_NODE, NUM_TOTAL)
    assert got == _wr_brute(indptr, frontier, u)
    assert got > 0


@pytest.mark.parametrize("b", [250, 203])
@pytest.mark.parametrize("w,l,restart", [(4, 3, 0.5), (4, 3, 0.0),
                                         (4, 3, 1.0), (3, 5, 0.5),
                                         (1, 2, 0.3), (8, 8, 0.5)])
def test_walk_requests_equal_a_count_lane_by_lane(b, w, l, restart):
    indptr, indices = _graph()
    frontier = _frontier(b, w * l)
    rng = np.random.default_rng(w + 10 * l)
    u_step, u_restart = (rng.random((l, b, w), dtype=np.float32)
                         for _ in range(2))
    got = cold_requests.walk_requests(
        torch.from_numpy(indptr), torch.from_numpy(indices),
        torch.from_numpy(frontier), torch.from_numpy(u_step),
        torch.from_numpy(u_restart), restart, NUM_NODE, NUM_TOTAL)
    assert got == _walk_brute(indptr, indices, frontier, u_step, u_restart,
                              restart)
    assert got > 0
