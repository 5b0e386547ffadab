"""K9: restart random walks with top-K visit counts (PinSAGE's sampler).

The port of ``xgnn_tpu/ops/random_walk.py``'s ``sample_random_walk`` with
``_uniform_step``, untiered and tiered.  Per seed, W walkers take L
steps; before each step after the first a walker restarts at its seed with
probability ``restart_prob``, and a step is one uniform draw with
replacement (:func:`~xgnn_tpu_torch.ops.sampling.sample_uniform_wr` at
fanout 1).  A walker on EMPTY or on a node of degree 0 visits EMPTY and
returns to its seed.  The visits, walker-major, are counted; a visit equal
to the seed does not count.  The K most-visited distinct nodes come back
with their counts as float32 edge weights, ties to the first occurrence;
slots past the distinct visits are EMPTY with weight 0.

``u = (u_step, u_restart)``, each ``(L, B, W)`` float32, are the uniforms
the JAX function draws: at each step ``key, k_step, k_restart =
split(key, 3)``, then ``uniform(k_step, (B, W))`` and, past step 0,
``uniform(k_restart, (B, W))`` (``u_restart[0]`` is not read).  Given
them, the result equals the JAX package's bit for bit: the draws are
float32 as there, and the restart compares in float32 against
``float32(restart_prob)``.  A frontier id outside ``[0, num_node)`` other
than EMPTY is outside the contract, as for K2: it has degree 0.

On a tiered topology (``tier=``, as for
:func:`~xgnn_tpu_torch.ops.sampling.sample_khop0`) a walker standing on a
cold node ``num_cache_node <= v < tier.csr.num_node`` takes its step from
the whole graph's CSR in pinned, mapped host memory, in the same launch,
with the same uniform: the walk equals the untiered walk over the whole
CSR (JAX splits each step into the device's hot step and a host callback,
``xgnn_tpu/ops/random_walk.py:83-103``).

The CUDA kernel is ``csrc/random_walk.cu``; it keeps at most 64 visits a
seed, so ``W * L <= 64`` (a limit the JAX package does not have, ROADMAP
section 3), and ``fanout <= W * L`` as ``lax.top_k`` requires.
:func:`sample_random_walk_plain` is its plain PyTorch version, which the
wrapper takes only for tensors on the CPU.  Launches are counted as
``random_walk``.  :func:`walk_topk` is the count and the ranking alone,
over visits walked elsewhere (the partitioned walk, whose steps are
exchanges), with :func:`walk_topk_plain` beside it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .. import constants as C
from . import _build
from .sampling import _check_tier, _cold_args, _on, _per_tier, _tables

EMPTY = C.EMPTY_KEY
_NAME = "random_walk"
MAX_VISITS = 64  # kMaxVisits in csrc/random_walk.cu


def _walk_step(indptr: torch.Tensor, indices: torch.Tensor,
               cur: torch.Tensor, u: torch.Tensor, tier=None) -> torch.Tensor:
    """One uniform step of every walker; EMPTY where it has no neighbour.
    A walker on a tier's cold node steps in the host CSR."""
    if tier is not None:
        return _per_tier(cur, tier, lambda csr, at: _walk_step(
            *_tables(csr, ("indptr", "indices"), (indptr, indices)), at,
            _on(u, at)))
    valid = (cur >= 0) & (cur < indptr.shape[0] - 1)
    node = torch.where(valid, cur, 0)
    start = indptr[node]
    deg = torch.where(valid, indptr[node + 1] - start, 0)
    # float32 u times int32 deg stays float32, as in the JAX function
    off = torch.minimum(torch.floor(u * deg).to(torch.int32),
                        torch.clamp(deg - 1, min=0))
    live = deg > 0
    return torch.where(live, indices[torch.where(live, start + off, 0)],
                       EMPTY)


def draw_uniforms(num_walk: int, walk_len: int, num_rows: int,
                  generator: Optional[torch.Generator] = None,
                  device=None):
    """``(u_step, u_restart)``, each ``(walk_len, num_rows, num_walk)``."""
    shape = (walk_len, num_rows, num_walk)
    return (torch.rand(shape, generator=generator, device=device),
            torch.rand(shape, generator=generator, device=device))


def sample_random_walk_plain(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    num_random_walk: int,
    random_walk_length: int,
    restart_prob: float,
    u: Optional[Sequence[torch.Tensor]] = None,
    tier=None,
):
    """The JAX function's steps over the whole ``(B, W)`` walker grid, then
    a ``(B, M, M)`` match count and a stable descending sort of the scores
    (the order ``lax.top_k`` gives)."""
    b = frontier.shape[0]
    w, l = num_random_walk, random_walk_length
    if u is None:
        u = draw_uniforms(w, l, b, generator, frontier.device)
    u_step, u_restart = u
    p = torch.tensor(restart_prob, dtype=torch.float32)
    seed2d = frontier[:, None].expand(b, w)
    cur = seed2d
    visits = []
    for s in range(l):
        if s > 0:
            cur = torch.where(u_restart[s] < p, seed2d, cur)
        nxt = _walk_step(indptr, indices, cur, u_step[s], tier)
        visits.append(nxt)
        cur = torch.where(nxt == EMPTY, seed2d, nxt)
    return walk_topk_plain(torch.stack(visits, dim=2), frontier, fanout)


def walk_topk_plain(visits: torch.Tensor, frontier: torch.Tensor,
                    fanout: int):
    """The count and the ranking of ``(B, W, L)`` visits: a visit equal to
    its seed does not count, then a ``(B, M, M)`` match count and a stable
    descending sort of the scores (the order ``lax.top_k`` gives)."""
    b, m = frontier.shape[0], visits.shape[1] * visits.shape[2]
    v = visits.reshape(b, m)  # walker-major
    v = torch.where(v == frontier[:, None], EMPTY, v)

    eq = v[:, :, None] == v[:, None, :]
    counts = eq.sum(2, dtype=torch.int32)
    earlier = torch.ones((m, m), dtype=torch.bool,
                         device=frontier.device).tril(-1)
    is_first = ~(eq & earlier).any(2) & (v != EMPTY)
    score = torch.where(is_first, counts, -1)
    top, idx = torch.sort(score, dim=1, descending=True, stable=True)
    top, idx = top[:, :fanout], idx[:, :fanout]
    live = top > 0
    neigh = torch.where(live, torch.gather(v, 1, idx), EMPTY)
    weights = torch.where(live, top, 0).to(torch.float32)
    return neigh, weights


def walk_topk(visits: torch.Tensor, frontier: torch.Tensor, fanout: int):
    """K9's count and ranking alone: ``(neigh, weights)`` of the ``(B, W,
    L)`` int32 visits (walker ``w``'s step ``s`` at ``[b, w, s]``, EMPTY
    where it had no step) of the ``(B,)`` frontier, as
    :func:`sample_random_walk` ranks its own walk's (the partitioned walk,
    ``parallel/dist_topology.py``).  Launches are counted as
    ``walk_topk``."""
    if (visits.dim() != 3 or visits.dtype != torch.int32
            or frontier.dim() != 1 or frontier.dtype != torch.int32
            or visits.shape[0] != frontier.shape[0]):
        raise ValueError(
            f"walk_topk: visits must be (B, W, L) int32 and frontier (B,) "
            f"int32, got {visits.dtype} {tuple(visits.shape)} and "
            f"{frontier.dtype} {tuple(frontier.shape)}")
    b, w, l = visits.shape
    if w < 1 or l < 1 or w * l > MAX_VISITS or not 1 <= fanout <= w * l:
        raise ValueError(
            f"walk_topk: {w} walks of {l} steps, fanout {fanout}: the kernel "
            f"keeps 1 to {MAX_VISITS} visits a seed and fanout <= W * L")
    if visits.device != frontier.device:
        raise ValueError("walk_topk: tensors on different devices")
    if frontier.device.type == "cpu":
        return walk_topk_plain(visits, frontier, fanout)
    if frontier.device.type != "cuda":
        raise ValueError(f"walk_topk: no kernel for {frontier.device}")
    visits, frontier = visits.contiguous(), frontier.contiguous()
    lib = _build.load("random_walk")
    neigh = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    weights = torch.empty((b, fanout), dtype=torch.float32,
                          device=frontier.device)
    if b:
        rc = lib.xg_walk_topk(visits.data_ptr(), frontier.data_ptr(),
                              neigh.data_ptr(), weights.data_ptr(), b, w, l,
                              fanout, _build.stream_handle(frontier.device))
        _build.check(rc, "walk_topk")
        _build.LAUNCHES.add("walk_topk")
    return neigh, weights


def _check(indptr, indices, frontier, fanout, w, l, u, tier):
    for name, t in (("indptr", indptr), ("indices", indices),
                    ("frontier", frontier)):
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(
                f"random_walk: {name} must be 1-D int32, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    if indptr.shape[0] < 1:
        raise ValueError("random_walk: indptr needs num_node + 1 entries")
    if w < 1 or l < 1 or w * l > MAX_VISITS:
        raise ValueError(
            f"random_walk: {w} walks of {l} steps: the kernel keeps 1 to "
            f"{MAX_VISITS} visits a seed (ROADMAP section 3)"
        )
    if not 1 <= fanout <= w * l:
        raise ValueError(
            f"random_walk: fanout {fanout} outside [1, {w * l}] (the visits "
            "a seed has)"
        )
    tensors = [indptr, indices, frontier]
    if u is not None:
        if len(u) != 2:
            raise ValueError("random_walk: u must be (u_step, u_restart)")
        for t in u:
            if (t.dtype != torch.float32
                    or tuple(t.shape) != (l, frontier.shape[0], w)):
                raise ValueError(
                    f"random_walk: u must hold two float32 "
                    f"{(l, frontier.shape[0], w)}, got {t.dtype} "
                    f"{tuple(t.shape)}"
                )
        tensors += list(u)
    if any(t.device != frontier.device for t in tensors):
        raise ValueError("random_walk: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("random_walk: tensors must be contiguous")
    if frontier.device.type not in ("cpu", "cuda"):
        raise ValueError(f"random_walk: no kernel for {frontier.device}")
    _check_tier(tier, indptr, frontier, ("indptr", "indices"), _NAME)


def sample_random_walk(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    frontier: torch.Tensor,
    fanout: int,
    generator: Optional[torch.Generator] = None,
    *,
    num_random_walk: int,
    random_walk_length: int,
    restart_prob: float,
    u: Optional[Sequence[torch.Tensor]] = None,
    tier=None,
):
    """``(neigh, weights)``: ``(B, fanout)`` int32 global ids, EMPTY
    padded, and their float32 visit counts, for the ``(B,)`` int32
    frontier.  ``u``: ``(u_step, u_restart)``; drawn from ``generator`` when
    not given, as the plain version draws them.  ``tier``: the tiered
    topology's cold side (module docstring)."""
    w, l = num_random_walk, random_walk_length
    _check(indptr, indices, frontier, fanout, w, l, u, tier)
    if frontier.device.type == "cpu":
        return sample_random_walk_plain(
            indptr, indices, frontier, fanout, generator,
            num_random_walk=w, random_walk_length=l,
            restart_prob=restart_prob, u=u, tier=tier,
        )
    b = frontier.shape[0]
    if u is None:
        u = draw_uniforms(w, l, b, generator, frontier.device)
    lib = _build.load("random_walk")
    neigh = torch.empty((b, fanout), dtype=torch.int32, device=frontier.device)
    weights = torch.empty((b, fanout), dtype=torch.float32,
                          device=frontier.device)
    if b:
        rc = lib.xg_random_walk(
            indptr.data_ptr(), indices.data_ptr(), frontier.data_ptr(),
            u[0].data_ptr(), u[1].data_ptr(), neigh.data_ptr(),
            weights.data_ptr(), indptr.shape[0] - 1, b, w, l, fanout,
            float(restart_prob),
            *_cold_args(tier, indptr, ("indptr", "indices")),
            _build.stream_handle(frontier.device),
        )
        _build.check(rc, _NAME)
        _build.LAUNCHES.add(_NAME)
    return neigh, weights
