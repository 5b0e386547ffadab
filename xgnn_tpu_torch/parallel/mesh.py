"""Process groups: one process a card, on ``torch.distributed``.

The port of ``xgnn_tpu/parallel/mesh.py`` (``make_mesh``, lines 26-35,
and ``make_mesh_2d``, :37-55).  JAX drives every chip of a host from one
process over a named mesh; the port runs XGNN's arch6 as the reference
does and as PyTorch does, one process a card, each rank holding its share
of the stores.  A :class:`Mesh` is a rank's view of a process group: its
rank in it, its size, its device and the collectives the collocated step
uses (``all_to_all`` with equal splits, a summed ``all_reduce``; the exact
presample's ``all_gather`` and ``reduce_scatter``, the latter an
``all_reduce`` of the whole and a slice on gloo, which has no
reduce-scatter).  NCCL runs on the card and gloo on the CPU; the device
decides, and nothing drops to the CPU or to gloo when CUDA or NCCL is
missing: it raises.

DCN groups (:func:`make_mesh_2d`, JAX's hierarchical mesh, the stand-in
for the reference's topology-aware ``PartitionSolver``): the world's
ranks fall into ``num_groups`` groups of ``G`` consecutive ranks, world
rank ``r`` in group ``r // G`` at part ``r % G``, as JAX reshapes its
devices to ``(num_groups, G)``.  A group's mesh carries the stores'
collectives (the exchanges, the presample's ``all_gather`` and
``reduce_scatter``), so they stay inside an NVLink island; its ``world``,
the mesh of every rank, carries the reductions that span the groups (the
gradients, the metrics, the flags).  A flat mesh is its own world.

Rendezvous goes through a file store in a fresh temporary directory,
never a fixed TCP port.  :func:`make_mesh` makes a world of one in the
caller's process (P = 1 needs no launcher); :func:`spawn` starts ``P``
ranks, one process each, runs a function in each and joins them under a
time limit, failing if one raises, dies or hangs (a rank that never
reaches a collective that the others wait in, a missed ``new_group``
among them, is a hang).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from ..device import resolve


def backend_for(device: torch.device) -> str:
    """NCCL on a card, gloo on the CPU; raises where it is missing."""
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "build of PyTorch")
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("the multi-card engine runs on NCCL on a "
                               "card, and this build of PyTorch has none")
        return "nccl"
    if device.type == "cpu":
        if not dist.is_gloo_available():
            raise RuntimeError("the multi-card engine runs on gloo on the "
                               "CPU, and this build of PyTorch has none")
        return "gloo"
    raise ValueError(f"no process group backend for {device}")


@dataclasses.dataclass
class Mesh:
    """A rank's view of a process group: the world (the default group), or
    one DCN group of it (``make_mesh_2d``)."""

    rank: int
    size: int
    device: torch.device
    backend: str
    # the group's handle; None for the default group, the world
    group: Optional[Any] = None
    # a DCN group's mesh: the mesh of every rank (``world``)
    parent: Optional["Mesh"] = None
    # the store's directory when this mesh made the group (make_mesh,
    # init_mesh): close() then ends the group and removes it
    _store_dir: Optional[str] = None

    @property
    def world(self) -> "Mesh":
        """The mesh of every rank: this one, unless it is a DCN group's."""
        return self if self.parent is None else self.parent

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send``'s rows in ``size`` equal segments, segment ``p`` to rank
        ``p``; returns the segments received, segment ``p`` from rank
        ``p``."""
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send.contiguous(), group=self.group)
        return out

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """In place over every rank of the group."""
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t``, stacked in rank order: ``(size,) +
        t.shape``."""
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, t.contiguous(), group=self.group)
        else:
            dist.all_gather(list(out.unbind(0)), t.contiguous(),
                            group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (``(size, ...)``, row ``p`` for rank ``p``) summed over the
        ranks: this rank's row of the sum.  NCCL reduce-scatters; gloo has
        no reduce-scatter, so it sums a copy of the whole of ``t`` and
        takes the row."""
        if self.backend == "nccl":
            out = torch.empty(tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            dist.reduce_scatter_tensor(out, t.contiguous(), group=self.group)
            return out
        whole = t.contiguous().clone()
        dist.all_reduce(whole, group=self.group)
        return whole[self.rank]

    def close(self):
        if self._store_dir is not None and dist.is_initialized():
            dist.destroy_process_group()
        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
            self._store_dir = None


def init_mesh(size: int, rank: int, init_method: str,
              device=None) -> Mesh:
    """Join a group of ``size`` ranks as ``rank`` through ``init_method``
    (a ``file://`` store), on ``device`` (the card by default)."""
    device = resolve(device)
    backend = backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank)
    return Mesh(rank, size, device, backend)


def make_mesh(device=None) -> Mesh:
    """The caller's process as a world of one (P = 1), on ``device`` (the
    card by default).  Where the process already belongs to a group, the
    mesh is its view of that group."""
    device = resolve(device)
    backend = backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process's group runs {dist.get_backend()}"
                               f", and {device} needs {backend}")
        return Mesh(dist.get_rank(), dist.get_world_size(), device, backend)
    store = tempfile.mkdtemp(prefix="xgnn_mesh_")
    try:
        mesh = init_mesh(1, 0, f"file://{os.path.join(store, 'store')}",
                         device)
    except BaseException:
        shutil.rmtree(store, ignore_errors=True)
        raise
    mesh._store_dir = store
    return mesh


def make_mesh_2d(num_groups: int, mesh: Mesh) -> Mesh:
    """This rank's DCN group of the world ``mesh`` (JAX's hierarchical
    mesh, ``xgnn_tpu/parallel/mesh.py:37-55``): ``num_groups`` groups of
    ``G = mesh.size // num_groups`` consecutive ranks, world rank ``r`` in
    group ``r // G`` at part ``r % G``.  Its ``world`` is ``mesh``; one
    group is ``mesh`` itself.  Every rank makes every group, in the same
    order (``new_group`` waits for all of them)."""
    if num_groups < 1 or mesh.size % num_groups:
        raise ValueError(f"{mesh.size} ranks do not fall into {num_groups} "
                         "DCN groups of equal size")
    if num_groups == 1:
        return mesh
    g = mesh.size // num_groups
    groups = [dist.new_group(list(range(i * g, (i + 1) * g)))
              for i in range(num_groups)]
    return Mesh(mesh.rank % g, g, mesh.device, mesh.backend,
                group=groups[mesh.rank // g], parent=mesh)


def _host(x):
    """Tensors in a rank's result as numpy arrays (they cross the queue by
    value)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_main(rank: int, size: int, init_method: str, device: str,
               threads: int, fn: Callable, args: tuple, results):
    try:
        torch.set_num_threads(threads)
        dev = (torch.device("cuda", rank) if device == "cuda"
               else torch.device(device))
        mesh = init_mesh(size, rank, init_method, dev)
        try:
            out = _host(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable, size: int, *args: Any, device=None,
          timeout: Optional[float] = 120.0, threads: int = 1) -> list:
    """Run ``fn(mesh, *args)`` in ``size`` new processes, rank ``r`` on card
    ``r`` (or each on the CPU with ``device="cpu"``), and return their
    results by rank, tensors as numpy arrays.  ``fn`` and ``args`` must be
    picklable (a module's function).  Raises when a rank raises or dies,
    and kills every rank when they are not all done within ``timeout``
    seconds (None: no limit)."""
    dev = resolve(device)
    backend_for(dev)
    if dev.type == "cuda" and size > torch.cuda.device_count():
        raise RuntimeError(f"{size} ranks need {size} cards, this host has "
                           f"{torch.cuda.device_count()}")
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="xgnn_mesh_")
    init_method = f"file://{os.path.join(store, 'store')}"
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, init_method, dev.type, threads, fn,
                               args, results), daemon=True)
             for r in range(size)]
    deadline = time.monotonic() + (float("inf") if timeout is None
                                   else timeout)
    got, error = {}, None
    try:
        for p in procs:
            p.start()
        while len(got) < size and error is None:
            left = deadline - time.monotonic()
            if left <= 0:
                error = (f"spawn: ranks {sorted(set(range(size)) - set(got))}"
                         f" not done within {timeout} s")
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in got]
                if dead and results.empty():
                    error = f"spawn: ranks {dead} died without a result"
                continue
            if ok:
                got[rank] = out
            else:
                error = f"spawn: rank {rank} raised:\n{out}"
        for p in procs:
            p.join(timeout=10.0 if error is None else 0.1)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return [got[r] for r in range(size)]

