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

Hosts: a mesh knows the host of its rank (``host`` of ``num_hosts``) and
the rank's place among the host's ranks (``local_rank`` of
``local_size``).  A host's ranks share one copy of the host tier
(``store/host_shared.py``), as JAX's one process a host holds it once;
``parallel/multihost.py`` joins ranks on several hosts.

Rendezvous goes through a file store in a fresh temporary directory,
never a fixed TCP port (or, for simulated hosts, which share no
directory, a TCP store on a free port of this host).  :func:`make_mesh`
makes a world of one in the caller's process (P = 1 needs no launcher);
:func:`spawn` starts ``P``
ranks, one process each, runs a function in each and joins them under a
time limit, failing if one raises, dies or hangs (a rank that never
reaches a collective that the others wait in, a missed ``new_group``
among them, is a hang); ``hosts=H`` makes them ``H`` simulated hosts of
``P / H`` consecutive ranks each.
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
    # this rank's host, and its place among the host's ranks (the world's
    # on a DCN group's mesh)
    host: int = 0
    num_hosts: int = 1
    local_rank: Optional[int] = None
    local_size: Optional[int] = None
    # the job's token for the host's shared files, broadcast from world
    # rank 0 at the first use, and the files made so far
    _token: Optional[str] = None
    _shared: int = 0

    def __post_init__(self):
        if self.local_rank is None:
            self.local_rank = self.rank
        if self.local_size is None:
            self.local_size = self.size

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
              device=None, host: Optional[int] = None) -> Mesh:
    """Join a group of ``size`` ranks as ``rank`` through ``init_method``
    (a ``file://`` or ``tcp://`` store), on ``device`` (the card by
    default), on host ``host`` (None: one host holds every rank).  With a
    host given, the ranks exchange their hosts, which must be ``0..H-1``;
    a host's ranks are numbered by world rank."""
    device = resolve(device)
    backend = backend_for(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank)
    mesh = Mesh(rank, size, device, backend)
    if host is None:
        return mesh
    try:
        hosts = mesh.all_gather(torch.tensor(
            [int(host)], dtype=torch.int64, device=device))[:, 0].tolist()
        if sorted(set(hosts)) != list(range(len(set(hosts)))):
            raise ValueError(f"the ranks' hosts {hosts} are not 0..H-1")
    except BaseException:
        dist.destroy_process_group()
        raise
    mesh.host, mesh.num_hosts = int(host), len(set(hosts))
    mesh.local_rank = hosts[:rank].count(host)
    mesh.local_size = hosts.count(host)
    return mesh


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
                group=groups[mesh.rank // g], parent=mesh, host=mesh.host,
                num_hosts=mesh.num_hosts, local_rank=mesh.local_rank,
                local_size=mesh.local_size)


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
               threads: int, hosts: int, shm: Optional[str], fn: Callable,
               args: tuple, results):
    from ..store import host_shared
    from .multihost import initialize

    try:
        if shm is not None:
            os.environ[host_shared.SHM_DIR_ENV] = shm
        torch.set_num_threads(threads)
        mesh = initialize(init_method, size, rank,
                          host=rank // (size // hosts), card=rank,
                          device="cpu" if device == "cpu" else None)
        try:
            out = _host(fn(mesh, *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def _free_port() -> int:
    """A TCP port that no socket of this host holds just now."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn: Callable, size: int, *args: Any, device=None,
          timeout: Optional[float] = 120.0, threads: int = 1,
          hosts: int = 1) -> list:
    """Run ``fn(mesh, *args)`` in ``size`` new processes, rank ``r`` on card
    ``r`` (or each on the CPU with ``device="cpu"``), and return their
    results by rank, tensors as numpy arrays.  ``fn`` and ``args`` must be
    picklable (a module's function).  The ranks join through
    ``multihost.initialize``, as ``hosts`` simulated hosts of ``size //
    hosts`` consecutive ranks (rank ``r`` on host ``r // (size //
    hosts)``), over a file store, or with ``hosts > 1`` a TCP store on a
    free port of this host.  The ranks' shared host arrays go to a
    directory of the job's own (``store.host_shared.job_dir``), removed at
    the end, so that a rank killed while it writes one leaves nothing.
    Raises when a rank raises or dies, and kills every rank when they are
    not all done within ``timeout`` seconds (None: no limit)."""
    dev = resolve(device)
    backend_for(dev)
    if dev.type == "cuda" and size > torch.cuda.device_count():
        raise RuntimeError(f"{size} ranks need {size} cards, this host has "
                           f"{torch.cuda.device_count()}")
    if hosts < 1 or size % hosts:
        raise ValueError(f"{size} ranks do not fall into {hosts} hosts of "
                         "equal size")
    import multiprocessing as mp

    from ..store import host_shared

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="xgnn_mesh_")
    init_method = (f"tcp://localhost:{_free_port()}" if hosts > 1
                   else f"file://{os.path.join(store, 'store')}")
    shm = host_shared.job_dir()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, size, init_method, dev.type, threads,
                               hosts, shm, fn, args, results), daemon=True)
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
        if shm is not None:
            shutil.rmtree(shm, ignore_errors=True)
    if error is not None:
        raise RuntimeError(error)
    return [got[r] for r in range(size)]

