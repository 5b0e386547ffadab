"""Ranks on several hosts.

The port of ``xgnn_tpu/parallel/multihost.py`` (lines 25-67).  JAX runs
one process a host, which drives the host's chips; its ``process`` is the
unit that holds the host tier once.  The port runs one process a card, so
its counterpart of JAX's process is a **host**: the ranks that share one
copy of the host tier (``store/host_shared.py``).  :func:`initialize`
joins the world and returns its :class:`~xgnn_tpu_torch.parallel.mesh.
Mesh`, which knows the rank's host (``host`` of ``num_hosts``) and its
place among the host's ranks (``local_rank`` of ``local_size``);
:func:`global_mesh` is that mesh, :func:`put_sharded_global` a rank's
block of a global array and :func:`local_worker_ids` a host's workers, by
JAX's formula with process = host.

Under ``torchrun`` (``--nnodes H --nproc-per-node G``) every argument
comes from the launcher's environment: ``MASTER_ADDR`` / ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` (the card) and ``GROUP_RANK``
(the host; else ``RANK // LOCAL_WORLD_SIZE``).  Nothing falls back: a
missing variable, no CUDA or no NCCL raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import Mesh, init_mesh

_WORLD: Optional[Mesh] = None


def _env(name: str) -> str:
    if name not in os.environ:
        raise RuntimeError(f"multihost.initialize: {name} is not set; give "
                           "the argument or start the ranks with torchrun")
    return os.environ[name]


def launch_env(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               host: Optional[int] = None, card: Optional[int] = None):
    """``(init_method, world size, rank, host, card)``: each argument, or
    where it is None the launcher's variable.  An address with a scheme
    (``file://``, ``tcp://``) is the init method itself; ``host:port`` is
    a TCP store there."""
    addr = coordinator_address
    if addr is None:
        addr = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT')}"
    method = addr if "://" in addr else f"tcp://{addr}"
    size = int(_env("WORLD_SIZE") if num_processes is None
               else num_processes)
    rank = int(_env("RANK") if process_id is None else process_id)
    if host is None:
        host = int(os.environ["GROUP_RANK"]) if "GROUP_RANK" in os.environ \
            else rank // int(_env("LOCAL_WORLD_SIZE"))
    card = int(_env("LOCAL_RANK") if card is None else card)
    return method, size, rank, int(host), card


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               host: Optional[int] = None, card: Optional[int] = None,
               device=None) -> Mesh:
    """Join the world of ``num_processes`` ranks as rank ``process_id``
    through ``coordinator_address`` on host ``host``, on card ``card``
    (``device="cpu"``: gloo on the CPU, no card read), each taken from the
    launcher's environment where it is None (:func:`launch_env`).  Returns
    the world's mesh, which :func:`global_mesh` returns after it."""
    global _WORLD
    method, size, rank, host, card = launch_env(
        coordinator_address, num_processes, process_id, host,
        -1 if device == "cpu" else card)  # the CPU reads no card
    dev = (torch.device("cpu") if device == "cpu"
           else torch.device("cuda", card))
    _WORLD = init_mesh(size, rank, method, dev, host)
    return _WORLD


def global_mesh() -> Mesh:
    """The world's mesh that :func:`initialize` joined."""
    if _WORLD is None:
        raise RuntimeError("multihost.global_mesh: initialize() first")
    return _WORLD


def put_sharded_global(arr, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """This rank's block of the global array ``arr`` (the same on every
    rank), on its device: rows ``[r * n / P, (r + 1) * n / P)`` along dim
    0, the block that JAX's ``NamedSharding(mesh, PS(axis))`` gives device
    ``r``.  Raises, as JAX does, where dim 0 is missing or ``P`` does not
    divide it."""
    mesh = global_mesh() if mesh is None else mesh
    a = np.asarray(arr)
    if a.ndim == 0:
        raise ValueError("put_sharded_global: a 0-d array has no dimension "
                         "0 to shard")
    if a.shape[0] % mesh.size:
        raise ValueError(f"put_sharded_global: dimension 0 of {a.shape} is "
                         f"not divisible by the mesh's {mesh.size} ranks")
    b = a.shape[0] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(
        a[mesh.rank * b:(mesh.rank + 1) * b])).to(mesh.device)


def local_worker_ids(num_worker_total: int,
                     mesh: Optional[Mesh] = None) -> Sequence[int]:
    """The global worker indices of this rank's host: JAX's formula, one
    worker a card, with the host in place of JAX's process."""
    mesh = global_mesh() if mesh is None else mesh
    per = num_worker_total // mesh.num_hosts
    start = mesh.host * per
    return list(range(start, start + per))
