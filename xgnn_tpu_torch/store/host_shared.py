"""One copy of a host array for every rank of a host.

The multi-card engines hold the host tier (the feature table that K11
reads in place, the cold tier's CSR that the samplers' cold form reads)
once a host, as JAX holds it once a process and the reference's GGMS once
behind every GPU.  :class:`SharedHostArray` makes one such array over the
world mesh's ranks:

1. the host's first rank (``local_rank`` 0) writes the array into a new
   file under :func:`shm_dir` (``/dev/shm``, or ``XGNN_SHM_DIR``) with
   ``pwrite``: a directory without room for it raises with the path, the
   size and the free bytes, before the write or where the write finds it
   full; the readers map only a file written whole, so no page under a
   mapping is missing (no SIGBUS), and no ``posix_fallocate`` makes a
   second pass over the pages to reserve them first; the name carries the
   job's token, broadcast from world rank 0, the host index and the
   array's number, so that concurrent jobs never meet;
2. after a barrier every local rank maps the file ``MAP_SHARED`` and
   read-only (the first too, once it has written it), none copies it, and
   each registers its mapping for its card (``register``: with
   ``cudaHostRegisterReadOnly``);
3. after a second barrier the first rank unlinks the name: the mapping
   lives on while a rank holds it, and a crash after this point leaves
   nothing in the directory.

Each barrier is a min ``all_reduce`` of a failure flag over the world, so a
rank that fails to create, map or register raises, and so does every other
rank, naming it; the first rank unlinks what it made, and a rank that had
registered its mapping releases it (``release``) and unmaps it before it
raises.  Nothing falls back to a private copy.  Every rank of the world
must make its shared arrays in the same order (the engines do: the same
configuration on every rank).

A rank killed between the write and the second barrier leaves its host's
file behind: :func:`job_dir` gives a launcher (``parallel.mesh.spawn``) a
directory of its own for its ranks' files, which it removes whatever
became of them; elsewhere a crashed job's files are the names that start
with ``xgnn_host_<token>_``.

On the CPU the tensor is a view of the mapping, as on the card.
:func:`mapping_memory` reads a mapping's ``Rss`` and ``Pss`` from
``/proc/self/smaps``, :func:`thp_settings` the kernel's transparent huge
page settings.
"""

from __future__ import annotations

import errno
import mmap
import os
import secrets
import tempfile
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

SHM_DIR_ENV = "XGNN_SHM_DIR"
PREFIX = "xgnn_host_"  # every shared file's name starts so


def shm_dir() -> str:
    """Where the shared files go: ``XGNN_SHM_DIR``, else ``/dev/shm``."""
    return os.environ.get(SHM_DIR_ENV, "/dev/shm")


def job_dir() -> Optional[str]:
    """A new directory in :func:`shm_dir` for one job's files (the caller
    removes it), or None where :func:`shm_dir` cannot hold one."""
    try:
        return tempfile.mkdtemp(prefix="xgnn_job_", dir=shm_dir())
    except OSError:
        return None


def job_token(mesh) -> str:
    """The world's token for its shared files' names: world rank 0's random
    64 bits, broadcast once and kept on the world's mesh."""
    world = mesh.world
    if world._token is None:
        t = torch.tensor([secrets.randbits(63) if world.rank == 0 else 0],
                         dtype=torch.int64, device=world.device)
        dist.broadcast(t, src=0, group=world.group)
        world._token = f"{int(t.item()):016x}"
    return world._token


def _agree(world, error: Optional[BaseException], what: str):
    """Raise on every rank where any rank of the world failed (``error``
    not None on it): the lowest such rank is named, and its own error is
    the cause on that rank."""
    flag = torch.tensor([world.size if error is None else world.rank],
                        dtype=torch.int64, device=world.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=world.group)
    first = int(flag.item())
    if first < world.size:
        raise RuntimeError(
            f"{what} failed on rank {first}"
            + (f": {error.__class__.__name__}: {error}" if error is not None
               else "; this rank stops with it")) from error


class _Clock:
    """Each call writes the seconds since the last into ``seconds``."""

    def __init__(self, seconds: dict):
        self.seconds, self.t = seconds, time.perf_counter()

    def __call__(self, step: str):
        now = time.perf_counter()
        self.seconds[step] = now - self.t
        self.t = now


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


class SharedHostArray:
    """One array of a host's ranks, mapped from one file (see the module's
    notes): ``data`` (an array or a tensor on any device, the same on every
    rank; only the host's first rank reads it) as ``dtype``.  ``tensor``
    is this rank's view of it, read-only memory on every rank (the first
    rank writes the file, then maps it as the others do); ``st_ino`` is the
    file's inode (equal on a host's ranks), ``path`` the name it had,
    ``nbytes`` its size.  ``register(tensor)`` pins and maps the view for
    the rank's card, inside the second barrier; ``release()`` undoes it
    where the second barrier fails.  ``seconds`` holds this rank's time in
    each step: ``write`` (the first rank's file), ``wait_write`` (the
    first barrier), ``map``, ``register`` and ``wait_map`` (the
    second)."""

    def __init__(self, mesh, data, dtype: torch.dtype, what: str,
                 register: Optional[Callable[[torch.Tensor], None]] = None,
                 release: Optional[Callable[[], None]] = None):
        world = mesh.world
        token = job_token(world)
        seq = world._shared
        world._shared += 1
        self.shape = tuple(int(d) for d in (
            data.shape if hasattr(data, "shape") else np.shape(data)))
        self.dtype = dtype
        self.nbytes = int(np.prod(self.shape, dtype=np.int64)) \
            * torch.empty((), dtype=dtype).element_size()
        self.path = os.path.join(shm_dir(),
                                 f"{PREFIX}{token}_h{world.host}_{seq}")
        self.st_ino: Optional[int] = None
        self.seconds: dict = {}
        self._mm = None
        self._made = False  # this rank made the file, and unlinks it
        clock = _Clock(self.seconds)
        error = None
        try:
            if world.local_rank == 0:
                self._create(data)
        except BaseException as e:  # noqa: BLE001 (raised on every rank)
            error = e
        clock("write")
        try:
            _agree(world, error, f"{what}: writing {self.path} "
                   f"({self.nbytes} bytes)")
            clock("wait_write")
            error = None
            try:
                self._open()
                clock("map")
                if register is not None and self.nbytes:
                    register(self.tensor)
                    clock("register")
            except BaseException as e:  # noqa: BLE001
                error = e
            _agree(world, error, f"{what}: mapping {self.path} "
                   f"({self.nbytes} bytes) for {world.device}")
            clock("wait_map")
        except BaseException:
            # no registration and no mapping outlive the failure
            if release is not None:
                release()
            self.tensor = None
            try:
                if self._mm is not None:
                    self._mm.close()
            except BufferError:
                pass  # a traceback still holds the view: freed with it
            raise
        finally:
            if self._made:
                try:
                    os.unlink(self.path)
                except FileNotFoundError:
                    pass

    def _create(self, data):
        """Write ``data`` into the new file."""
        directory = os.path.dirname(self.path)
        if not os.path.isdir(directory):
            raise FileNotFoundError(f"no directory {directory} for the "
                                    "host's shared arrays (XGNN_SHM_DIR)")

        def full():
            st = os.statvfs(directory)
            return OSError(errno.ENOSPC, f"{self.path}: {self.nbytes} bytes "
                           f"do not fit, {st.f_bavail * st.f_frsize} bytes "
                           f"free in {directory}")

        st = os.statvfs(directory)
        if self.nbytes > st.f_bavail * st.f_frsize:
            raise full()
        fd = os.open(self.path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        self._made = True
        try:
            if self.nbytes:
                try:
                    self._write(fd, data)
                except OSError as e:
                    if e.errno != errno.ENOSPC:
                        raise
                    raise full() from e
        finally:
            os.close(fd)

    def _write(self, fd: int, data):
        """``data`` as ``dtype``, in row blocks of about 64 MiB."""
        rows = self.shape[0] if self.shape else 1
        row_bytes = self.nbytes // max(rows, 1)
        step = max(1, (64 << 20) // max(row_bytes, 1))
        at = 0
        for lo in range(0, rows, step):
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "The given NumPy array "
                                        "is not writable")
                part = data[lo:lo + step] if self.shape else data
                if getattr(part, "dtype", None) == np.uint32:
                    # a CSR's offsets from 2^31 edges on
                    part = part.astype(np.int64)
                part = torch.as_tensor(part)
            block = memoryview(part.detach().to("cpu", self.dtype)
                               .contiguous().numpy()).cast("B")
            while len(block):
                n = os.pwrite(fd, block, at)
                at += n
                block = block[n:]
        if at != self.nbytes:
            raise ValueError(f"{self.path}: wrote {at} bytes of "
                             f"{self.nbytes}")

    def _open(self):
        fd = os.open(self.path, os.O_RDONLY)
        try:
            size = os.fstat(fd).st_size
            if size != self.nbytes:
                raise ValueError(f"{self.path} holds {size} bytes, "
                                 f"{self.nbytes} expected")
            self.st_ino = os.fstat(fd).st_ino
            if not self.nbytes:
                self.tensor = torch.empty(self.shape, dtype=self.dtype)
                return
            self._mm = mmap.mmap(fd, self.nbytes, flags=mmap.MAP_SHARED,
                                 prot=mmap.PROT_READ)
        finally:
            os.close(fd)
        a = np.frombuffer(self._mm, dtype=_np_dtype(self.dtype))
        with warnings.catch_warnings():
            # the mapping is read-only, and nothing writes it
            warnings.filterwarnings("ignore", "The given NumPy array is "
                                    "not writable")
            self.tensor = torch.from_numpy(a).reshape(self.shape)


# the fields of a mapping that mapping_memory reads (kB in smaps, bytes out):
# its pages, their sharing, and the huge pages that hold any of them
SMAPS_FIELDS = ("Size", "Rss", "Pss", "Shared_Clean", "Shared_Dirty",
                "Private_Clean", "Private_Dirty", "AnonHugePages",
                "ShmemPmdMapped", "FilePmdMapped", "KernelPageSize",
                "MMUPageSize")


def mapping_memory(address: int) -> dict:
    """This process's mapping that holds ``address`` (``/proc/self/smaps``):
    ``path``, and each of :data:`SMAPS_FIELDS` that the kernel reports, in
    bytes, under its name in lower case; {} where no mapping holds it.  A
    host's ranks share a file's pages, so where the kernel splits a shared
    page's Pss among its mappers, the ranks' Pss sum to the pages' bytes
    once."""
    out: dict = {}
    inside = False
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()
            if "-" in head[0] and ":" not in head[0]:
                if inside:
                    break
                lo, hi = (int(x, 16) for x in head[0].split("-"))
                inside = lo <= address < hi
                if inside:
                    out["path"] = head[5] if len(head) > 5 else ""
            elif inside and head[0][:-1] in SMAPS_FIELDS:
                out[head[0][:-1].lower()] = int(head[1]) * 1024
    return out


def thp_settings() -> dict:
    """The kernel's transparent huge page settings, as read (``enabled``,
    ``shmem_enabled``; "unreadable" where they cannot be read)."""
    out = {}
    for name in ("enabled", "shmem_enabled"):
        try:
            with open(f"/sys/kernel/mm/transparent_hugepage/{name}") as f:
                out[name] = f.read().strip()
        except OSError:
            out[name] = "unreadable"
    return out
