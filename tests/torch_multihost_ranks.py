"""What each rank runs in tests/test_torch_multihost.py.

The ranks are processes of their own (``parallel.mesh.spawn`` with
``hosts=2``: two simulated hosts of two ranks, gloo on the CPU), so these
functions import the port alone, never JAX: the test process holds their
results against the JAX package.
"""

import dataclasses
import gc
import glob
import os

import numpy as np
import torch

from xgnn_tpu_torch.config import RunConfig
from xgnn_tpu_torch.parallel import multihost
from xgnn_tpu_torch.store import host_shared


def _arrays(eng):
    """The engine's host-tier arrays by name."""
    held = {}
    if eng.host is not None:
        held["feat"] = eng.host
    if eng.tier is not None:
        held.update(eng.tier.csr.arrays)
    return held


def engine_run(mesh, ds_arrays, config, params):
    """MultiChipEngine over ``mesh`` from the given initial weights: its
    epoch, per-step losses, valid accuracy and parameters, and each host
    array's file (inode, name, whether the name is gone, the view's
    address)."""
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    eng = MultiChipEngine(Dataset(**ds_arrays), RunConfig(**config),
                          mesh=mesh).init()
    try:
        if params is not None:
            # in place: the optimizer and the steps keep the tensors
            eng.model.load_state_dict({k: torch.from_numpy(v)
                                       for k, v in params.items()})
        files = {name: {"ino": a.shared.st_ino, "path": a.shared.path,
                        "unlinked": not os.path.exists(a.shared.path),
                        "read_only": a.read_only}
                 for name, a in _arrays(eng).items()}
        r = eng.train_epoch(0)
        return {"epoch": r, "losses": eng.history[0]["loss"],
                "acc": eng.evaluate("valid", 2), "files": files,
                "two_phase": eng.two_phase, "num_parts": eng.num_parts,
                "num_groups": eng.config.num_dcn_groups,
                "params": {k: v for k, v in eng.model.state_dict().items()}}
    finally:
        # the mesh is the caller's: unmap the host arrays alone
        for a in _arrays(eng).values():
            a.close()


def one_host(mesh):
    """The same ranks as one host of ``mesh.size`` (the one-host run)."""
    return dataclasses.replace(mesh, host=0, num_hosts=1,
                               local_rank=mesh.rank, local_size=mesh.size,
                               _token=None, _shared=0)


def suite(mesh, data):
    """On two simulated hosts: the mesh's host view, put_sharded_global's
    shard and its summed all_reduce, local_worker_ids, the engines on the
    two hosts and on one host of four, the job's leftover files and a rank
    that cannot create its file."""
    assert multihost.global_mesh() is mesh
    out = {"host": (mesh.host, mesh.num_hosts, mesh.local_rank,
                    mesh.local_size), "shm_dir": host_shared.shm_dir()}
    shard = multihost.put_sharded_global(data["arr"], mesh)
    total = shard.sum().reshape(1).clone()
    mesh.all_reduce(total)
    out["shard"], out["psum"] = shard, float(total)
    out["workers"] = {n: multihost.local_worker_ids(n) for n in (4, 8)}
    out["engines"] = {}
    tokens = []
    for shape, m in (("two_hosts", mesh), ("one_host", one_host(mesh))):
        for name, cfg in data["configs"].items():
            out["engines"][f"{shape}/{name}"] = engine_run(
                m, data["ds"], cfg, data["params"])
        tokens.append(m._token)
    out["tokens"] = tokens
    out["left"] = sorted(
        f for t in tokens for f in glob.glob(os.path.join(
            host_shared.shm_dir(), f"{host_shared.PREFIX}{t}_*")))
    # host 1's first rank cannot create its file: every rank raises
    failing = dataclasses.replace(mesh, _token=None, _shared=0)
    old = os.environ.get(host_shared.SHM_DIR_ENV)
    if mesh.rank == 2:
        os.environ[host_shared.SHM_DIR_ENV] = "/nonexistent/xgnn"
    try:
        engine_run(failing, data["ds"], data["configs"]["two_phase"], None)
        out["raised"] = None
    except RuntimeError as e:
        out["raised"] = str(e)
    finally:
        if old is None:
            os.environ.pop(host_shared.SHM_DIR_ENV, None)
        else:
            os.environ[host_shared.SHM_DIR_ENV] = old
    out["failing_token"] = failing._token
    # every rank past its failure (host 0's first rank unlinks its file on
    # the way out) before any rank looks
    mesh.all_reduce(torch.zeros(1))
    out["left_after_failure"] = sorted(glob.glob(os.path.join(
        host_shared.shm_dir(), f"{host_shared.PREFIX}{failing._token}_*")))
    out["failed_registration"] = failed_registration(mesh, data["arr"])
    return out


def failed_registration(mesh, arr):
    """Rank 1 fails to register its mapping after the others registered
    theirs: what each rank raised, what it still holds registered, what it
    released, and whether the file is still mapped in this process."""
    leak = dataclasses.replace(mesh, _token=None, _shared=0)
    registered, released = [], []

    def register(tensor):
        if mesh.rank == 1:
            raise OSError("registration refused")
        registered.append(tensor.data_ptr())

    def release():
        while registered:
            released.append(registered.pop())

    try:
        host_shared.SharedHostArray(leak, arr, torch.float32, "leak",
                                    register, release)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    gc.collect()  # a traceback's views of the mapping go with it
    name = f"{host_shared.PREFIX}{leak._token}_h{mesh.host}_0"
    with open("/proc/self/maps") as f:
        mapped = name in f.read()
    return {"raised": raised, "registered": len(registered),
            "released": len(released), "mapped": mapped}
