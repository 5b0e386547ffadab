#!/usr/bin/env python3
"""The host tier's memory at P = 4: one copy a host against one a rank.

    python3 xgnn_tpu_torch/tools/host_tables.py [--root DIR] [--turns N]
        [--cpu] [--nodes N]
    python3 xgnn_tpu_torch/tools/host_tables.py --write-paths [--turns N]

Four ranks on one host, one process a card (``parallel.mesh.spawn``:
NCCL, or gloo with ``--cpu``), each building ``chip_smoke.py``'s
products-scale graph on its card (2,449,029 nodes, 128 features; with
``--cpu`` a graph of ``--nodes`` nodes on the CPU) and running
``MultiChipEngine`` over the four in two configurations of
``chip_smoke.py``'s phases 16 and 17 at P = 4:

- ``graphsage_multichip_ggms``: the two-phase GGMS (cache 0.2,
  ``pre_sample``), the whole feature table in the host tier;
- ``graphsage_multichip_tiered``: the hot prefix at 0.85 of the edges
  partitioned, the whole CSR in the host tier.

For each it reports the host tier's bytes, every rank's Rss, Pss and
shared and private pages of the mappings that hold it
(``/proc/self/smaps``; where the kernel splits a shared page's Pss among
its mappers, one copy a host sums to the arrays' bytes once, one a rank
to four times them), the shared files an array (distinct inodes over the
ranks), the change of ``MemAvailable`` and ``Shmem`` (``/proc/meminfo``)
and of the bytes used in ``/dev/shm``, read by rank 0 between barriers
around the four inits, ``cache_build_time`` by rank, the shared arrays'
seconds in each step of their making by rank (``SharedHostArray.seconds``:
the first rank's reserve and write, the barriers' waits, map and
register), the counted epoch's time (after a warm-up epoch) and hit rate,
and rank 0's per-step losses.  With ``--root DIR`` (an earlier version
unpacked into a gitignored directory, as in ``git archive <commit> | tar
-x -C build/parent``) the two versions run in turns, parent, this
checkout, this checkout, parent (the first ``--turns`` of them), each in
a process of its own that imports its version's package, and the losses
of the two must be equal bit for bit.

``--write-paths``: one process on one card, the products-scale feature
table (2,449,029 x 128 float32, made on the card from a seed) made into a
registered host table four ways, in turns (``--turns`` rounds of the
four, then the reverse), each piece timed with the card synchronised:
``anonymous`` (the single store's: a copy to host memory, then
``cudaHostRegister``), ``shared`` (``MappedHostTable`` over a world of
one: ``SharedHostArray``'s seconds by step, the file written by
``pwrite`` in 64 MiB blocks), and two files in the same directory mapped
read-only and registered as ``shared`` is: ``reserved_write`` (its pages
reserved by ``posix_fallocate``, then written as ``shared`` writes) and
``mapped_write`` (its pages reserved, mapped writable with
``MAP_POPULATE`` and filled by one copy from the card); beside each its
unregister.

The last line is one JSON object.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
WORLD = 4


def mapping_memory(address: int) -> dict:
    """Size, Rss, Pss and the shared and private pages in bytes of this
    process's mapping holding ``address`` (``/proc/self/smaps``; read
    here, so that any version's arrays can be measured)."""
    out, inside = {}, False
    with open("/proc/self/smaps") as f:
        for line in f:
            head = line.split()
            if "-" in head[0] and ":" not in head[0]:
                if inside:
                    break
                lo, hi = (int(x, 16) for x in head[0].split("-"))
                inside = lo <= address < hi
                if inside:
                    out["mapping"] = head[5] if len(head) > 5 else ""
            elif inside and head[0] in ("Size:", "Rss:", "Pss:",
                                        "Shared_Clean:", "Shared_Dirty:",
                                        "Private_Clean:", "Private_Dirty:"):
                out[head[0][:-1].lower()] = int(head[1]) * 1024
    return out


def host_memory() -> dict:
    """``MemAvailable`` and ``Shmem`` (``/proc/meminfo``) and the bytes
    used in ``/dev/shm`` (``statvfs``)."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key = line.split(":")[0]
            if key in ("MemAvailable", "Shmem"):
                out[key] = int(line.split()[1]) * 1024
    st = os.statvfs("/dev/shm")
    out["shm_used"] = (st.f_blocks - st.f_bfree) * st.f_frsize
    return out


def configs(cs) -> dict:
    base = dict(cs.BENCH_CONFIG, arch="arch6", num_worker=WORLD,
                use_dist_graph=True, part_cache=True)
    return {
        "graphsage_multichip_ggms": dict(
            base, cache_percentage=cs.CACHE_PCT, cache_policy="pre_sample",
            presample_epoch=1),
        "graphsage_multichip_tiered": dict(
            base, dist_graph_percentage=cs.TIER_PCT),
    }


def rank_main(mesh, cases: dict, graph: dict) -> dict:
    import torch

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    def barrier():
        t = torch.zeros(1, device=mesh.device)
        mesh.all_reduce(t)
        if t.is_cuda:
            torch.cuda.synchronize(mesh.device)

    ds = make_device_dataset(graph["nodes"], graph["edges"], 128,
                             graph["classes"], train_frac=0.08, seed=0,
                             name="products_synth", dedup=False,
                             device=mesh.device)
    out = {}
    for name, kw in cases.items():
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
        barrier()
        before = host_memory() if mesh.rank == 0 else None
        t0 = time.perf_counter()
        eng = MultiChipEngine(ds, RunConfig(**kw), mesh=mesh).init()
        init_s = time.perf_counter() - t0
        barrier()
        after = host_memory() if mesh.rank == 0 else None
        arrays = dict({} if eng.host is None else {"feat": eng.host},
                      **({} if eng.tier is None else eng.tier.csr.arrays))
        tier = {}
        for a, held in arrays.items():
            t = held.tensor
            shared = getattr(held, "shared", None)
            tier[a] = dict(mapping_memory(t.data_ptr()),
                           bytes=t.numel() * t.element_size(),
                           shared=shared is not None,
                           ino=None if shared is None else shared.st_ino,
                           seconds=getattr(shared, "seconds", None))
        try:
            eng.train_epoch(0)
            r = eng.train_epoch(1)
            out[name] = {
                "init_s": init_s,
                "cache_build_s": eng.profiler._init_items.get(
                    "cache_build_time"),
                "host_memory_change": None if before is None
                else {k: after[k] - before[k] for k in before},
                "host_tier": tier, "epoch_s": r["time"],
                "steps": r["steps"], "hit_rate": r.get("hit_rate"),
                "losses": [float(x) for x in eng.history[1]["loss"]]}
        finally:
            # the mesh is spawn's: unmap the host arrays alone
            for held in arrays.values():
                held.close()
            del eng
    return out


def worker(args) -> int:
    """One version's run: its package first on the path, four ranks."""
    sys.path.insert(0, str(Path(args.package).resolve()))
    sys.path.insert(1, str(CHECKOUT))
    import chip_smoke as cs
    import torch

    import xgnn_tpu_torch
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.parallel import mesh as pmesh

    device = "cpu" if args.cpu else None
    if not args.cpu:
        if torch.cuda.device_count() < WORLD:
            print(f"host_tables: needs {WORLD} CUDA devices",
                  file=sys.stderr)
            return 2
        _build.build()  # once, before the ranks load the libraries
    graph = (dict(nodes=args.nodes, edges=args.nodes * 25, classes=47)
             if args.cpu else dict(nodes=cs.NUM_NODE, edges=cs.NUM_EDGE,
                                   classes=cs.NUM_CLASS))
    t0 = time.perf_counter()
    outs = pmesh.spawn(rank_main, WORLD, configs(cs), graph, device=device,
                       timeout=1200, threads=2 if args.cpu else 4)
    print(json.dumps({"ranks": outs, "wall_s": time.perf_counter() - t0,
                      "package": str(Path(xgnn_tpu_torch.__file__)
                                     .resolve().parents[1])}))
    return 0


def _steps(tier: dict) -> dict:
    """A rank's seconds in each step of making its shared arrays, summed
    over the arrays ({} for the anonymous copies)."""
    out: dict = {}
    for a in tier.values():
        for k, v in (a.get("seconds") or {}).items():
            out[k] = out.get(k, 0.0) + v
    return out


def write_paths(turns: int) -> dict:
    """``--write-paths``: the four ways to a registered host table."""
    import mmap
    import warnings

    import numpy as np
    import torch

    import chip_smoke as cs
    from xgnn_tpu_torch.ops import _build, tiered
    from xgnn_tpu_torch.parallel.mesh import make_mesh
    from xgnn_tpu_torch.store import host_shared

    dev = torch.device("cuda", 0)
    feat = torch.randn(cs.NUM_NODE, 128, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(0))
    nbytes = feat.numel() * feat.element_size()
    lib = _build.load("tiered")
    world = make_mesh(dev)

    class Steps(dict):
        def __init__(self):
            super().__init__()
            self.t = self.now()

        @staticmethod
        def now():
            torch.cuda.synchronize(dev)
            return time.perf_counter()

        def __call__(self, step):
            t = self.now()
            self[step] = t - self.t
            self.t = t

    def view(buf):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The given NumPy array is "
                                    "not writable")
            return torch.from_numpy(np.frombuffer(buf, np.float32)) \
                .view(feat.shape)

    def anonymous():
        s = Steps()
        host = feat.to("cpu")
        s("copy")
        tiered._map(host, dev.index, "anonymous")
        s("register")
        lib.xg_host_unmap(host.data_ptr(), dev.index)
        s("unregister")
        return dict(s)

    def shared():
        s = Steps()
        table = tiered.MappedHostTable(feat, mesh=world)
        s("total")
        steps = dict(table.shared.seconds)
        table.close()
        s("unregister")
        return dict(steps, **s)

    def reserved_write(s):
        step = (64 << 20) // (feat.shape[1] * feat.element_size())
        at = 0
        for lo in range(0, feat.shape[0], step):
            block = memoryview(feat[lo:lo + step].to("cpu").numpy()) \
                .cast("B")
            while len(block):
                n = os.pwrite(s.fd, block, at)
                at += n
                block = block[n:]
        s("write")

    def mapped_write(s):
        rw = mmap.mmap(s.fd, nbytes, flags=mmap.MAP_SHARED
                       | mmap.MAP_POPULATE)
        s("populate")
        dst = view(rw)
        dst.copy_(feat)
        s("write")
        del dst
        rw.close()

    def file_path(fill):
        s = Steps()
        path = os.path.join(host_shared.shm_dir(),
                            f"{host_shared.PREFIX}tool_{os.getpid()}")
        s.fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.posix_fallocate(s.fd, 0, nbytes)
            s("reserve")
            fill(s)
            ro = mmap.mmap(s.fd, nbytes, flags=mmap.MAP_SHARED,
                           prot=mmap.PROT_READ)
        finally:
            os.close(s.fd)
            os.unlink(path)
        table = view(ro)
        s("map")
        tiered._map(table, dev.index, fill.__name__, True)
        s("register")
        if not torch.equal(table[::4096].to(dev), feat[::4096]):
            raise AssertionError(f"{fill.__name__}: the table differs")
        s.t = s.now()
        lib.xg_host_unmap(table.data_ptr(), dev.index)
        s("unregister")
        del table
        ro.close()
        return dict(s)

    paths = {"anonymous": anonymous, "shared": shared,
             "reserved_write": lambda: file_path(reserved_write),
             "mapped_write": lambda: file_path(mapped_write)}
    runs = {k: [] for k in paths}
    try:
        for _ in range(turns):
            for k in list(paths) + list(paths)[::-1]:
                runs[k].append(paths[k]())
                print(f"{k}: " + ", ".join(
                    f"{step} {v:.4f} s" for step, v in runs[k][-1].items()),
                    flush=True)
    finally:
        world.close()
    return {"bytes": nbytes, "runs": runs,
            "median_s": {k: {step: sorted(r[step] for r in rs)[len(rs) // 2]
                             for step in rs[0]} for k, rs in runs.items()}}


def summary(outs: list) -> dict:
    rows = {}
    for name in outs[0]:
        rs = [o[name] for o in outs]
        tier = rs[0]["host_tier"]
        rows[name] = {
            "host_tier_bytes": sum(a["bytes"] for a in tier.values()),
            "shared": all(a["shared"] for a in tier.values()),
            "rss_by_rank": [sum(a.get("rss", 0) for a in r["host_tier"]
                                .values()) for r in rs],
            "pss_by_rank": [sum(a.get("pss", 0) for a in r["host_tier"]
                                .values()) for r in rs],
            "mapping_size_by_rank": [sum(a.get("size", 0) for a in
                                         r["host_tier"].values())
                                     for r in rs],
            "host_memory_change": rs[0]["host_memory_change"],
            "files": {a: len({r["host_tier"][a]["ino"] for r in rs})
                      for a in tier if tier[a]["shared"]},
            "shared_pages_by_rank": [sum(
                a.get("shared_clean", 0) + a.get("shared_dirty", 0)
                for a in r["host_tier"].values()) for r in rs],
            "private_pages_by_rank": [sum(
                a.get("private_clean", 0) + a.get("private_dirty", 0)
                for a in r["host_tier"].values()) for r in rs],
            "cache_build_s_by_rank": [r["cache_build_s"] for r in rs],
            "shared_steps_s_by_rank": [_steps(r["host_tier"]) for r in rs],
            "init_s_by_rank": [r["init_s"] for r in rs],
            "epoch_s": max(r["epoch_s"] for r in rs),
            "hit_rate": rs[0]["hit_rate"], "steps": rs[0]["steps"],
            "losses": rs[0]["losses"]}
        rows[name]["pss_sum"] = sum(rows[name]["pss_by_rank"])
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None,
                    help="an earlier version, run in turns with this one")
    ap.add_argument("--cpu", action="store_true",
                    help="four gloo ranks on the CPU, a small graph")
    ap.add_argument("--nodes", type=int, default=20_000,
                    help="with --cpu: the graph's nodes")
    ap.add_argument("--turns", type=int, default=4,
                    help="with --root: the first N of parent, this "
                    "checkout, this checkout, parent")
    ap.add_argument("--write-paths", action="store_true",
                    help="one card: four ways to a registered host table")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--package", default=str(CHECKOUT),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs

    if not args.cpu:
        print(cs.card_line(), flush=True)
    if args.write_paths:
        out = write_paths(args.turns)
        print(json.dumps({"write_paths": out, "ok": True}))
        return 0
    root = None if args.root is None else str(Path(args.root).resolve())
    turns = ([("parent", root), ("new", str(CHECKOUT)),
              ("new", str(CHECKOUT)), ("parent", root)][:args.turns]
             if root else [("new", str(CHECKOUT))])
    runs = {"new": [], "parent": []}
    for label, package in turns:
        cmd = [sys.executable, __file__, "--worker", "--package", package,
               "--nodes", str(args.nodes)] + (["--cpu"] if args.cpu else [])
        p = subprocess.run(cmd, capture_output=True, text=True,
                           cwd=package, env=dict(os.environ))
        if p.returncode != 0:
            print(p.stdout[-4000:] + p.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"host_tables: the {label} run failed "
                             f"(exit {p.returncode})")
        res = json.loads(p.stdout.strip().splitlines()[-1])
        if res["package"] != package:
            raise SystemExit(f"host_tables: the {label} run imported "
                             f"{res['package']}, not {package}")
        rows = summary(res["ranks"])
        runs[label].append(rows)
        for name, row in rows.items():
            print(f"{label} {name}: host tier {row['host_tier_bytes']} "
                  f"bytes ("
                  f"{'one copy a host' if row['shared'] else 'a copy a rank'}"
                  f"); Pss by rank {row['pss_by_rank']} (sum "
                  f"{row['pss_sum']}), Rss by rank {row['rss_by_rank']} "
                  f"of mappings of {row['mapping_size_by_rank']} bytes; "
                  f"shared / private pages by rank "
                  f"{row['shared_pages_by_rank']} / "
                  f"{row['private_pages_by_rank']}; files an array "
                  f"{row['files']}; over the inits {row['host_memory_change']}"
                  f" (bytes); cache_build_time by rank "
                  f"{[round(t, 4) for t in row['cache_build_s_by_rank']]} "
                  f"s (shared arrays' steps by rank "
                  f"{row['shared_steps_s_by_rank']}); counted epoch "
                  f"{row['epoch_s']:.4f} s, {row['steps']}"
                  f" steps, hit rate {row['hit_rate']}", flush=True)
    bad = []
    if runs["parent"]:
        for name in runs["new"][0]:
            want = runs["new"][0][name]["losses"]
            for r in runs["new"] + runs["parent"]:
                if r[name]["losses"] != want:
                    bad.append(f"{name}: the losses differ between runs")
                    break
    for b in bad:
        print(f"FAILED {b}", flush=True)
    print(json.dumps({"host_tables": runs, "ok": not bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
