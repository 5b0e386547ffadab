#!/usr/bin/env python3
"""Time K11 (the tiered extract) step by step, beside its parent version.

    python3 xgnn_tpu_torch/tools/time_tiered.py [--parent DIR]
    python3 xgnn_tpu_torch/tools/time_tiered.py --positions [--root DIR]
        [--turns N]
    python3 xgnn_tpu_torch/tools/time_tiered.py --shared [--turns N]

The inputs are those of ``chip_smoke.py``'s phase 8: the products-scale
synthetic dataset (seed 0), GraphSAGE's configuration at cache 0.2 with
``pre_sample`` (its engine's presample ranking and pinned, mapped table),
and the input nodes of one non-direct batch (the seeds of
``chip_smoke.py``'s first batch, generator seed 7): as drawn, with 30% of
them EMPTY, and the all-miss form over the cache's rows (the cache build).
It prints:

- the machine's CPUs and NUMA nodes (``lscpu``, ``numactl -H``);
- the other way to move the misses, for comparison: a host gather of the
  drawn batch's miss rows into pinned memory (``torch.index_select`` on
  the pinned table) by thread count from 1 to every core, the pinned
  ``copy_`` alone (512 MiB and the gathered rows), and the two pipelined
  (host threads gather chunks of 4 MiB into a ring of pinned slots, each
  moved to the card on a side stream while the next is gathered) at 2,
  the cores less two, and every core: GB/s, best of 3;
- for each input: the split alone and the SMs' reads alone (device ms,
  the card's time with the host ahead) and the whole call (back to back,
  and on the card alone), in turns with the parent's K11 where
  ``--parent`` is given (parent, new, new, parent), every result checked
  bit-equal;
- the same batch's misses on a table four times as large (9,796,116 rows,
  5.0 GB pinned; a valid id ``v`` becomes ``4v + (7v + 3) % 4``), where the
  misses are 17% of the table's rows, beside the time of one ``copy_`` of
  the whole table at the measured rate;
- graphsage_cached's and graphsage_dynamic's pipelined epochs (25 steps
  after a warm-up), three each in turns with the parent's K11 in the same
  engine (parent, new, new, parent, parent, new).

``--parent DIR``: a checkout of an earlier version, unpacked into a
gitignored directory, as in ``git archive <commit> | tar -x -C
build/parent``.  Its ``csrc/tiered.cu`` (one kernel, ``xg_tiered_extract``)
is built and bound with the C interface that its ``ops/_build.py``
declares, and reads its own pinned, mapped copy of the host table.

``--positions``: K11's position form (``tiered_split_positions``, the
two-phase GGMS's lookup) alone, on the same batch's input nodes over the
engine's posmap, as drawn and with 30% of them EMPTY, and on the batch's
first 133,376 and 8,000 ids; given ``--root DIR``, in turns with DIR's
wrapper (loaded beside this one by ``tools/parent_ops.py``; it builds into
DIR's build directory) and with :data:`POS_VARIANTS`, each held bit-equal
to the plain version first.
For each build, the medians of ``--turns`` rounds (parent, new, new,
parent): device ms (``chip_smoke.time_ms`` with the host ahead of the
card), ms of 10 calls back to back, host microseconds a call (100 queued,
no synchronise), and the profiler's kernels and memsets a call with their
device microseconds; beside them the bound (the ids and pos once, a posmap
word a valid id, the misses' positions and ids) over 3.35 TB/s.  Nothing
else is run.

``--shared``: K11's whole call (``tiered_extract``), as drawn, on the
same batch's input nodes as drawn and with 30% of them EMPTY, over three
tables of the same rows: the store's anonymous pinned copy, made first,
the host's shared copy (``MappedHostTable`` over a world of one: a file
under ``/dev/shm`` mapped read-only and registered read-only,
``store/host_shared.py``), and an anonymous pinned copy of the shared
one made after it (``anonymous_late``, as ``chip_smoke.py``'s phase 16
makes its anonymous table).  Each is held bit-equal to the plain version
first, then timed in ``--turns`` rounds (anonymous, shared,
anonymous_late, then the reverse): device ms (the host ahead of the
card) and the misses' rate; beside them the kernel's transparent huge
page settings as read and each table's mapping (``mapping_memory``: Rss,
Pss, page sizes and huge pages).  Nothing else is run.

The last line is one JSON object.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
CHUNK_BYTES = 4 << 20  # a pinned slot of the gather-and-copy pipeline
SLOTS_PER_THREAD = 3
# name: nvcc flags that make a variant of this checkout's tiered.cu for
# --positions (the ids a thread of the position form: tiles of 4,096 and
# 8,192 ids; csrc/tiered.cu ships 2,048)
POS_VARIANTS = {"pos_iters16": ["-DXG_POS_ITERS=16"],
                "pos_iters32": ["-DXG_POS_ITERS=32"]}


class ParentK11:
    """The parent's K11 on its own mapped copy of ``table``."""

    def __init__(self, _build, parent, table, device):
        root = Path(parent).resolve() / "xgnn_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "parent_build", root / "ops" / "_build.py")
        parent_build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent_build)
        out_dir = _build.BUILD_DIR / "time_tiered"
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / "libtiered_parent.so"
        log = subprocess.run(
            [_build.nvcc()] + parent_build.NVCC_FLAGS
            + ["-o", str(lib), str(root / "csrc" / "tiered.cu")],
            capture_output=True, text=True)
        if log.returncode != 0:
            raise RuntimeError(f"time_tiered: the parent did not build:\n"
                               f"{log.stdout}{log.stderr}")
        self.lib = ctypes.CDLL(str(lib))
        for fn, argtypes in parent_build.SIGNATURES["tiered"].items():
            getattr(self.lib, fn).argtypes = argtypes
            getattr(self.lib, fn).restype = ctypes.c_int
        self.table = table.clone()
        self.device = device
        ptr = ctypes.c_void_p()
        rc = self.lib.xg_host_map(
            self.table.data_ptr(), self.table.numel() * 4, device.index,
            ctypes.addressof(ptr))
        _build.check(rc, "parent xg_host_map")
        self.dev_ptr = ptr.value

    def extract(self, torch, _build, ids, num_input, posmap, cache):
        num_node, width = self.table.shape
        out = torch.empty((ids.shape[0], width), dtype=torch.float32,
                          device=ids.device)
        counts = torch.empty(2, dtype=torch.int32, device=ids.device)
        num = _build.int32_scalar(num_input, ids.device)
        rc = self.lib.xg_tiered_extract(
            ids.data_ptr(), ids.shape[0], num.data_ptr(),
            None if posmap is None else posmap.data_ptr(), num_node,
            None if cache is None else cache.data_ptr(), self.dev_ptr, width,
            out.data_ptr(), counts.data_ptr(), self.device.index,
            _build.stream_handle(ids.device))
        _build.check(rc, "parent tiered_extract")
        return out, counts

    def close(self):
        self.lib.xg_host_unmap(self.table.data_ptr(), self.device.index)


def machine() -> dict:
    """The CPU model, core count and NUMA layout, as lscpu and numactl say."""
    info = {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0))}
    for cmd in (["lscpu"], ["numactl", "-H"]):
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=20).stdout
        except (OSError, subprocess.SubprocessError) as e:
            out = f"not available ({e.__class__.__name__})"
        keep = [ln.strip() for ln in out.splitlines()
                if cmd[0] != "lscpu" or ln.split(":")[0].strip() in (
                    "Model name", "Model", "CPU(s)", "Thread(s) per core",
                    "Core(s) per socket", "Socket(s)", "BogoMIPS",
                    "L2 cache", "L3 cache", "NUMA node(s)",
                    "NUMA node0 CPU(s)", "NUMA node1 CPU(s)")]
        info[cmd[0]] = keep
        print(f"{' '.join(cmd)}: " + "; ".join(keep), flush=True)
    return info


def gather_and_copy(torch, table, ids, dev_rows, threads):
    """``dev_rows[r] = table[ids[r]]``: ``threads`` host threads take chunks
    of rows in turn, gather each into a pinned slot of their own ring and
    copy it to the card on a side stream; a slot is refilled only once its
    copy's event has completed.  Returns when the last copy has landed."""
    width = table.shape[1]
    rows = max(1, CHUNK_BYTES // (width * 4))
    chunks = -(-ids.shape[0] // rows)
    stream = torch.cuda.Stream(device=dev_rows.device)
    slots = [[(torch.empty((rows, width), dtype=torch.float32,
                           pin_memory=True), torch.cuda.Event())
              for _ in range(SLOTS_PER_THREAD)] for _ in range(threads)]
    taken = iter(range(chunks))
    lock = threading.Lock()

    def work(t):
        with torch.cuda.stream(stream):
            for turn in range(chunks):
                with lock:
                    c = next(taken, None)
                if c is None:
                    return
                buf, done = slots[t][turn % SLOTS_PER_THREAD]
                done.synchronize()
                part = ids[c * rows:(c + 1) * rows]
                torch.index_select(table, 0, part, out=buf[:part.shape[0]])
                dev_rows[c * rows:c * rows + part.shape[0]].copy_(
                    buf[:part.shape[0]], non_blocking=True)
                done.record(stream)

    pool = [threading.Thread(target=work, args=(t,)) for t in range(threads)]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    stream.synchronize()
    return dev_rows


def device_events(torch, fn, reps: int = 10) -> dict:
    """``{name: [calls a call, device us a call]}`` of every kernel and
    memset ``fn`` puts on the card, from the profiler's device events over
    ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.2)  # CUPTI completes the last records
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            got = out.setdefault(name, [0.0, 0.0])
            got[0] += 1 / reps
            got[1] += (e.time_range.end - e.time_range.start) / reps
    return out


def position_variants(torch, _build) -> dict:
    """``{name: tiered_split_positions-like callable}`` of
    :data:`POS_VARIANTS`, compiled in parallel, each call allocating and
    launching as the wrapper does."""
    out_dir = _build.BUILD_DIR / "time_tiered"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, flags in POS_VARIANTS.items():
        lib = out_dir / f"libtiered_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + flags
            + ["-o", str(lib), str(_build.CSRC / "tiered.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    calls = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"time_tiered: {name} did not build:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn in ("xg_tiered_split_positions",
                   "xg_tiered_positions_scratch_bytes"):
            getattr(cdll, fn).argtypes = _build.SIGNATURES["tiered"][fn]
            getattr(cdll, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)

        def call(ids, num_input, posmap, lib=cdll):
            dev, n = ids.device, ids.shape[0]
            pos = torch.empty(n, dtype=torch.int32, device=dev)
            scratch = torch.empty(
                2 * n + lib.xg_tiered_positions_scratch_bytes(n) // 4,
                dtype=torch.int32, device=dev)
            counts = torch.empty(2, dtype=torch.int32, device=dev)
            num = _build.int32_scalar(num_input, dev)
            _build.check(lib.xg_tiered_split_positions(
                ids.data_ptr(), n, num.data_ptr(), posmap.data_ptr(),
                posmap.shape[0], pos.data_ptr(), counts.data_ptr(),
                scratch[2 * n:].data_ptr(), scratch.data_ptr(),
                scratch[n:].data_ptr(), _build.stream_handle(dev)),
                "time_tiered variant")
            return pos, counts, scratch[:n], scratch[n:2 * n]

        calls[name] = call
    return calls


def positions(torch, cs, _build, drawn, num, sparse, posmap, root, turns):
    """K11's position form alone, in turns with ``root``'s wrapper where
    given: the rows of the JSON line."""
    import statistics

    sys.path.insert(0, str(CHECKOUT / "xgnn_tpu_torch" / "tools"))
    import parent_ops
    from time_exchange import host_us

    from xgnn_tpu_torch.ops.tiered import (
        tiered_split_positions,
        tiered_split_positions_plain,
    )

    builds = {"new": tiered_split_positions,
              **position_variants(torch, _build)}
    if root is not None:
        builds["parent"] = parent_ops.load(root,
                                           "tiered").tiered_split_positions
    order = sorted(builds, key=lambda k: k != "parent")
    inputs = {"drawn": (drawn, num), "30% EMPTY": (sparse, num),
              "first 133376": (drawn[:133376].contiguous(), 133376),
              "first 8000": (drawn[:8000].contiguous(), 8000)}
    rows = []
    for what, (ids, nv) in inputs.items():
        want = tiered_split_positions_plain(ids, nv, posmap)
        nm = int(want[1][1])
        for k, fn in builds.items():
            got = fn(ids, nv, posmap)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])
                    and torch.equal(got[2][:nm], want[2][:nm])
                    and torch.equal(got[3][:nm], want[3][:nm])):
                raise AssertionError(f"time_tiered --positions: {k} "
                                     f"differs from the plain version "
                                     f"({what})")
        n = ids.shape[0]
        live = min(n, int(nv))
        valid = int(((ids[:live] >= 0) & (ids[:live] < posmap.shape[0]))
                    .sum())
        bound = cs.bound_ms(n * 8 + valid * 4 + nm * 8 + 8, 0)[0]
        res = {k: {"device_ms": [], "ms": [], "host_us": []} for k in order}
        for _ in range(turns):
            for k in order + order[::-1]:
                call = lambda fn=builds[k]: fn(ids, nv, posmap)
                res[k]["device_ms"].append(cs.time_ms(torch, call,
                                                      host_ahead=True))
                res[k]["ms"].append(cs.time_ms(torch, call))
                res[k]["host_us"].append(host_us(torch, call))
        row = {"input": what, "ids": n, "valid": valid,
               "hits": int(want[1][0]), "misses": nm, "bound_ms": bound}
        for k in order:
            row[k] = {m: statistics.median(v) for m, v in res[k].items()}
            row[k]["turns"] = res[k]
            row[k]["device_events"] = device_events(
                torch, lambda fn=builds[k]: fn(ids, nv, posmap))
        rows.append(row)
        print(f"K11 position form, {what}: {n} ids ({valid} valid, "
              f"{row['hits']} hits, {nm} misses), bound {bound:.5f} ms; "
              + "; ".join(
                  f"{k} {row[k]['device_ms']:.4f} device ms, "
                  f"{row[k]['ms']:.4f} ms back to back, "
                  f"{row[k]['host_us']:.1f} host us, a call: "
                  + ", ".join(f"{name} x{c:g} {us:.2f} us" for name, (c, us)
                              in row[k]["device_events"].items())
                  for k in order), flush=True)
    return rows


def shared_tables(torch, cs, store, inputs, dev, turns) -> dict:
    """``--shared``: K11's whole call over the anonymous, the shared and a
    late anonymous table in turns."""
    from xgnn_tpu_torch.ops.tiered import (
        MappedHostTable,
        tiered_extract,
        tiered_extract_plain,
    )
    from xgnn_tpu_torch.parallel.mesh import make_mesh
    from xgnn_tpu_torch.store.host_shared import mapping_memory, thp_settings

    out = {"thp": thp_settings(), "inputs": {}}
    print(f"transparent huge pages: {out['thp']}", flush=True)
    world = make_mesh(dev)
    tables = {"anonymous": store.host}
    try:
        tables["shared"] = MappedHostTable(store.feat_host, mesh=world)
        tables["anonymous_late"] = MappedHostTable(
            tables["shared"].tensor, dev)
        out["memory"] = {k: mapping_memory(t.tensor.data_ptr())
                         for k, t in tables.items()}
        print(f"tables' mappings: {out['memory']}", flush=True)
        row_bytes = store.feat_dim * store.host.tensor.element_size()
        for what, (ids, nv) in inputs.items():
            ref, ref_counts = tiered_extract_plain(
                ids, nv, store.posmap, store.cache_feat, store.feat_host)
            calls = {k: (lambda t=t: tiered_extract(
                ids, nv, store.posmap, store.cache_feat, t))
                for k, t in tables.items()}
            for k, call in calls.items():
                got, cnt = call()
                torch.cuda.synchronize()
                if not (torch.equal(got, ref)
                        and torch.equal(cnt, ref_counts)):
                    raise AssertionError(f"{what}: K11 over the {k} table "
                                         "differs from its plain version")
            misses = int(ref_counts[1])
            del ref, got
            order = list(calls) + list(calls)[::-1]
            ms = {k: [] for k in calls}
            for _ in range(turns):
                for k in order:
                    ms[k].append(cs.time_ms(torch, calls[k],
                                            host_ahead=True))
            row = {"misses": misses, "device_ms": ms,
                   "median_ms": {k: sorted(v)[len(v) // 2]
                                 for k, v in ms.items()}}
            row["miss_GBps"] = {k: misses * row_bytes / v / 1e6
                                for k, v in row["median_ms"].items()}
            out["inputs"][what] = row
            print(f"K11's whole call, {what} ({misses} misses of "
                  f"{row_bytes} bytes): " + json.dumps(row), flush=True)
    finally:
        for k in ("shared", "anonymous_late"):
            if k in tables:
                tables[k].close()
        world.close()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of an earlier version")
    ap.add_argument("--positions", action="store_true",
                    help="time K11's position form alone")
    ap.add_argument("--root", default=None,
                    help="with --positions: a parent checkout whose "
                    "wrapper is timed in turns")
    ap.add_argument("--shared", action="store_true",
                    help="time K11's whole call over the anonymous and the "
                    "host's shared table in turns")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("time_tiered: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.tiered import (
        EMPTY,
        MappedHostTable,
        tiered_direct,
        tiered_extract,
        tiered_extract_plain,
        tiered_split,
    )

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    report = {"card": card, "machine": machine()}
    _build.build()
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    cfg = RunConfig(**dict(cs.BENCH_CONFIG, cache_percentage=cs.CACHE_PCT,
                           cache_policy="pre_sample"))
    eng = Engine(ds, cfg).init()
    store = eng.feature_source
    feat_dev, ds.feat = ds.feat, store.feat_host
    del feat_dev
    torch.cuda.empty_cache()
    width = store.feat_dim
    parent = (None if args.parent is None
              else ParentK11(_build, args.parent, store.feat_host, dev))
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    batch = eng.sampler.sample(torch.from_numpy(seeds).to(dev), n,
                               generator(dev, 7))
    drawn, num = batch.input_nodes, batch.num_input
    gen = torch.Generator(device=dev).manual_seed(11)
    sparse = drawn.clone()
    sparse[torch.rand(sparse.shape, generator=gen, device=dev) < 0.3] = EMPTY
    if args.positions:
        report["positions"] = positions(torch, cs, _build, drawn, num,
                                        sparse, store.posmap, args.root,
                                        args.turns)
        print(json.dumps(report))
        return 0
    if args.shared:
        report["shared"] = shared_tables(
            torch, cs, store, {"drawn": (drawn, num),
                               "30% EMPTY": (sparse, num)}, dev, args.turns)
        print(json.dumps(report))
        return 0
    cached = (store.posmap != EMPTY).nonzero().flatten()
    cache_ids = torch.empty(store.num_cache, dtype=torch.int32, device=dev)
    cache_ids[store.posmap[cached].long()] = cached.to(torch.int32)
    inputs = {"drawn": (drawn, num, store.posmap, store.cache_feat),
              "30% EMPTY": (sparse, num, store.posmap, store.cache_feat),
              "all-miss (cache build)": (cache_ids, store.num_cache, None,
                                         None)}

    # the other way: a host gather and the copy engines, on the drawn
    # batch's misses
    _, counts, _, miss_ids = tiered_split(drawn, num, store.posmap,
                                          store.cache_feat, store.host)
    nm = int(counts[1])
    ids_host = miss_ids[:nm].cpu().long()
    nbytes = nm * width * 4
    rows = torch.empty((nm, width), dtype=torch.float32, pin_memory=True)
    cores = os.cpu_count() or 1
    intra = torch.get_num_threads()
    gather = {}
    for t in sorted({1, cores} | {1 << k for k in range(8)
                                  if 1 << k <= cores}):
        torch.set_num_threads(t)
        best = []
        for _ in range(3):
            t0 = time.perf_counter()
            torch.index_select(store.feat_host, 0, ids_host, out=rows)
            best.append(time.perf_counter() - t0)
        gather[t] = nbytes / min(best) / 1e9
        print(f"host gather, {nm} rows of {width * 4} bytes, {t} threads: "
              f"{gather[t]:.3f} GB/s (best of "
              f"{[round(b * 1e3, 3) for b in best]} ms)", flush=True)
    torch.set_num_threads(intra)
    report["host_gather_GBps"] = gather
    pinned = torch.empty(cs.H2D_BYTES // 4, dtype=torch.float32).pin_memory()
    on_card = torch.empty(pinned.shape, dtype=torch.float32, device=dev)
    h2d_ms = cs.time_ms(torch, lambda: on_card.copy_(pinned,
                                                     non_blocking=True),
                        reps=5)
    on_card = torch.empty(rows.shape, dtype=torch.float32, device=dev)
    rows_ms = cs.time_ms(torch, lambda: on_card.copy_(rows,
                                                      non_blocking=True),
                         reps=5)
    report["copy_GBps"] = {"512MiB": cs.H2D_BYTES / h2d_ms / 1e6,
                           "gathered_rows": nbytes / rows_ms / 1e6}
    print(f"pinned copy_: {report['copy_GBps']} GB/s", flush=True)
    torch.set_num_threads(1)
    piped = {}
    for t in sorted({2, max(1, cores - 2), cores}):
        best = []
        for _ in range(3):
            t0 = time.perf_counter()
            gather_and_copy(torch, store.feat_host, ids_host, on_card, t)
            best.append(time.perf_counter() - t0)
        piped[t] = {"ms": min(best) * 1e3, "GBps": nbytes / min(best) / 1e9}
        print(f"gather and copy pipelined, {t} threads: {piped[t]}",
              flush=True)
    torch.set_num_threads(intra)
    if not torch.equal(on_card.cpu(), store.feat_host[ids_host]):
        raise AssertionError("the gather-and-copy pipeline moved other rows")
    report["gather_and_copy"] = piped
    del pinned, on_card, rows

    def per_input(what, ids, nv, posmap, cache, host, parent_k11):
        ref, ref_counts = tiered_extract_plain(ids, nv, posmap, cache,
                                               host.tensor)
        out, cnt = tiered_extract(ids, nv, posmap, cache, host)
        torch.cuda.synchronize()
        if not (torch.equal(out, ref) and torch.equal(cnt, ref_counts)):
            raise AssertionError(f"{what}: K11 differs from its plain version")
        misses = int(cnt[1])
        row = {"input": what, "ids": ids.shape[0], "hits": int(cnt[0]),
               "misses": misses, "pcie_bytes": misses * width * 4,
               "table_rows": host.tensor.shape[0]}
        split = lambda: tiered_split(ids, nv, posmap, cache, host)
        row["split_device_ms"] = cs.time_ms(torch, split, host_ahead=True)
        o, c, pos, mids = split()
        row["direct_device_ms"] = cs.time_ms(
            torch, lambda: tiered_direct(o, mids, pos, c, host),
            host_ahead=True)
        del o, c, pos, mids
        runs = {"new": lambda: tiered_extract(ids, nv, posmap, cache, host)}
        if parent_k11 is not None:
            pout, pcnt = parent_k11.extract(torch, _build, ids, nv, posmap,
                                            cache)
            torch.cuda.synchronize()
            if not (torch.equal(pout, ref) and torch.equal(pcnt, cnt)):
                raise AssertionError(f"{what}: the parent's K11 differs")
            del pout
            runs["parent"] = lambda: parent_k11.extract(
                torch, _build, ids, nv, posmap, cache)
        del ref
        order = sorted(runs, key=lambda k: k != "parent")
        order += order[::-1]
        row["call_ms"] = {k: [] for k in runs}
        row["device_ms"] = {k: [] for k in runs}
        for k in order:
            row["call_ms"][k].append(cs.time_ms(torch, runs[k]))
            row["device_ms"][k].append(cs.time_ms(torch, runs[k],
                                                  host_ahead=True))
        row["pcie_GBps"] = {k: misses * width * 4 / min(v) / 1e6
                            for k, v in row["device_ms"].items()}
        print(json.dumps(row), flush=True)
        return row

    report["inputs"] = [per_input(what, *spec, store.host, parent)
                        for what, spec in inputs.items()]

    # the same misses on a table four times as large
    big = torch.empty((4 * cs.NUM_NODE, width), dtype=torch.float32)
    where = torch.arange(cs.NUM_NODE, dtype=torch.int64)
    where = 4 * where + (7 * where + 3) % 4
    big[where] = store.feat_host
    host4 = MappedHostTable(big, dev)
    del big
    where = where.to(dev)
    posmap4 = torch.full((4 * cs.NUM_NODE,), EMPTY, dtype=torch.int32,
                         device=dev)
    posmap4[where] = store.posmap
    valid = (drawn >= 0) & (drawn < cs.NUM_NODE)
    drawn4 = torch.where(valid, where[torch.where(valid, drawn, 0).long()]
                         .to(torch.int32), drawn)
    row = per_input("drawn, 4x table", drawn4, num, posmap4,
                    store.cache_feat, host4, None)
    out4, _ = tiered_extract(drawn4, num, posmap4, store.cache_feat, host4)
    out1, _ = tiered_extract(drawn, num, store.posmap, store.cache_feat,
                             store.host)
    torch.cuda.synchronize()
    if not torch.equal(out4, out1):
        raise AssertionError("the 4x table's rows differ from the table's")
    del out4, out1
    row["whole_table_copy_ms"] = (host4.tensor.numel() * 4
                                  / report["copy_GBps"]["512MiB"] / 1e6)
    print(f"4x table: a copy_ of its {host4.tensor.numel() * 4} bytes would "
          f"take {row['whole_table_copy_ms']:.3f} ms", flush=True)
    report["inputs"].append(row)
    host4.close()
    del host4, posmap4, drawn4, where, sparse, batch

    # the epochs, the parent's K11 swapped into the same engine in turns
    def epochs(engine, path):
        store = engine.feature_source
        runs = {"new": None}
        if parent is not None:
            def parent_extract(ids, nv):
                out, cnt = parent.extract(torch, _build, ids, nv,
                                          store.posmap, store.cache_feat)
                return out, {"num_hit": cnt[0], "num_miss": cnt[1],
                             "miss_bytes": cnt[1].to(torch.int64)
                             * (width * 4)}
            runs["parent"] = parent_extract
        order = sorted(runs, key=lambda k: k != "parent")
        order = order + order[::-1] + order
        times = {k: [] for k in runs}
        rates = {k: [] for k in runs}
        engine.train_epoch(0)
        for epoch, k in enumerate(order, start=1):
            store.__dict__.pop("extract", None)
            if runs[k] is not None:
                store.extract = runs[k]
            torch.cuda.synchronize()
            r = engine.train_epoch(epoch)
            torch.cuda.synchronize()
            times[k].append(r["time"])
            rates[k].append(r["hit_rate"])
        store.__dict__.pop("extract", None)
        print(f"{path} epochs (s): {times}; hit rates {rates}", flush=True)
        return {"epoch_s": times, "hit_rate": rates}

    report["graphsage_cached"] = epochs(eng, "graphsage_cached")
    del eng, store
    torch.cuda.empty_cache()
    deng = Engine(ds, RunConfig(**dict(cs.BENCH_CONFIG,
                                       cache_percentage=cs.CACHE_PCT,
                                       cache_policy="dynamic_cache"))).init()
    report["graphsage_dynamic"] = epochs(deng, "graphsage_dynamic")
    if parent is not None:
        parent.close()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
