#!/usr/bin/env python3
"""Time the owner exchange's pieces at P = 1 on one card, and name what
runs on the card for each; then K13-plan alone, against its variants and
a parent build.

    python3 xgnn_tpu_torch/tools/time_exchange.py [--root DIR] [--turns N]

It builds ``chip_smoke.py``'s products-sized graph (phase 3's), a
``MultiChipEngine`` at bench width in a world of one over NCCL
(``use_dist_graph``, the interleaved store), and samples the first batch
of its first epoch, as ``train_epoch`` does.  It then times the exchange
that step runs for its features: the batch's input frontier (its
capacity, its valid prefix and EMPTY after it) through
``partitioned_gather_indirect`` at the step's segment ``min(seg_cap, n)``.
For each piece (K13-plan; the ids' ``all_to_all_single``; K1's serve; the
rows' ``all_to_all_single``; the whole ``partitioned_gather_indirect``;
and, beside them, one ``Tensor.copy_`` of the rows) it prints the device
ms (``chip_smoke.time_ms`` with the host ahead of the card) and the device
microseconds per call of each kernel or copy the profiler records, with
the bytes the piece must move over 3.35 TB/s.

K13-plan alone: the three layers' frontiers of that batch, walked as
``sample_minibatch_partitioned`` walks them (``chip_smoke.py``'s K13
rows), each planned at P = 1, 2, 4 and 8 (the segment as the step sizes it
at P = 1, ``ceil(n / P * exchange_headroom)`` above).  The builds: this
checkout's wrapper ("a", the single pass with decoupled look-back), the
variants of ``VARIANTS`` built in parallel and called through this
checkout's wrapper (variant (b), "b_cluster": ``csrc/exchange.cu`` built
with ``-DXG_PLAN_CLUSTER``, one 16-block cluster on distributed shared
memory; (a) with other tile sizes) and, given ``DIR``, ``DIR``'s
wrapper ("parent", loaded beside this one by ``tools/parent_ops.py``;
unpack it first, as in ``git archive <commit> | tar -x -C build/parent``).
Each is first held bit-equal to the plain version (send, pick, overflow).
Then in turns (the parent first, then the others, then back): the device
ms (``chip_smoke.time_ms`` with the host ahead of the card), the ms of 10
calls back to back (the host's time where it is slower), the host
microseconds a call (100 calls queued, no synchronise), and the device
microseconds of each kernel and memset by the profiler's records; the
medians of the turns.  The bound is the ids read once and send and pick
written once over 3.35 TB/s.  Last, the wrapper's host microseconds a
call piece by piece at the feature exchange's shape.  The last line is
one JSON object.
"""

import argparse
import dataclasses
import json
import math
import statistics
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


# name: (nvcc flags, text substitutions) that make a variant of
# csrc/exchange.cu
VARIANTS = {
    # (b): one 16-block cluster on distributed shared memory
    "b_cluster": (["-DXG_PLAN_CLUSTER"], []),
    # (a) with tiles of 4,096 ids (half the tiles and look-back steps)
    "a_rounds16": ([], [("constexpr int kRounds = 8;",
                         "constexpr int kRounds = 16;")]),
    # (a) with tiles of 1,024 ids
    "a_rounds4": ([], [("constexpr int kRounds = 8;",
                        "constexpr int kRounds = 4;")]),
}


def build_variants(torch, _build, exchange) -> dict:
    """``{name: plan_exchange-like callable}`` of the variants, compiled in
    parallel and called through this checkout's wrapper."""
    import ctypes
    import subprocess

    out_dir = _build.BUILD_DIR / "time_exchange"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "exchange.cu").read_text()
    procs = {}
    for name, (flags, subs) in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"time_exchange: {name}'s text is not in "
                                   f"exchange.cu: {old!r}")
            text = text.replace(old, new)
        src, lib = out_dir / f"exchange_{name}.cu", out_dir / f"lib_{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + flags
            + ["-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    calls = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"time_exchange: {name} did not build:\n{log}")
        fn = ctypes.CDLL(str(lib)).xg_plan_exchange
        fn.argtypes = _build.SIGNATURES["exchange"]["xg_plan_exchange"]
        fn.restype = ctypes.c_int

        def call(ids, p, seg, hot_limit=None, fn=fn):
            saved = exchange._entry[:]
            exchange._entry[:] = [fn]
            try:
                return exchange.plan_exchange(ids, p, seg, hot_limit)
            finally:
                exchange._entry[:] = saved

        calls[name] = call
    return calls


def host_parts_us(torch, ids, p, seg) -> dict:
    """The wrapper's host microseconds a call, piece by piece: the checks
    and the layout, the allocation, the C call (the memset and the launch
    queued), the three views."""
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.parallel import exchange

    n = ids.shape[0]
    pick_at, flag_at, words = exchange.plan_layout(n, p, seg)
    buf = torch.empty(words, dtype=torch.int32, device=ids.device)
    fn = exchange._plan_entry()
    pieces = {
        "whole call": lambda: exchange.plan_exchange(ids, p, seg),
        "layout": lambda: exchange.plan_layout(n, p, seg),
        "torch.empty": lambda: torch.empty(words, dtype=torch.int32,
                                           device=ids.device),
        "C call": lambda: fn(ids.data_ptr(), n, p, 2**31 - 1, seg,
                             buf.data_ptr(), _build.stream_handle(ids.device)),
        "views": lambda: (buf[:p * seg].view(p, seg),
                          buf[pick_at:pick_at + n],
                          buf.view(torch.bool)[4 * flag_at]),
    }
    return {k: host_us(torch, f, 200) for k, f in pieces.items()}


def host_us(torch, fn, calls: int = 100) -> float:
    """Host microseconds a call of ``fn``, ``calls`` queued without a
    synchronise (after the card has caught up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def plan_alone(torch, cs, meng, ds, cfg, builds, turns):
    """K13-plan at the layers' frontiers and P = 1, 2, 4, 8: each build
    exact, then timed in turns.  Returns the JSON rows."""
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.ops.unique import unique_seeded_split
    from xgnn_tpu_torch.parallel import dist_topology
    from xgnn_tpu_torch.parallel.exchange import plan_exchange_plain
    from xgnn_tpu_torch.tools.time_unique import kernel_us

    dev = meng.device
    it = meng._shuffler(ds.train_set, cfg.seed + 1).epoch_batches(0)
    seeds, n = meng._next(it)
    frontier = seeds
    num_f = torch.full((), n, dtype=torch.int32, device=dev)
    caps, fronts = meng.capacities, []
    for layer, k in enumerate(cs.FANOUT):
        seg = max(int(-(-meng.seg_cap * caps[layer] // caps[-1])), 128)
        fronts.append((layer, frontier, max(min(seg, frontier.shape[0]), 1)))
        nbr, _ = dist_topology.sample_layer_partitioned(
            meng.topo, frontier, k, meng.mesh, fronts[-1][2],
            cfg.sample_type, generator(dev, 160 + layer))
        frontier, num_u, _ = unique_seeded_split(
            frontier, nbr.reshape(-1), num_f, caps[layer + 1],
            num_node=cs.NUM_NODE)
        num_f = torch.clamp(num_u, max=caps[layer + 1])
    order = sorted(builds, key=lambda k: (k != "parent", k))
    rows = []
    for layer, f, seg1 in fronts:
        for p in (1, 2, 4, 8):
            seg = seg1 if p == 1 else math.ceil(
                f.shape[0] / p * cfg.exchange_headroom)
            want = plan_exchange_plain(f, p, seg)
            for name, fn in builds.items():
                got = fn(f, p, seg)
                for key in ("send", "pick", "overflow"):
                    if not torch.equal(getattr(got, key), getattr(want, key)):
                        raise AssertionError(f"{name} layer {layer} P = {p}: "
                                             f"{key} differs")
            res = {k: {"device_ms": [], "ms": [], "host_us": []}
                   for k in order}
            for _ in range(turns):
                for k in order + order[::-1]:
                    fn = builds[k]
                    call = lambda fn=fn: fn(f, p, seg)
                    res[k]["device_ms"].append(cs.time_ms(torch, call,
                                                          host_ahead=True))
                    res[k]["ms"].append(cs.time_ms(torch, call))
                    res[k]["host_us"].append(host_us(torch, call))
            row = {"layer": layer, "parts": p, "ids": f.shape[0],
                   "valid": int((f != 2**31 - 1).sum()), "seg": seg,
                   "bound_ms": cs.bound_ms(f.shape[0] * 8 + p * seg * 4,
                                           0)[0]}
            for k in order:
                fn = builds[k]
                row[k] = {m: statistics.median(v) for m, v in res[k].items()}
                row[k]["kernel_us"] = kernel_us(torch, lambda: fn(f, p, seg))
            rows.append(row)
            print(f"K13-plan layer {layer} ({f.shape[0]} ids) at P = {p} "
                  f"into ({p}, {seg}): bound {row['bound_ms']:.5f} ms; "
                  + "; ".join(f"{k} {row[k]['device_ms']:.4f} device ms, "
                              f"{row[k]['ms']:.4f} ms back to back, "
                              f"{row[k]['host_us']:.1f} host us"
                              for k in order), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="a parent checkout whose K13-plan is timed beside")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    sys.path.insert(0, str(CHECKOUT / "xgnn_tpu_torch" / "tools"))
    import chip_smoke as cs
    import parent_ops
    import torch

    if not torch.cuda.is_available():
        print("time_exchange: no CUDA device", file=sys.stderr)
        return 2
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator, seed_of
    from xgnn_tpu_torch.engine.engine import _SAMPLE
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch.ops.gather import gather_rows
    from xgnn_tpu_torch.parallel.collocated import sample_any
    from xgnn_tpu_torch.parallel.exchange import (
        local_rows_of,
        partitioned_gather_indirect,
        plan_exchange,
    )
    from xgnn_tpu_torch.tools.time_unique import kernel_us

    card = cs.card_line()
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    cfg = dataclasses.replace(RunConfig(**cs.BENCH_CONFIG), arch="arch6",
                              num_worker=1, use_dist_graph=True,
                              part_cache=True)
    meng = MultiChipEngine(ds, cfg).init()
    try:
        mesh, p, table = meng.mesh, meng.num_parts, meng.feat_part
        it = meng._shuffler(ds.train_set, cfg.seed + 1).epoch_batches(0)
        seeds, n = meng._next(it)
        gen = generator(meng.device, seed_of(cfg.seed, _SAMPLE, 0, 0,
                                             meng.rank))
        batch = sample_any(meng.topo, seeds, n, cfg, meng.capacities,
                           meng.seg_cap, mesh, True, gen)
        ids = batch.input_nodes
        num_ids, num_valid = ids.shape[0], int(batch.num_input)
        seg = max(min(meng.seg_cap, num_ids), 1)
        feat_dim, item = table.shape[1], table.element_size()
        plan = plan_exchange(ids, p, seg)
        req = mesh.all_to_all(plan.send.reshape(-1))
        rows = gather_rows(table, local_rows_of(req, p))
        slots = p * seg
        row_bytes = slots * feat_dim * item
        pieces = {
            "plan_exchange": (lambda: plan_exchange(ids, p, seg),
                              num_ids * 8 + slots * 4),
            "all_to_all ids": (lambda: mesh.all_to_all(plan.send.reshape(-1)),
                               slots * 8),
            "K1 serve": (lambda: gather_rows(table, local_rows_of(req, p)),
                         num_valid * feat_dim * item + row_bytes + slots * 4),
            "all_to_all rows": (lambda: mesh.all_to_all(rows), 2 * row_bytes),
            "partitioned_gather_indirect": (
                lambda: partitioned_gather_indirect(table, ids, mesh, seg),
                num_ids * 8 + num_valid * feat_dim * item + row_bytes),
            "copy_ of the rows": (lambda: torch.empty_like(rows).copy_(rows),
                                  2 * row_bytes),
        }
        out = {"card": card, "num_ids": num_ids, "num_valid": num_valid,
               "seg": seg, "capacities": meng.capacities, "pieces": {}}
        print(f"[{card}] the step's feature exchange: {num_ids} ids "
              f"({num_valid} valid) into ({p}, {seg}), rows of {feat_dim} x "
              f"{item} bytes; capacities {meng.capacities}", flush=True)
        for name, (fn, nbytes) in pieces.items():
            device_ms = cs.time_ms(torch, fn, host_ahead=True)
            us = kernel_us(torch, fn)
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            out["pieces"][name] = {"device_ms": device_ms, "bound_ms": bound,
                                   "kernel_us": us}
            print(f"[{card}] {name}: {device_ms:.4f} device ms (bound "
                  f"{bound:.4f}); by kernel (us a call): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                      us.items(), key=lambda kv: -kv[1])), flush=True)
        from xgnn_tpu_torch.ops import _build
        from xgnn_tpu_torch.parallel import exchange

        builds = {"a": plan_exchange,
                  **build_variants(torch, _build, exchange)}
        if args.root is not None:
            builds["parent"] = parent_ops.load(
                args.root, "parallel.exchange").plan_exchange
        out["plan_alone"] = plan_alone(torch, cs, meng, ds, cfg, builds,
                                       args.turns)
        out["host_us"] = host_parts_us(torch, ids, p, seg)
        print("K13-plan's wrapper, host us a call at the feature exchange's "
              "shape: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                     out["host_us"].items()), flush=True)
    finally:
        meng.close()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
