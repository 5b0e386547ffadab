#!/usr/bin/env python3
"""Time K12b, presample_static's exact closure, on a products batch and
over a whole ranking, and its partitioned form, each against a parent
build.

    python3 xgnn_tpu_torch/tools/time_presample.py [--root DIR] [--turns N]
        [--parts-only]

The graph is ``chip_smoke.py``'s products-scale synthetic dataset (seed 0:
2,449,029 nodes, 123,999,946 edges); a batch is the first of epoch 0 of
``Shuffler(train_set, 8000, seed=7)``, 3 layers, as ``chip_smoke.py``
times K12b; the ranking is ``static_exact_ranking``'s loop (its 25
batches of ``Shuffler(train_set, 8000, seed=42)``, RunConfig's seed, one
epoch) with each build's ``closure_expand``.  The builds are this
checkout's ("new"), the variants (``csrc/presample.cu`` changed by text
substitution, ``VARIANTS``, bound by ``ctypes``) and, given ``DIR``,
``DIR``'s wrapper ("parent", loaded beside this one by
``tools/parent_ops.py``; unpack it first, as in
``git archive <commit> | tar -x -C build/parent``).  Each is first held
exact to the plain version on the batch and at 0-4 layers on the
ranking's first batch, and the rankings are held equal.  In turns (the
parent first, then the others, then back), the batch's device ms
(``chip_smoke.time_ms`` with the host ahead of the card; the median of
the turns), its launches split by the profiler's device records in
launch order, and the ranking's seconds (host clock, ended by a
synchronise).  The bound is ``chip_smoke.py``'s: the seeds, an indptr
pair and the indices of each row within L-1 hops once, the counts read
and written.  The last line is one JSON object.
"""

import argparse
import itertools
import json
import statistics
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
# name: the substitutions that make the variant from csrc/presample.cu
VARIANTS = {
    # every tile through the flattened frontier, none streamed whole
    "no_stream": [("    if (aligned &&", "    if (false &&")],
    # the index reads with the default cache policy, not evict-first
    "ldg": [("__ldcs(", "__ldg(")],
    # the scalar index reads kept out of L1, so that the visited bits
    # have it to themselves
    "no_l1_index": [("  return __ldcs(p);\n}", """  int32_t v;
  asm volatile("ld.global.nc.L1::no_allocate.s32 %0, [%1];"
               : "=r"(v) : "l"(p));
  return v;
}""")],
    # layers below the last probe the level bytes, not the visited bits
    "byte_probe": [("    if (*word & bit) return;\n    atomicOr(word, bit);",
                    "    if (level[v] != 0) return;")],
    # the visited word read from L2 (coherent), not through L1
    "probe_cg": [("    if (*word & bit) return;",
                  "    if (__ldcg(word) & bit) return;")],
    # the mark's atomicOr returns the word: one level store a node
    "atomic_return": [
        ("    atomicOr(word, bit);\n    level[v] = mark;",
         "    if (!(atomicOr(word, bit) & bit)) level[v] = mark;")],
    # four 16-byte reads in flight a lane in a streamed tile
    "vec4": [("constexpr int kVecUnroll = 2;",
              "constexpr int kVecUnroll = 4;")],
    # eight index reads in flight a lane in a flattened tile
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    # hub chunks of 2048 edges
    "hub_2048": [("constexpr int kHub = 512;", "constexpr int kHub = 2048;")],
}


def build_variants(torch, _build) -> dict:
    """``{name: closure_expand-like callable}`` of the variants, compiled in
    parallel from this checkout's source."""
    import ctypes
    import subprocess

    out_dir = _build.BUILD_DIR / "time_presample"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "presample.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"time_presample: {name}'s text is not in "
                                   f"presample.cu: {old!r}")
            text = text.replace(old, new)
        src, lib = out_dir / f"presample_{name}.cu", out_dir / f"lib_{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    calls = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"time_presample: {name} did not build:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build.SIGNATURES["presample"].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = _build.RESTYPES.get(fn, ctypes.c_int)

        def call(indptr, indices, seeds, num_layer, counts, cdll=cdll,
                 name=name):
            dev = seeds.device
            num_node, num_edge = indptr.shape[0] - 1, indices.shape[0]
            size = cdll.xg_closure_scratch_bytes(num_node, num_edge)
            scratch = torch.empty(size, dtype=torch.uint8, device=dev)
            _build.check(cdll.xg_closure_expand(
                indptr.data_ptr(), indices.data_ptr(), num_node, num_edge,
                seeds.data_ptr(), seeds.shape[0], num_layer,
                scratch.data_ptr(), size, counts.data_ptr(), dev.index,
                _build.stream_handle(dev)), name)
            return counts

        calls[name] = call
    return calls


def parts_call(module, new):
    """A build's ``closure_parts`` as ``call(ip, ix, level, recv, tag, part,
    known, counts=None)`` (the parent's takes no part or known set), and
    its plain version likewise."""
    def wrap(fn):
        def call(ip, ix, level, recv, tag, num_node, part, known,
                 counts=None):
            if new:
                return fn(ip, ix, level, recv, tag, num_node, part, known,
                          counts=counts)
            return fn(ip, ix, level, recv, tag, num_node, counts=counts)
        return call
    return wrap(module.closure_parts), wrap(module.closure_parts_plain)


def closure_parts_section(torch, cs, ds, builds, batch_seeds, ranking_seeds,
                          turns):
    """The partitioned form at P = 1 and over 4 lanes, and the exact ranking
    at P = 1, each build in turns.  Returns the JSON rows."""
    from time_degree import device_records

    from xgnn_tpu_torch.ops.presample import closure_expand_plain, closure_known
    from xgnn_tpu_torch.parallel.dist_topology import partition_part

    dev = batch_seeds[0].device
    n_node = cs.NUM_NODE
    layers = len(cs.FANOUT)
    order = sorted(builds, key=lambda k: (k != "parent", k))

    def seeds_recv(p, rows, lanes):
        """Each part's seed marks ``(P lanes, rows)``, made before any
        timing (a scatter, no host read)."""
        recv = [torch.zeros((p, rows + 1), dtype=torch.uint8, device=dev)
                for _ in range(p)]
        for lane, sd in enumerate(lanes):
            ids = sd.long()
            for r in range(p):
                recv[r][lane].scatter_(0, torch.where(ids % p == r, ids // p,
                                                      rows), 1)
        return [t[:, :rows].contiguous() for t in recv]

    def closure(call, plain, parts, seeds, keep):
        """Every part through the layers and the count from the seed marks
        ``seeds``; part 0's state before each call kept (``keep``) and its
        out held to ``plain``."""
        p, rows = len(parts), parts[0].indptr.shape[0] - 1
        recv = [t.clone() for t in seeds]
        level = [torch.zeros((p, rows), dtype=torch.uint8, device=dev)
                 for _ in range(p)]
        known = [closure_known(rows, p, dev) for _ in range(p)]
        kept, counts = [], []
        for tag in range(1, layers + 2):
            last = tag == layers + 1
            if keep:
                kept.append((tag, level[0].clone(), recv[0],
                             known[0].clone()))
            outs = []
            for r, t in enumerate(parts):
                c = (torch.zeros(rows, dtype=torch.int32, device=dev)
                     if last else None)
                outs.append(call(t.indptr, t.indices, level[r], recv[r], tag,
                                 n_node, r, known[r], counts=c))
            if keep:
                _, lv, rc, kn = kept[-1]
                ref = plain(parts[0].indptr, parts[0].indices, lv.clone(),
                            rc, tag, n_node, 0, kn.clone(),
                            counts=torch.zeros(rows, dtype=torch.int32,
                                               device=dev) if last else None)
                if not torch.equal(outs[0], ref):
                    raise AssertionError(f"closure_parts layer {tag}: part "
                                         "0 differs from its plain version")
            if last:
                counts = outs
            elif p == 1:  # the reduce of one rank is its out
                recv = [outs[0][0]]
            else:
                recv = [(sum(o[w].to(torch.int32) for o in outs) > 0).to(
                    torch.uint8) for w in range(p)]
        full = torch.zeros(rows * p, dtype=torch.int32, device=dev)
        for r in range(p):
            full[r::p] = counts[r]
        return kept, full[:n_node]

    out = {}
    ip64 = ds.graph.indptr.long()
    for label, p in (("P = 1", 1), ("4 lanes, part 0 of 4", 4)):
        parts = [partition_part(ip64, ds.graph.indices, p, r)
                 for r in range(p)]
        lanes = batch_seeds[:p]
        want = torch.zeros(n_node, dtype=torch.int32, device=dev)
        for sd in lanes:
            closure_expand_plain(ds.graph.indptr, ds.graph.indices, sd,
                                 layers, want)
        seeds = seeds_recv(p, parts[0].indptr.shape[0] - 1, lanes)
        kept = {}
        for name, (call, plain) in builds.items():
            kept[name], counts = closure(call, plain, parts, seeds, True)
            if not torch.equal(counts, want):
                raise AssertionError(f"{name} ({label}): the counts differ "
                                     "from the single store's closure")
        t0 = parts[0]
        deg = (t0.indptr[1:] - t0.indptr[:-1]).long()
        calls = {}
        for name, (call, _) in builds.items():
            for tag, lv, rc, kn in kept[name]:
                last = tag == layers + 1

                def again(call=call, lv=lv, rc=rc, kn=kn, tag=tag,
                          last=last):
                    return call(t0.indptr, t0.indices, lv.clone(), rc, tag,
                                n_node, 0, kn.clone(),
                                counts=torch.zeros(lv.shape[1],
                                                   dtype=torch.int32,
                                                   device=dev)
                                if last else None)
                calls[(name, tag)] = again
        res = {(k, tag): [] for k in order for tag in range(1, layers + 2)}
        whole = {k: [] for k in order}
        for _ in range(turns):
            for k in order + order[::-1]:
                for tag in range(1, layers + 2):
                    res[(k, tag)].append(cs.time_ms(
                        torch, calls[(k, tag)], reps=5, host_ahead=True))
                if p == 1:
                    call = builds[k][0]
                    whole[k].append(cs.time_ms(torch, lambda call=call: closure(
                        call, None, parts, seeds, False), reps=5,
                        host_ahead=True))
        rows_out = []
        for tag in range(1, layers + 2):
            # the rows a lane reached at this call's update: its level
            # before the next call
            front = (kept["new"][tag][1] == tag).any(0) if tag <= layers \
                else torch.zeros_like(deg, dtype=torch.bool)
            row = {"call": "count" if tag == layers + 1 else f"layer {tag}",
                   "reached_rows": int(front.sum()),
                   "edges": int(deg[front].sum())}
            for k in order:
                row[k] = {"device_ms": statistics.median(res[(k, tag)]),
                          "records_us": device_records(
                              torch, calls[(k, tag)], reps=5)}
            rows_out.append(row)
            print(f"closure_parts {label} {row['call']}: "
                  f"{row['reached_rows']} reached rows' {row['edges']} "
                  "edges; " + "; ".join(
                      f"{k} {row[k]['device_ms']:.4f} device ms" for k in
                      order), flush=True)
        entry = {"rows": rows_out,
                 "batch_ms": {k: sum(r[k]["device_ms"] for r in rows_out)
                              for k in order}}
        if p == 1:
            entry["whole_from_zero_ms"] = {k: statistics.median(v)
                                           for k, v in whole.items()}
        print(f"closure_parts {label}: a batch, the sum of its calls: "
              + "; ".join(f"{k} {v:.4f} device ms" for k, v in
                          entry["batch_ms"].items())
              + ("" if p != 1 else "; from zeroed state: " + "; ".join(
                  f"{k} {v:.4f}" for k, v in
                  entry["whole_from_zero_ms"].items())), flush=True)
        out[label] = entry
        del parts, kept, calls
    # the exact ranking at P = 1, each build's partitioned form
    graph = partition_part(ip64, ds.graph.indices, 1, 0)
    want = torch.zeros(n_node, dtype=torch.int32, device=dev)
    for sd in ranking_seeds:
        closure_expand_plain(ds.graph.indptr, ds.graph.indices, sd, layers,
                             want)
    marks = [seeds_recv(1, n_node, [sd]) for sd in ranking_seeds]

    def ranking(call):
        freq = torch.zeros(n_node, dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for m in marks:
            freq += closure(call, None, [graph], m, False)[1]
        torch.cuda.synchronize()
        return time.perf_counter() - t0, freq

    secs = {k: [] for k in order}
    for k in order:
        if not torch.equal(ranking(builds[k][0])[1], want):
            raise AssertionError(f"{k}: the ranking's counts differ")
    for _ in range(turns):
        for k in order + order[::-1]:
            secs[k].append(ranking(builds[k][0])[0])
    out["ranking_s"] = {k: statistics.median(v) for k, v in secs.items()}
    out["ranking_turns_s"] = secs
    print(f"exact ranking at P = 1 ({len(ranking_seeds)} batches): "
          + "; ".join(
        f"{k} {v:.4f} s" for k, v in out["ranking_s"].items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="a parent checkout whose wrapper is timed beside")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--parts-only", action="store_true",
                    help="time the partitioned form only")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    sys.path.insert(0, str(CHECKOUT / "xgnn_tpu_torch" / "tools"))
    import chip_smoke as cs
    import parent_ops
    import torch
    from time_degree import device_records

    if not torch.cuda.is_available():
        print("time_presample: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import presample

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    from xgnn_tpu_torch.ops import _build

    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    indptr, indices = ds.graph.indptr, ds.graph.indices
    layers = len(cs.FANOUT)
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    bseeds = torch.from_numpy(seeds[:n]).to(dev)
    batches = [torch.from_numpy(s[:v]).to(dev) for s, v in
               Shuffler(ds.train_set, cs.BATCH, seed=42,
                        num_worker=1).epoch_batches(0)]
    lanes = [torch.from_numpy(s[:v]).to(dev) for s, v in itertools.islice(
        Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0), 4)]
    out = {"card": card}
    if not args.parts_only:
        builds = {"new": presample.closure_expand,
                  **build_variants(torch, _build)}
        if args.root is not None:
            builds["parent"] = parent_ops.load(args.root,
                                               "presample").closure_expand
        zero = torch.zeros(cs.NUM_NODE, dtype=torch.int32, device=dev)
        for lay in range(5):
            for b, s in (("batch", bseeds), ("ranking's first batch",
                                             batches[0])):
                if b == "batch" and lay != layers:
                    continue
                ref = presample.closure_expand_plain(indptr, indices, s, lay,
                                                     zero.clone() + 1)
                for name, fn in builds.items():
                    got = fn(indptr, indices, s, lay, zero.clone() + 1)
                    torch.cuda.synchronize()
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{name} differs from the plain "
                                             f"version on the {b} at {lay} "
                                             "layers")
        deg = (indptr[1:] - indptr[:-1]).long()
        marked = [presample.closure_expand_plain(indptr, indices, bseeds, lay,
                                                 zero.clone()).bool()
                  for lay in range(layers + 1)]
        reach = marked[-2]
        need = (bseeds.numel() * 4 + int(reach.sum()) * 8
                + int(deg[reach].sum()) * 4 + cs.NUM_NODE * 8)
        batch = {"seeds": n, "layers": layers,
                 "reached": int(marked[-1].sum()),
                 "rows_within_l_minus_1": int(reach.sum()),
                 "edges_needed": int(deg[reach].sum()),
                 "edges_streamed_by_a_rescan": sum(int(deg[m].sum())
                                                   for m in marked[:-1]),
                 "bound_ms": cs.bound_ms(need, 0)[0]}
        print(json.dumps(batch), flush=True)
        del marked, reach, deg

        def ranking(fn):
            counts = torch.zeros(cs.NUM_NODE, dtype=torch.int32, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for s in batches:
                fn(indptr, indices, s, layers, counts)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, counts

        rankings = {name: ranking(fn)[1] for name, fn in builds.items()}
        if any(not torch.equal(r, rankings["new"]) for r in rankings.values()):
            raise AssertionError("the builds' rankings differ")
        order = sorted(builds, key=lambda k: (k != "parent", k))
        ms = {k: [] for k in order}
        secs = {k: [] for k in order}
        for _ in range(args.turns):
            for k in order + order[::-1]:
                fn = builds[k]
                ms[k].append(cs.time_ms(
                    torch, lambda: fn(indptr, indices, bseeds, layers, zero),
                    reps=5, host_ahead=True))
                secs[k].append(ranking(fn)[0])
        out = {"card": card, "batch": batch, "ranking_batches": len(batches),
               "ranking_reached": int((rankings["new"] > 0).sum()),
               "device_ms": {k: statistics.median(v) for k, v in ms.items()},
               "ranking_s": {k: statistics.median(v) for k, v in secs.items()},
               "turns_ms": ms, "turns_s": secs,
               "records_us": {k: device_records(
                   torch, lambda: builds[k](indptr, indices, bseeds, layers,
                                            zero), reps=5) for k in order}}
    parts_builds = {"new": parts_call(presample, True)}
    if args.root is not None:
        parts_builds["parent"] = parts_call(
            parent_ops.load(args.root, "presample"), False)
    out["closure_parts"] = closure_parts_section(
        torch, cs, ds, parts_builds, lanes, batches, args.turns)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
