#!/usr/bin/env python3
"""Time K12b, presample_static's exact closure, on a products batch and
over a whole ranking, against a parent build.

    python3 xgnn_tpu_torch/tools/time_presample.py [--root DIR] [--turns N]

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="a parent checkout whose wrapper is timed beside")
    ap.add_argument("--turns", type=int, default=2)
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

    builds = {"new": presample.closure_expand,
              **build_variants(torch, _build)}
    if args.root is not None:
        builds["parent"] = parent_ops.load(args.root,
                                           "presample").closure_expand
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
