#!/usr/bin/env python3
"""Time the samplers (K2, K8a, K8b's three forms and K9) against their
parent versions, in turns, untiered or on the tiered topology.

    python3 xgnn_tpu_torch/tools/time_samplers.py --root DIR [--tiered]
        [--only TEXT]

``DIR`` (``--parent`` is the same flag) is a checkout of the version to
compare with, unpacked into a gitignored directory, as in ``git archive
<commit> | tar -x -C build/parent``.  Its ``csrc/sampling.cu``,
``weighted.cu`` and ``random_walk.cu`` are built with its own flags and
bound with the C interface that its ``ops/_build.py`` declares; this
checkout's three are built beside them, and this checkout's
``weighted.cu`` with each flag set of :data:`VARIANTS` (the hash-dedup
form's variants, timed on its cases only), all in parallel.  Each build's
registers and stack a thread are read with ``cuobjdump -res-usage``.
``--only TEXT`` times only the cases whose label holds TEXT (as
``--only hash-dedup``).

The inputs are those of ``chip_smoke.py``: the products-scale synthetic
graph (seed 0), phase 7's edge weights with their prefix, coarse-CDF and
alias tables, and the seeds of the main path's first batch (seed 7).  The
three frontiers are that batch walked layer by layer through K2 and K3
(fanout 15, 10, 5), as the main path's sampler walks it; every sampler
but K9 is timed at each of them with the layer's fanout (K8a as khop1,
K8b-alias with and without hash-dedup).  K9 walks PinSAGE's two layers
(the seeds, then K3's frontier of their picks) with bench.py's walk.

Untiered (the default), every sampler is called with null tier pointers.
With ``--tiered`` the graph is tiered as phase 12 tiers it (0.85 of the
edges on the card, the whole CSR and tables pinned and mapped), the
frontiers are walked over the whole graph, and every sampler is called on
the hot prefix with the tier, after a probe of the card's scattered
mapped host reads (``tools/host_reads.py``).

Every case's output is checked bit-equal between the builds; each is
timed with ``chip_smoke.time_ms`` (``ms`` back to back, ``device_ms`` with
the host ahead of the card: the card's time alone) and with
``chip_smoke.time_flushed_ms`` (``flushed_ms``: a launch alone after L2 is
flushed, so that no launch finds in L2 what the last one read) in the
order parent, new (and the variants), then back, twice; the medians of
the four turns.  The last line is one JSON object.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
SOURCES = ("sampling", "weighted", "random_walk")
# name: nvcc flags that make a variant of this checkout's weighted.cu (the
# hash-dedup form's; csrc/weighted.cu says what each changes)
VARIANTS = {
    "dedup_per1": ["-DXG_DEDUP_PER=1"],  # one draw a thread, always
    "dedup_per2": ["-DXG_DEDUP_PER=2"],  # two draws a thread, always
    "dedup_per4": ["-DXG_DEDUP_PER=4"],  # four draws a thread, always
    "dedup_groups": ["-DXG_DEDUP_LAYOUT=1"],  # lane groups, every instance
    "dedup_dense": ["-DXG_DEDUP_LAYOUT=2"],  # dense, every instance
    "dedup_nostage": ["-DXG_DEDUP_STAGE=0"],  # no cold row staged
}


def registers(_build, lib: Path) -> dict:
    """``{kernel: "REG:n STACK:m"}`` of the library's kernels as
    ``cuobjdump -res-usage`` reads them, demangled where ``cu++filt`` is
    there (empty where cuobjdump is missing)."""
    bin_dir = Path(_build.nvcc()).parent
    tool = bin_dir / "cuobjdump"
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-res-usage", str(lib)],
                          capture_output=True, text=True).stdout
    found = re.findall(r"Function (\S+):\s*(REG:\d+ STACK:\d+)", text)
    filt = bin_dir / "cu++filt"
    out = {}
    for name, use in found:
        if filt.exists() or shutil.which("c++filt"):
            name = subprocess.run(
                [str(filt) if filt.exists() else "c++filt", name],
                capture_output=True, text=True).stdout.strip() or name
        out[name] = use
    return out


def build(_build, parent: Path) -> dict:
    """``{(who, source): (CDLL, signatures, registers)}`` for who in
    ("new", "parent") and every source, and for each of :data:`VARIANTS`
    and weighted.cu, compiled in parallel."""
    out_dir = _build.BUILD_DIR / "time_samplers"
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "xgnn_tpu_torch" / "ops" / "_build.py")
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    roots = {"new": (_build.CSRC, _build.NVCC_FLAGS, _build.SIGNATURES),
             "parent": (parent / "xgnn_tpu_torch" / "csrc",
                        parent_build.NVCC_FLAGS, parent_build.SIGNATURES)}
    jobs = {(who, name): (csrc / f"{name}.cu", flags)
            for who, (csrc, flags, _) in roots.items() for name in SOURCES}
    for who, extra in VARIANTS.items():
        roots[who] = roots["new"]
        jobs[(who, "weighted")] = (_build.CSRC / "weighted.cu",
                                   _build.NVCC_FLAGS + extra)
    procs = {}
    for (who, name), (src, flags) in jobs.items():
        lib = out_dir / f"lib{name}_{who}.so"
        cmd = [_build.nvcc()] + flags + ["-o", str(lib), str(src)]
        procs[(who, name)] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    # the wrappers that walk the frontiers, and the host-read probe: this
    # checkout's own libraries
    _build.build(["sampling", "unique", "random_walk", "tiered", "host_read"])
    libs = {}
    for (who, name), (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"time_samplers: the {who} {name}.cu build "
                               f"failed:\n{log[-2000:]}")
        sigs = roots[who][2][name]
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in sigs.items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[(who, name)] = (cdll, sigs, registers(_build, lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", "--parent", dest="root", required=True,
                    help="a checkout of the version to compare with")
    ap.add_argument("--tiered", action="store_true",
                    help="the tiered instances, on phase 12's tier")
    ap.add_argument("--only", default="",
                    help="time only the cases whose label holds this text")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    import torch

    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.random_walk import (
        draw_uniforms,
        sample_random_walk,
    )
    from xgnn_tpu_torch.ops.sampling import (
        HASH_DEDUP_ROUNDS,
        build_coarse_cdf,
        sample_khop0,
    )
    from xgnn_tpu_torch.ops.unique import unique_seeded_split
    from xgnn_tpu_torch.sampler import make_tiered_topology
    from xgnn_tpu_torch.synthetic_device import (
        alias_tables,
        edge_weights,
        prefix_table,
    )
    from xgnn_tpu_torch.tools import host_reads

    if not torch.cuda.is_available():
        print("time_samplers: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    libs = build(_build, Path(args.root).resolve())
    regs = {f"{who}/{name}": use for (who, name), (_, _, use) in libs.items()}
    print(f"registers: {json.dumps(regs)}", flush=True)
    probe = None
    if args.tiered:
        probe = host_reads.host_read_rates(torch, dev)
        print(f"[{card}] mapped host reads of a "
              f"{host_reads.BUFFER_BYTES} byte buffer: "
              f"{host_reads.describe(probe)}", flush=True)

    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    g = ds.graph
    w = edge_weights(g.num_edge, 0, dev)
    prefix = prefix_table(g.indptr, w)
    coarse = build_coarse_cdf(g.indptr, prefix, g.num_node)
    prob, alias = alias_tables(g.indptr, g.indices, w)
    del w
    nn = n_all = g.num_node
    gr, tier = g, None  # the graph the samplers read, and its tier
    if args.tiered:
        gr, tier, n_all = make_tiered_topology(
            g.indptr, g.indices, cs.TIER_PCT, SampleType.WEIGHTED_KHOP,
            prob_table=prob, alias_table=alias, prob_prefix_table=prefix,
            device=dev)
        nn = gr.num_node
        print(f"tiered at {cs.TIER_PCT}: hot prefix {nn} of {n_all} nodes",
              flush=True)
    else:
        gr.prob_prefix_table, gr.coarse_cdf = prefix, coarse
        gr.prob_table, gr.alias_table = prob, alias
    gen = torch.Generator(device=dev).manual_seed(11)
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH,
                             seed=7).epoch_batches(0))
    seeds = torch.from_numpy(seeds).to(dev)
    stream = _build.stream_handle(dev)

    def entry(name, fn, common, cold_names):
        """``call(who)`` of ``fn`` in ``name``'s builds: ``common`` then,
        where the build takes a tier, the tier's host arrays ``cold_names``
        (null pointers untiered) and the node count, then the stream."""
        def call(who):
            lib, sigs, _ = libs[(who, name)]
            tier_args = []
            if len(sigs[fn]) == len(common) + len(cold_names) + 2:
                tier_args = ([tier.csr.dev_ptr(a) for a in cold_names]
                             + [n_all] if tier is not None
                             else [None] * len(cold_names) + [nn])
            _build.check(getattr(lib, fn)(*common, *tier_args, stream),
                         f"time_samplers {who} {fn}")
        return call

    cases = {}
    frontier = seeds
    num = torch.full((), n, dtype=torch.int32, device=dev)
    khop = ("indptr", "indices")
    for layer, k in enumerate(cs.FANOUT):
        b = frontier.shape[0]
        u = torch.rand((b, k), generator=gen, device=dev)
        coin = torch.rand((b, k), generator=gen, device=dev)
        m = HASH_DEDUP_ROUNDS * k
        um = torch.rand((b, m), generator=gen, device=dev)
        cm = torch.rand((b, m), generator=gen, device=dev)
        rows = int((frontier != torch.iinfo(torch.int32).max).sum())
        n_cold = int(((frontier >= nn) & (frontier < n_all)).sum())
        where = (f"layer {layer}: frontier {b} ({rows} valid, {n_cold} "
                 f"cold) x K={k}")
        fr = frontier

        def add(label, name, fn, common_of, cold_names):
            builds = ["parent", "new"] + (list(VARIANTS) if "hash-dedup"
                                          in label else [])
            outs = {who: torch.empty((b, k), dtype=torch.int32, device=dev)
                    for who in builds}
            cases[f"{label} {where}"] = (
                {who: entry(name, fn, common_of(o), cold_names)
                 for who, o in outs.items()}, outs)

        base = (gr.indptr.data_ptr(), gr.indices.data_ptr(), fr.data_ptr())
        add("K2 khop", "sampling", "xg_sample_khop",
            lambda o, u=u: base + (u.data_ptr(), o.data_ptr(), nn, b, k),
            khop)
        add("K8a khop1", "sampling", "xg_sample_wr",
            lambda o, u=u: base + (u.data_ptr(), o.data_ptr(), nn, b, k, 1),
            khop)
        add("K8b-prefix", "weighted", "xg_sample_prefix",
            lambda o, u=u: (gr.indptr.data_ptr(), gr.indices.data_ptr(),
                            gr.prob_prefix_table.data_ptr(),
                            gr.coarse_cdf.data_ptr(), fr.data_ptr(),
                            u.data_ptr(), o.data_ptr(), nn, b, k),
            khop + ("prob_prefix_table",))
        for dedup, uu, cc in ((0, u, coin), (1, um, cm)):
            add(f"K8b-alias{' hash-dedup' if dedup else ''}", "weighted",
                "xg_sample_alias",
                lambda o, uu=uu, cc=cc, dedup=dedup: (
                    gr.indptr.data_ptr(), gr.indices.data_ptr(),
                    gr.prob_table.data_ptr(), gr.alias_table.data_ptr(),
                    fr.data_ptr(), uu.data_ptr(), cc.data_ptr(),
                    o.data_ptr(), nn, b, k, uu.shape[1], dedup),
                khop + ("prob_table", "alias_table"))
        if layer == len(cs.FANOUT) - 1:
            break
        nbr = sample_khop0(gr.indptr, gr.indices, frontier, k, u=u, tier=tier)
        out = unique_seeded_split(frontier, nbr.reshape(-1), num,
                                  cs.CAPS[layer + 1], num_node=n_all)
        frontier, num = out[0], torch.clamp(out[1], max=cs.CAPS[layer + 1])
    walk = cs.WALK
    wf = seeds
    for layer in range(2):
        b = wf.shape[0]
        uw = draw_uniforms(walk["num_random_walk"],
                           walk["random_walk_length"], b, gen, dev)
        outs = {who: (torch.empty((b, cs.NUM_NEIGHBOR), dtype=torch.int32,
                                  device=dev),
                      torch.empty((b, cs.NUM_NEIGHBOR), device=dev))
                for who in ("new", "parent")}
        cases[f"K9 walk layer {layer}: frontier {b} x "
              f"W={walk['num_random_walk']} L={walk['random_walk_length']}"
              ] = ({who: entry("random_walk", "xg_random_walk", (
                  gr.indptr.data_ptr(), gr.indices.data_ptr(), wf.data_ptr(),
                  uw[0].data_ptr(), uw[1].data_ptr(), o[0].data_ptr(),
                  o[1].data_ptr(), nn, b, walk["num_random_walk"],
                  walk["random_walk_length"], cs.NUM_NEIGHBOR,
                  float(walk["restart_prob"])), khop)
                  for who, o in outs.items()}, outs)
        if layer == 0:
            neigh, _ = sample_random_walk(gr.indptr, gr.indices, seeds,
                                          cs.NUM_NEIGHBOR, u=uw, tier=tier,
                                          **walk)
            wf = unique_seeded_split(
                seeds, neigh.reshape(-1),
                torch.full((), n, dtype=torch.int32, device=dev),
                seeds.shape[0] * (cs.NUM_NEIGHBOR + 1), num_node=n_all)[0]

    rows = {}
    for label, (calls, outs) in cases.items():
        if args.only not in label:
            continue
        for who in calls:
            calls[who](who)
        torch.cuda.synchronize()
        ref = outs["parent"]
        for who, got in outs.items():
            same = (all(torch.equal(x, y) for x, y in zip(got, ref))
                    if isinstance(got, tuple) else torch.equal(got, ref))
            if not same:
                raise AssertionError(f"time_samplers: {label}: the {who} "
                                     "build's output differs from the "
                                     "parent's")
        builds = sorted(calls, key=lambda who: who != "parent")
        got = {who: [] for who in builds}
        for who in (builds + builds[::-1]) * 2:
            fn = (lambda who=who: calls[who](who))
            got[who].append({"ms": cs.time_ms(torch, fn),
                             "device_ms": cs.time_ms(torch, fn,
                                                     host_ahead=True),
                             "flushed_ms": cs.time_flushed_ms(torch, fn)})
        med, over = {}, {}
        for key in ("device_ms", "flushed_ms"):
            med[key] = {who: statistics.median(r[key] for r in runs)
                        for who, runs in got.items()}
            over[key] = {who: med[key][who] / med[key]["parent"]
                         for who in builds if who != "parent"}
        rows[label] = dict(got, median_device_ms=med["device_ms"],
                           median_flushed_ms=med["flushed_ms"],
                           over_parent=over["device_ms"],
                           flushed_over_parent=over["flushed_ms"])
        print(f"[{card}] {label}: " + "; ".join(
            f"{key.replace('_', ' ')} median " + ", ".join(
                f"{who} {med[key][who]:.4f}" for who in builds)
            + " (over parent: " + ", ".join(
                f"{who} {v:.4f}" for who, v in over[key].items()) + ")"
            for key in med) + "; " + "; ".join(
            f"{who} {[round(r['device_ms'], 4) for r in got[who]]} / "
            f"{[round(r['flushed_ms'], 4) for r in got[who]]}"
            for who in builds), flush=True)
    if tier is not None:
        tier.csr.close()
    print(json.dumps({"card": card, "tiered": args.tiered,
                      "registers": regs, "host_reads": probe,
                      "samplers": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
