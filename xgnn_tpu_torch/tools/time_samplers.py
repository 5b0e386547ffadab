#!/usr/bin/env python3
"""Time the untiered samplers (K2, K8a, K8b's three forms and K9) against
their parent versions, in turns.

    python3 xgnn_tpu_torch/tools/time_samplers.py --parent DIR

``DIR`` is a checkout of the version to compare with, unpacked into a
gitignored directory, as in ``git archive <commit> | tar -x -C
build/parent``.  Its ``csrc/sampling.cu``, ``weighted.cu`` and
``random_walk.cu`` are built with its own flags and bound with the C
interface that its ``ops/_build.py`` declares; this checkout's three are
built beside them, all in parallel, and called untiered (null tier
pointers).  Each build's registers and stack a thread are read with
``cuobjdump -res-usage``.

The inputs are those of ``chip_smoke.py``: the products-scale synthetic
graph (seed 0), phase 7's edge weights with their prefix, coarse-CDF and
alias tables, and the seeds of the main path's first batch (seed 7).  The
three frontiers are that batch walked layer by layer through K2 and K3
(fanout 15, 10, 5), as the main path's sampler walks it; every sampler
but K9 is timed at each of them with the layer's fanout (K8a as khop1,
K8b-alias with and without hash-dedup).  K9 walks PinSAGE's two layers
(the seeds, then K3's frontier of their picks) with bench.py's walk.
Every case's output is checked bit-equal between the two builds; each
is timed with ``chip_smoke.time_ms`` (``ms`` back to back, ``device_ms``
with the host ahead of the card: the card's time alone) in the order
parent, new, new, parent, twice.  The last line is one JSON object.
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
ORDER = ("parent", "new", "new", "parent") * 2


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
    ("new", "parent"), compiled in parallel."""
    out_dir = _build.BUILD_DIR / "time_samplers"
    out_dir.mkdir(parents=True, exist_ok=True)
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "xgnn_tpu_torch" / "ops" / "_build.py")
    parent_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(parent_build)
    roots = {"new": (_build.CSRC, _build.NVCC_FLAGS, _build.SIGNATURES),
             "parent": (parent / "xgnn_tpu_torch" / "csrc",
                        parent_build.NVCC_FLAGS, parent_build.SIGNATURES)}
    procs = {}
    for who, (csrc, flags, _) in roots.items():
        for name in SOURCES:
            lib = out_dir / f"lib{name}_{who}.so"
            cmd = [_build.nvcc()] + flags + ["-o", str(lib),
                                             str(csrc / f"{name}.cu")]
            procs[(who, name)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    # the wrappers that walk the frontiers: this checkout's own libraries
    _build.build(["sampling", "unique", "random_walk"])
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
    ap.add_argument("--parent", required=True,
                    help="a checkout of the version to compare with")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    import torch

    from xgnn_tpu_torch import make_device_dataset
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
    from xgnn_tpu_torch.synthetic_device import (
        alias_tables,
        edge_weights,
        prefix_table,
    )

    if not torch.cuda.is_available():
        print("time_samplers: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    libs = build(_build, Path(args.parent).resolve())
    regs = {f"{who}/{name}": use for (who, name), (_, _, use) in libs.items()}
    print(f"registers: {json.dumps(regs)}", flush=True)

    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth")
    g = ds.graph
    w = edge_weights(g.num_edge, 0, dev)
    prefix = prefix_table(g.indptr, w)
    coarse = build_coarse_cdf(g.indptr, prefix, g.num_node)
    prob, alias = alias_tables(g.indptr, g.indices, w)
    del w
    gen = torch.Generator(device=dev).manual_seed(11)
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH,
                             seed=7).epoch_batches(0))
    seeds = torch.from_numpy(seeds).to(dev)
    stream = _build.stream_handle(dev)
    nn = g.num_node

    def entry(name, fn, common, n_cold):
        """``call(who)`` of ``fn`` in ``name``'s two builds: ``common``
        then, where the build takes a tier, ``n_cold`` null pointers and
        the node count, then the stream."""
        def call(who):
            lib, sigs, _ = libs[(who, name)]
            tier = ([None] * n_cold + [nn]
                    if len(sigs[fn]) == len(common) + n_cold + 2 else [])
            _build.check(getattr(lib, fn)(*common, *tier, stream),
                         f"time_samplers {who} {fn}")
        return call

    cases = {}
    frontier = seeds
    num = torch.full((), n, dtype=torch.int32, device=dev)
    for layer, k in enumerate(cs.FANOUT):
        b = frontier.shape[0]
        u = torch.rand((b, k), generator=gen, device=dev)
        coin = torch.rand((b, k), generator=gen, device=dev)
        m = HASH_DEDUP_ROUNDS * k
        um = torch.rand((b, m), generator=gen, device=dev)
        cm = torch.rand((b, m), generator=gen, device=dev)
        rows = int((frontier != torch.iinfo(torch.int32).max).sum())
        where = f"layer {layer}: frontier {b} ({rows} valid) x K={k}"
        fr = frontier
        outs = {who: torch.empty((b, k), dtype=torch.int32, device=dev)
                for who in ("new", "parent")}

        def add(label, name, fn, common_of, n_cold, outs=outs):
            cases[f"{label} {where}"] = (
                {who: entry(name, fn, common_of(o), n_cold)
                 for who, o in outs.items()}, outs)

        base = (g.indptr.data_ptr(), g.indices.data_ptr(), fr.data_ptr())
        add("K2 khop", "sampling", "xg_sample_khop",
            lambda o, u=u: base + (u.data_ptr(), o.data_ptr(), nn, b, k), 2)
        # fresh outputs a case, so no case reads another's result
        add("K8a khop1", "sampling", "xg_sample_wr",
            lambda o, u=u: base + (u.data_ptr(), o.data_ptr(), nn, b, k, 1),
            2, outs={who: torch.empty_like(o) for who, o in outs.items()})
        add("K8b-prefix", "weighted", "xg_sample_prefix",
            lambda o, u=u: (g.indptr.data_ptr(), g.indices.data_ptr(),
                            prefix.data_ptr(), coarse.data_ptr(),
                            fr.data_ptr(), u.data_ptr(), o.data_ptr(), nn,
                            b, k), 3,
            outs={who: torch.empty_like(o) for who, o in outs.items()})
        for dedup, uu, cc in ((0, u, coin), (1, um, cm)):
            add(f"K8b-alias{' hash-dedup' if dedup else ''}", "weighted",
                "xg_sample_alias",
                lambda o, uu=uu, cc=cc, dedup=dedup: (
                    g.indptr.data_ptr(), g.indices.data_ptr(),
                    prob.data_ptr(), alias.data_ptr(), fr.data_ptr(),
                    uu.data_ptr(), cc.data_ptr(), o.data_ptr(), nn, b, k,
                    uu.shape[1], dedup), 4,
                outs={who: torch.empty_like(o) for who, o in outs.items()})
        if layer == len(cs.FANOUT) - 1:
            break
        nbr = sample_khop0(g.indptr, g.indices, frontier, k, u=u)
        out = unique_seeded_split(frontier, nbr.reshape(-1), num,
                                  cs.CAPS[layer + 1], num_node=nn)
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
                  g.indptr.data_ptr(), g.indices.data_ptr(), wf.data_ptr(),
                  uw[0].data_ptr(), uw[1].data_ptr(), o[0].data_ptr(),
                  o[1].data_ptr(), nn, b, walk["num_random_walk"],
                  walk["random_walk_length"], cs.NUM_NEIGHBOR,
                  float(walk["restart_prob"])), 2)
                  for who, o in outs.items()}, outs)
        if layer == 0:
            neigh, _ = sample_random_walk(g.indptr, g.indices, seeds,
                                          cs.NUM_NEIGHBOR, u=uw, **walk)
            wf = unique_seeded_split(
                seeds, neigh.reshape(-1),
                torch.full((), n, dtype=torch.int32, device=dev),
                seeds.shape[0] * (cs.NUM_NEIGHBOR + 1), num_node=nn)[0]

    rows = {}
    for label, (calls, outs) in cases.items():
        for who in ("new", "parent"):
            calls[who](who)
        torch.cuda.synchronize()
        a, b_ = outs["new"], outs["parent"]
        same = (all(torch.equal(x, y) for x, y in zip(a, b_))
                if isinstance(a, tuple) else torch.equal(a, b_))
        if not same:
            raise AssertionError(f"time_samplers: {label}: the new build's "
                                 "output differs from the parent's")
        got = {"new": [], "parent": []}
        for who in ORDER:
            fn = (lambda who=who: calls[who](who))
            got[who].append({"ms": cs.time_ms(torch, fn),
                             "device_ms": cs.time_ms(torch, fn,
                                                     host_ahead=True)})
        med = {who: statistics.median(r["device_ms"] for r in runs)
               for who, runs in got.items()}
        rows[label] = dict(got, median_device_ms=med,
                           new_over_parent=med["new"] / med["parent"])
        print(f"[{card}] {label}: device ms median new {med['new']:.4f} "
              f"parent {med['parent']:.4f} (new/parent "
              f"{med['new'] / med['parent']:.4f}); new "
              f"{[round(r['device_ms'], 4) for r in got['new']]}, parent "
              f"{[round(r['device_ms'], 4) for r in got['parent']]}",
              flush=True)
    print(json.dumps({"card": card, "registers": regs, "samplers": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
