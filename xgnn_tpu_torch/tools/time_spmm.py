#!/usr/bin/env python3
"""Time K6 (``csrc/spmm.cu``) at full-graph inference's layer shapes, with
its hub split and against the variants it was chosen over.

    python3 xgnn_tpu_torch/tools/time_spmm.py [--root DIR]

``DIR`` holds the ``xgnn_tpu_torch`` package to time (default: this
checkout), so that two versions of the kernels are timed on one card, each
in a process of its own: unpack the other version (``git archive``) into a
gitignored directory such as ``build/`` and alternate the two roots
(parent, change, change, parent).

The graph is ``chip_smoke.py``'s products-scale synthetic dataset (seed
0: 2,449,029 nodes, 123,999,946 edges); the tables are normal draws
(generator seed 5) at the inference's shapes: K6a's mean form over 128 and
256 columns (graphsage, pinsage), its sum over 256 and 47 (gcn), and K6b
at (1, 256), (1, 47) (gat1) and (8, 32) (gat8).  At each shape the device
ms (``chip_smoke.time_ms`` with the host ahead of the card) of:

- each build, by hub cap: 2048 (what the package passes), 256, and none
  (2^31 - 1: every row on the rows kernel, no hub kernel);
- each build over the same graph with the rows past 2048 edges emptied
  ("hubs excluded": what the rows kernel alone takes for the rest).

The builds are "new" (the package's source) and, for this checkout's
source only, variants made here from it by text substitution:
"full_grid" (a block per 8 rows, every row its own warp, scheduled by the
hardware as blocks finish, in place of the resident grid that strides
over the rows), "not_lean" (K6b's scalar one-head rows with 8 edges'
rows in flight a warp and no register cap, as its other rows), "shared_l2"
(K6b's feature rows at one head read with the default cache policy, not
evict-first), "stream_all" (K6b's feature rows read evict-first at every
head count, not at one head only) and "rows_after_scores" (K6b's first
group of rows loaded after the batch's scores, in place of before them).  Every build's result
is first held to the plain version within 1e-5 of the same aggregate of
the terms' magnitudes, as ``chip_smoke.py`` holds K6.  Turns run new, the variants,
then the same backwards.  The last line is one JSON object.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
# name: the substitutions that make the variant from csrc/spmm.cu
VARIANTS = {
    "full_grid": [(
        "  return (unsigned)(want < resident ? (want > 0 ? want : 1) : "
        "resident);",
        "  return (unsigned)(want > 0 ? want : 1);")],
    "not_lean": [
        ("__launch_bounds__(kThreads, kLean<V, kH> ? 6 : 1)",
         "__launch_bounds__(kThreads)"),
        ("      kLean<V, kH> || sizeof(V) * kV > 16 ? kGroup / 2 : kGroup;",
         "      sizeof(V) * kV > 16 ? kGroup / 2 : kGroup;")],
    "shared_l2": [("        x[i][u] = kH == 1 ? __ldcs(at) : __ldg(at);",
                   "        x[i][u] = __ldg(at);")],
    "stream_all": [("        x[i][u] = kH == 1 ? __ldcs(at) : __ldg(at);",
                    "        x[i][u] = __ldcs(at);")],
    "rows_after_scores": [
        ("    V x[G][kV];\n    load_group<V, kV, kH, G>(feat, id, 0, n, wv, "
         "p, x);\n", "    V x[G][kV];\n"),
        ("      if (g0 > 0) load_group<", "      load_group<")],
}
HUB_CAPS = (2048, 256, 2**31 - 1)
SHAPES = (("spmm", "mean", 128), ("spmm", "mean", 256), ("spmm", "sum", 256),
          ("spmm", "sum", 47), ("gat", 1, 256), ("gat", 1, 47),
          ("gat", 8, 32))


def build_variants(_build) -> dict:
    out_dir = _build.BUILD_DIR / "time_spmm"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "spmm.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"time_spmm: the {name} variant's text is "
                                   f"not in spmm.cu once: {old!r}")
            text = text.replace(old, new)
        src, lib = out_dir / f"spmm_{name}.cu", out_dir / f"libspmm_{name}.so"
        src.write_text(text)
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"time_spmm: the {name} build failed:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build.SIGNATURES["spmm"].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(CHECKOUT),
                    help="the directory holding the xgnn_tpu_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("xgnn_tpu_torch")]:
        del sys.modules[name]  # the package under --root, not this one
    import torch

    if not torch.cuda.is_available():
        print("time_spmm: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import xgnn_tpu_torch
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.spmm import (
        gat_aggregate_csr_plain,
        spmm_csr_plain,
    )

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    package = os.path.dirname(xgnn_tpu_torch.__file__)
    own = Path(package).resolve() == (CHECKOUT / "xgnn_tpu_torch").resolve()
    print(f"card: {card}; package {package}", flush=True)
    t0 = time.perf_counter()
    libs = {"new": _build.load("spmm"),
            **(build_variants(_build) if own else {})}
    print(f"builds: {time.perf_counter() - t0:.3f} s, {sorted(libs)}",
          flush=True)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    n = ds.num_node
    graphs = {"all rows": (ds.graph.indptr, ds.graph.indices)}
    deg = ds.graph.indptr[1:] - ds.graph.indptr[:-1]
    hub = deg > 2048
    keep_deg = torch.where(hub, 0, deg)
    keep_edge = torch.repeat_interleave(~hub, deg.long(),
                                        output_size=ds.num_edge)
    graphs["hubs excluded"] = (
        torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                   torch.cumsum(keep_deg, 0).to(torch.int32)]),
        ds.graph.indices[keep_edge].contiguous())
    print(f"graph: {n} nodes, {ds.num_edge} edges, largest degree "
          f"{int(deg.max())}; {int(hub.sum())} rows past 2048 hold "
          f"{int(deg[hub].sum())} edges", flush=True)
    ds.feat = None
    gen = torch.Generator(device=dev).manual_seed(5)
    stream = _build.stream_handle(dev)
    results = []
    for kind, a, b in SHAPES:
        if kind == "spmm":
            form, width = a, b
            h = torch.randn((n, width), generator=gen, device=dev)
            out = torch.empty_like(h)

            def call(lib, graph, cap, h=h, out=out, form=form):
                ip, ix = graph
                rc = lib.xg_spmm_csr(ip.data_ptr(), ix.data_ptr(),
                                     h.data_ptr(), out.data_ptr(), n, n,
                                     h.shape[1], int(form == "mean"), cap,
                                     stream)
                _build.check(rc, "xg_spmm_csr")
                return out
            what = f"spmm_csr {form} F={width}"
        else:
            heads, d = a, b
            feat = torch.randn((n, heads, d), generator=gen, device=dev)
            el, er = (torch.randn((n, heads), generator=gen, device=dev)
                      for _ in range(2))
            out = torch.empty_like(feat)

            def call(lib, graph, cap, feat=feat, el=el, er=er, out=out):
                ip, ix = graph
                rc = lib.xg_gat_csr(ip.data_ptr(), ix.data_ptr(),
                                    feat.data_ptr(), el.data_ptr(),
                                    er.data_ptr(), out.data_ptr(), n, n,
                                    feat.shape[1], feat.shape[2], 0.2, cap,
                                    stream)
                _build.check(rc, "xg_gat_csr")
                return out
            what = f"gat_aggregate_csr ({heads}, {d})"
        ip, ix = graphs["all rows"]
        if kind == "spmm":
            want = spmm_csr_plain(ip, ix, h, num_node=n, mean=form == "mean")
            mass = spmm_csr_plain(ip, ix, h.abs(), num_node=n,
                                  mean=form == "mean")
        else:
            want = gat_aggregate_csr_plain(ip, ix, feat, el, er, num_node=n)
            mass = gat_aggregate_csr_plain(ip, ix, feat.abs(), el, er,
                                           num_node=n)
        for name, lib in libs.items():
            got = call(lib, graphs["all rows"], HUB_CAPS[0])
            if not bool(((got - want).abs() <= 1e-5 * mass + 1e-7).all()):
                raise AssertionError(f"{what}: {name} differs from the "
                                     "plain version")
        del want, mass, got
        cases = [(name, graph, cap) for name in libs for graph in graphs
                 for cap in (HUB_CAPS if graph == "all rows"
                             else HUB_CAPS[:1])]
        times = {c: [] for c in cases}
        for case in cases + cases[::-1]:
            name, graph, cap = case
            times[case].append(cs.time_ms(
                torch, lambda: call(libs[name], graphs[graph], cap),
                reps=5, host_ahead=True))
        for (name, graph, cap), t in times.items():
            label = "none" if cap == HUB_CAPS[-1] else cap
            print(f"[{card}] {what}: {name}, {graph}, hub cap {label}: "
                  f"{' / '.join(f'{x:.4f}' for x in t)} ms", flush=True)
            results.append({"shape": what, "build": name, "graph": graph,
                            "hub_cap": cap, "device_ms": t})
        del out, call
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": package,
                      "times": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
