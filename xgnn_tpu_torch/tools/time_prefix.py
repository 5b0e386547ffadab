#!/usr/bin/env python3
"""Time K8b-prefix against the designs it was chosen over.

    python3 xgnn_tpu_torch/tools/time_prefix.py [--root DIR]

``DIR`` holds the ``xgnn_tpu_torch`` package to time (default: this
checkout), so that two versions of the kernel are timed on one card, each
in a process of its own: unpack the other version (``git archive``) into a
gitignored directory such as ``build/`` and alternate the two roots
(parent, change, change, parent).

The kept kernel reads a row of at most 128 entries whole and searches a
longer row through its coarse row.  The builds beside it, each a library
of its own made from the same source, ``csrc/weighted.cu``:

- "coarse_only": built with ``-DXG_PREFIX_DIRECT_MAX=0``, every row
  through its coarse row;
- for this checkout's source only, "depth_N": N rows' prefix reads in
  flight a warp (N = 2, 6) in place of 4, made by text substitution.

The inputs are those of ``chip_smoke.py``'s phase 7: the weighted
products-scale synthetic dataset (seed 0), the seeds of its first batch,
and one batch walked layer by layer through K8b-prefix and K3 with
uniforms from generator seed 11.  At each layer every build is checked
exactly against the plain version and timed with ``chip_smoke.time_ms``
with the host ahead of the card (``device_ms``, the card's time alone),
kept first, then the others, then the same backwards.  The bytes each
design reads of the rows (whole rows of at most 128 entries; a 512-byte
coarse row for every live row) are printed beside.  The last line is one
JSON object.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


DEPTH = "  constexpr int kDepth = 4;\n"


def build_variants(_build, own: bool) -> dict:
    """The variants' libraries, built in parallel: ``{name: CDLL}``."""
    source = (_build.CSRC / "weighted.cu").read_text()
    variants = {"coarse_only": (source, ["-DXG_PREFIX_DIRECT_MAX=0"])}
    if own:
        if source.count(DEPTH) != 1:
            raise RuntimeError("time_prefix: kDepth is not set in "
                               "weighted.cu once")
        for n in (2, 6):
            variants[f"depth_{n}"] = (source.replace(
                DEPTH, DEPTH.replace("4", str(n))), [])
    out_dir = _build.BUILD_DIR / "time_prefix"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, flags) in variants.items():
        src, lib = out_dir / f"weighted_{name}.cu", out_dir / f"lib_{name}.so"
        src.write_text(text)
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + flags + [
            "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"time_prefix: the {name} build failed:\n"
                               f"{log}")
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.xg_sample_prefix
        fn.argtypes = _build.SIGNATURES["weighted"]["xg_sample_prefix"]
        fn.restype = ctypes.c_int
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
        print("time_prefix: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import xgnn_tpu_torch
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.sampling import (
        EMPTY,
        sample_weighted_khop_prefix,
        sample_weighted_khop_prefix_plain,
    )
    from xgnn_tpu_torch.ops.unique import unique_seeded_split

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    package = os.path.dirname(xgnn_tpu_torch.__file__)
    own = Path(package).resolve() == (CHECKOUT / "xgnn_tpu_torch").resolve()
    print(f"card: {card}; package {package}", flush=True)
    _build.build(["weighted", "unique"])
    libs = build_variants(_build, own)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", weighted=True, dedup=False)
    g = ds.graph
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    frontier = torch.from_numpy(seeds).to(dev)
    num = torch.full((), n, dtype=torch.int32, device=dev)
    gen = generator(dev, 11)
    rows = []
    for layer, k in enumerate(cs.FANOUT):
        u = torch.rand((frontier.shape[0], k), generator=gen, device=dev)
        a = (g.indptr, g.indices, g.prob_prefix_table, frontier, k, None,
             g.n_max_deg, g.coarse_cdf)
        out_other = torch.empty((frontier.shape[0], k), dtype=torch.int32,
                                device=dev)

        def kept():
            return sample_weighted_khop_prefix(*a, u=u)

        # no tier (a version before the tiered topology has no such
        # arguments)
        untiered = ([None, None, None, g.num_node] if len(
            _build.SIGNATURES["weighted"]["xg_sample_prefix"]) > 11 else [])

        def other(lib):
            rc = lib.xg_sample_prefix(
                g.indptr.data_ptr(), g.indices.data_ptr(),
                g.prob_prefix_table.data_ptr(), g.coarse_cdf.data_ptr(),
                frontier.data_ptr(), u.data_ptr(), out_other.data_ptr(),
                g.num_node, frontier.shape[0], k, *untiered,
                _build.stream_handle(dev))
            _build.check(rc, "sample_prefix variant")
            return out_other

        fns = {"kept": kept, **{name: (lambda lib=lib: other(lib))
                                for name, lib in libs.items()}}
        ref = sample_weighted_khop_prefix_plain(*a, u=u)
        got = kept()
        for name, fn in fns.items():
            if not torch.equal(fn(), ref):
                raise AssertionError(f"layer {layer}: the {name} build "
                                     "differs from the plain version")
        times = {name: [] for name in fns}
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(cs.time_ms(torch, fns[name], host_ahead=True))
        ok = (frontier >= 0) & (frontier < g.num_node)
        node = torch.where(ok, frontier, 0).long()
        deg = torch.where(ok, g.indptr[node + 1] - g.indptr[node], 0)
        live = deg[deg > 0]
        row = {"layer": layer, "frontier": frontier.shape[0],
               "live_rows": live.numel(),
               "rows_past_128": int((live > 128).sum()), "fanout": k,
               "picks": int((got != EMPTY).sum()),
               "device_ms": times,
               "direct_read_bytes": int(live[live <= 128].sum()) * 4,
               "coarse_row_bytes": live.numel() * 512}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if layer == len(cs.FANOUT) - 1:
            break
        nxt = unique_seeded_split(frontier, got.reshape(-1), num,
                                  cs.CAPS[layer + 1], num_node=g.num_node)
        frontier, num = nxt[0], torch.clamp(nxt[1], max=cs.CAPS[layer + 1])
    print(json.dumps({"card": card, "package": package, "layers": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
