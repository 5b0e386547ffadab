#!/usr/bin/env python3
"""Time K7, the pick multiplicity, at the main path's three layer shapes,
pass by pass, against a parent build.

    python3 xgnn_tpu_torch/tools/time_degree.py [--root DIR] [--turns N]

The inputs are GCN's: ``chip_smoke.py``'s products-scale graph, the picks
of its first batch (seed 7) as ``Sampler`` draws them, layer 0's over the
(2,449,029-row) feature table, layers 1 and 2's over the frontier of the
layer before.  At each layer, in turns (the builds, then back), each
checked exact against the plain version:

- "new": this checkout's ``pick_multiplicity``, the counts and GCN's
  weights (what ``GCNConv`` calls), the weights held bit-equal to the
  plain version's ``torch.rsqrt(torch.clamp(cnt.float(), min=1))``;
  "elementwise weights" is those three launches alone, what the kernel's
  weights replace;
- the variants: this checkout's ``csrc/degree.cu`` changed by text
  substitution (``VARIANTS``), bound by ``ctypes``; "counts_only" writes
  no weights, the work of the parent's kernel;
- "parent": ``DIR``'s wrapper (``DIR/xgnn_tpu_torch``, loaded beside this
  one by ``tools/parent_ops.py``; unpack it first, as in
  ``git archive <commit> | tar -x -C build/parent``), the counts alone,
  and "parent weights", the same followed by the three elementwise
  launches, as the parent's ``GCNConv`` ran them.

Device ms are ``chip_smoke.time_ms`` with the host ahead of the card (its
time alone), the median of the turns; ``torch.bincount``, the library
call, sizes its output on the host and is timed back to back.  Each
build's launches are split by the profiler's device records, in launch
order (a memset and two kernels, in the parent as in the new one): the
count launch's time gives the L2 atomic
rate (valid picks over its seconds), the gather's the bins' read rate.
The last line is one JSON object.
"""

import argparse
import json
import statistics
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
# name: the substitutions that make the variant from csrc/degree.cu
VARIANTS = {
    # the picks read and the counts written evict-first, so that they pass
    # through L2 ahead of the bins
    "stream_hints": [
        ("__ldg(reinterpret_cast<const int4*>(a.ids) + q)",
         "__ldcs(reinterpret_cast<const int4*>(a.ids) + q)"),
        ("reinterpret_cast<int4*>(a.counts)[q] = c;",
         "__stcs(reinterpret_cast<int4*>(a.counts) + q, c);")],
    # the counts alone, the work of the parent's kernel
    "counts_only": [
        ("reinterpret_cast<float4*>(a.weights)[q] = make_float4(\n"
         "          weight(c.x), weight(c.y), weight(c.z), weight(c.w));",
         ""),
        ("a.weights[q] = weight(c);", ""),
        ("a.weights[p] = weight(c);", "")],
}


def build_variants(torch, _build) -> dict:
    """``{name: pick_multiplicity-like callable}`` of the variants, compiled
    in parallel from this checkout's source."""
    import ctypes
    import subprocess

    out_dir = _build.BUILD_DIR / "time_degree"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "degree.cu").read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"time_degree: {name}'s text is not in "
                                   f"degree.cu: {old!r}")
            text = text.replace(old, new)
        src, lib = out_dir / f"degree_{name}.cu", out_dir / f"lib_{name}.so"
        src.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    calls = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"time_degree: {name} did not build:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        fn = cdll.xg_pick_multiplicity
        fn.argtypes = _build.SIGNATURES["degree"]["xg_pick_multiplicity"]
        fn.restype = ctypes.c_int

        def call(ids, num_rows, fn=fn, name=name):
            counts = torch.empty_like(ids)
            w = torch.empty(ids.shape, dtype=torch.float32,
                            device=ids.device)
            hist = torch.empty((max(num_rows, 1),), dtype=torch.int32,
                               device=ids.device)
            _build.check(fn(ids.data_ptr(), counts.data_ptr(), w.data_ptr(),
                            hist.data_ptr(), ids.numel(), num_rows,
                            _build.stream_handle(ids.device)), name)
            return counts if name == "counts_only" else (counts, w)

        calls[name] = call
    return calls


def device_records(torch, fn, reps: int = 10) -> list:
    """``[(name, mean us)]`` of the device records of one call of ``fn``, in
    launch order, over ``reps`` profiled calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    if not events or len(events) % reps:
        return [("unsplit: %d records over %d calls" % (len(events), reps),
                 sum(e.time_range.end - e.time_range.start for e in events)
                 / reps)]
    k = len(events) // reps
    out = []
    for i in range(k):
        name = events[i].name.replace("(anonymous namespace)::", "")
        us = sum(events[j].time_range.end - events[j].time_range.start
                 for j in range(i, len(events), k)) / reps
        out.append((name.split("(")[0][:60], us))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="a parent checkout whose wrapper is timed beside")
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    sys.path.insert(0, str(CHECKOUT / "xgnn_tpu_torch" / "tools"))
    import chip_smoke as cs
    import parent_ops
    import torch

    if not torch.cuda.is_available():
        print("time_degree: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import degree
    from xgnn_tpu_torch.sampler import Sampler

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    from xgnn_tpu_torch.ops import _build

    parent = None if args.root is None else parent_ops.load(args.root,
                                                             "degree")
    variants = build_variants(torch, _build)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    cfg = RunConfig(**cs.BENCH_CONFIG)
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    batch = Sampler(ds.graph, cfg, direct_extract=True).sample(
        torch.from_numpy(seeds).to(dev), n, generator(dev, 7))
    b0, b1, b2 = batch.blocks
    layers = []
    for layer, (nb, rows) in enumerate(((b0.neigh, ds.num_node),
                                        (b1.neigh, b0.dst_cap),
                                        (b2.neigh, b1.dst_cap))):
        valid = (nb >= 0) & (nb < rows)
        picks = int(valid.sum())
        spare = torch.where(valid, nb, rows).reshape(-1).long()
        ref, ref_w = degree.pick_multiplicity_plain(nb, rows)

        builds = {"new": lambda: degree.pick_multiplicity(nb, rows),
                  **{k: (lambda fn=fn: fn(nb, rows))
                     for k, fn in variants.items()}}
        if parent is not None:
            builds["parent"] = lambda: parent.pick_multiplicity(nb, rows)

            def parent_weights():
                got = parent.pick_multiplicity(nb, rows)
                return got, degree.weights_of(got)

            builds["parent weights"] = parent_weights
        for name, fn in builds.items():
            got = fn()
            got, w = got if isinstance(got, tuple) else (got, None)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                raise AssertionError(f"layer {layer}: {name} differs from "
                                     "the plain version")
            if w is not None and not torch.equal(w, ref_w):
                bad = int((w != ref_w).sum())
                raise AssertionError(f"layer {layer}: {name}'s weights "
                                     f"differ from torch.rsqrt at {bad}")
        cnt = ref.clone()

        def elementwise():
            return degree.weights_of(cnt)

        order = list(builds) + ["elementwise weights", "bincount"]
        fns = dict(builds, **{
            "elementwise weights": elementwise,
            "bincount": lambda: torch.bincount(spare,
                                               minlength=rows + 1)[spare]})
        times = {k: [] for k in order}
        for _ in range(args.turns):
            for k in order + order[::-1]:
                # bincount sizes its output on the host: back to back
                times[k].append(cs.time_ms(torch, fns[k],
                                           host_ahead=k != "bincount"))
        row = {"layer": layer, "picks": nb.numel(), "valid": picks,
               "rows": rows,
               "bound_ms": cs.bound_ms(nb.numel() * 8, 0)[0],
               "device_ms": {k: statistics.median(v)
                             for k, v in times.items()},
               "turns": times,
               "records_us": {k: device_records(torch, fns[k])
                              for k in builds if k != "parent weights"}}
        for k, recs in row["records_us"].items():
            if len(recs) >= 2:
                row[f"{k} atomics_per_s"] = picks / (recs[-2][1] * 1e-6)
                row[f"{k} gathers_per_s"] = picks / (recs[-1][1] * 1e-6)
        print(json.dumps(row), flush=True)
        layers.append(row)
    print(json.dumps({"card": card, "layers": [
        {k: v for k, v in r.items() if k != "turns"} for r in layers]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
