#!/usr/bin/env python3
"""Time K11 (the tiered extract) against builds of other designs.

    python3 xgnn_tpu_torch/tools/time_tiered.py [--variants NAME ...]

The inputs are those of ``chip_smoke.py``'s phase 8: the products-scale
synthetic dataset (seed 0), GraphSAGE's configuration at cache 0.2 with
``pre_sample`` (its engine's presample ranking, its table pinned and
mapped), and the input nodes of one non-direct batch (the seeds of
``chip_smoke.py``'s first batch, generator seed 7).  Each variant is
``csrc/tiered.cu`` changed by text substitution and built into a library
of its own (:data:`VARIANTS`: the grid on every multiprocessor's resident
blocks, on 66 or on 16 blocks, in place of a quarter of the
multiprocessors; 16 rows a warp at once in place of 8; the rows read with
``ld.global.cs`` or ``ld.global.nc`` in place of plain loads), checked
bit-equal to the shipped build and timed with ``chip_smoke.time_ms`` with
the host ahead of the card, in turns (the shipped build, then each
variant, then back).  Three inputs:
the batch as drawn, the same ids sorted ascending (the host pages read in
order), and the all-miss form over every row in order (the rate of a plain
stream of host rows).  The pinned ``copy_`` rate is printed beside.  Then
each build runs graphsage_cached's pipelined epoch in turns (the wrapper
given the build's library), where K11 shares the card with the training
step.  The last line is one JSON object.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
_GRID = "const long long limit = sms / 4 > 0 ? sms / 4 : 1;"
_LOAD = "s[u][col] : zero_word<Word>()"
# name: the substitutions that make the variant from csrc/tiered.cu
VARIANTS = {
    "grid_all": [(_GRID, "const long long limit = cap;")],
    "grid66": [(_GRID, "const long long limit = 66;")],
    "grid16": [(_GRID, "const long long limit = 16;")],
    "unroll16": [("constexpr int kUnroll = 8;",
                  "constexpr int kUnroll = 16;")],
    "ldcs": [(_LOAD, "__ldcs(s[u] + col) : zero_word<Word>()")],
    "ldg": [(_LOAD, "__ldg(s[u] + col) : zero_word<Word>()")],
}
DEFAULT_VARIANTS = ["grid_all", "grid66", "grid16", "unroll16"]


def build_variants(_build, names) -> dict:
    """``{name: library}`` of the variants, compiled in parallel."""
    out_dir = _build.BUILD_DIR / "time_tiered"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "tiered.cu").read_text()
    jobs = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"time_tiered: the {name} variant's text "
                                   f"is not in tiered.cu once: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"tiered_{name}.cu"
        src.write_text(text)
        lib = out_dir / f"libtiered_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(lib), str(src)]))
    libs = {}
    for name, (path, proc) in jobs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"time_tiered: the {name} variant did not "
                               "build")
        lib = ctypes.CDLL(str(path))
        fn = lib.xg_tiered_extract
        fn.argtypes = _build.SIGNATURES["tiered"]["xg_tiered_extract"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="*", default=DEFAULT_VARIANTS,
                    choices=sorted(VARIANTS))
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
    from xgnn_tpu_torch.ops.tiered import tiered_extract

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build()
    libs = build_variants(_build, args.variants)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth")
    cfg = RunConfig(**dict(cs.BENCH_CONFIG, cache_percentage=cs.CACHE_PCT,
                           cache_policy="pre_sample"))
    eng = Engine(ds, cfg).init()
    store = eng.feature_source
    ds.feat = None
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    batch = eng.sampler.sample(torch.from_numpy(seeds).to(dev), n,
                               generator(dev, 7))
    drawn, num = batch.input_nodes, batch.num_input
    live = int(num)
    ordered = drawn.clone()
    ordered[:live] = torch.sort(drawn[:live]).values
    every = torch.arange(cs.NUM_NODE, dtype=torch.int32, device=dev)
    inputs = {"drawn": (drawn, num, store.posmap),
              "sorted": (ordered, num, store.posmap),
              "all rows in order, all-miss": (every, cs.NUM_NODE, None)}
    pinned = torch.empty(cs.H2D_BYTES // 4, dtype=torch.float32).pin_memory()
    on_card = torch.empty(pinned.shape, dtype=torch.float32, device=dev)
    h2d_ms = cs.time_ms(torch, lambda: on_card.copy_(pinned,
                                                     non_blocking=True),
                        reps=5)
    h2d_rate = cs.H2D_BYTES / h2d_ms * 1e3
    print(f"pinned copy_ {h2d_rate / 1e9:.3f} GB/s", flush=True)
    results = []
    for what, (ids, nv, posmap) in inputs.items():
        cache = None if posmap is None else store.cache_feat
        ref, counts = tiered_extract(ids, nv, posmap, cache, store.host)
        misses = int(counts[1])
        numt = torch.full((), int(nv), dtype=torch.int32, device=dev)

        def variant(lib):
            out = torch.empty_like(ref)
            cnt = torch.empty(2, dtype=torch.int32, device=dev)

            def run():
                rc = lib.xg_tiered_extract(
                    ids.data_ptr(), ids.shape[0], numt.data_ptr(),
                    None if posmap is None else posmap.data_ptr(),
                    cs.NUM_NODE, None if cache is None else cache.data_ptr(),
                    store.host.dev_ptr, store.feat_dim, out.data_ptr(),
                    cnt.data_ptr(), dev.index, _build.stream_handle(dev))
                _build.check(rc, "tiered_extract variant")
                return out, cnt
            return run

        shipped = lambda: tiered_extract(ids, nv, posmap, cache, store.host)
        runs = {"shipped": shipped}
        runs.update({spec: variant(lib) for spec, lib in libs.items()})
        for spec, fn in runs.items():
            out, cnt = fn()
            torch.cuda.synchronize()
            if not (torch.equal(out, ref) and torch.equal(cnt, counts)):
                raise AssertionError(f"{what}: {spec} differs from the "
                                     "shipped build")
        order = list(runs) + list(runs)[::-1]
        times = {spec: [] for spec in runs}
        for spec in order:
            times[spec].append(cs.time_ms(torch, runs[spec], reps=5,
                                          host_ahead=True))
        row = {"input": what, "ids": ids.shape[0], "valid": int(nv),
               "misses": misses, "pcie_bytes": misses * store.feat_dim * 4,
               "device_ms": times,
               "pcie_GBps": {s: misses * store.feat_dim * 4 / min(t) / 1e6
                             for s, t in times.items()}}
        print(json.dumps(row), flush=True)
        results.append(row)
    # each build in graphsage_cached's pipelined epoch, where K11 runs on
    # the producer's stream beside the training step: the wrapper loads
    # the build's library in place of the shipped one, in turns
    epochs = {spec: [] for spec in ["shipped"] + list(libs)}
    shipped_lib = _build.load("tiered")
    eng.train_epoch(0)
    epoch = 1
    for spec in list(epochs) + list(epochs)[::-1]:
        _build._libs["tiered"] = shipped_lib if spec == "shipped" \
            else libs[spec]
        torch.cuda.synchronize()
        r = eng.train_epoch(epoch)
        torch.cuda.synchronize()
        epochs[spec].append(r["time"])
        epoch += 1
    _build._libs["tiered"] = shipped_lib
    print(json.dumps({"epoch_s": epochs}), flush=True)
    print(json.dumps({"card": card, "h2d_bytes_per_s": h2d_rate,
                      "inputs": results, "epoch_s": epochs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
