#!/usr/bin/env python3
"""Time K3, the seeded dedup, at the main path's two dedup calls.

    python3 xgnn_tpu_torch/tools/time_unique.py [--root DIR]

``DIR`` holds the ``xgnn_tpu_torch`` package to time (default: this
checkout), so that two versions of the kernel are timed on one card, each
in a process of its own.  The inputs are those of ``chip_smoke.py``: the
products-scale synthetic graph, the seeds of its first batch, K2's picks at
layers 0 and 1 drawn from generator seed 11, each layer's frontier the
dedup of the one before.  For each dedup it checks the kernel against the
plain version and times, with ``chip_smoke.time_ms``, ``unique_seeded`` on
the concatenated ids (every version has it) and, where the package has it,
``unique_seeded_split`` on the two parts: ``ms`` back to back, the
wrapper's host time included, and ``device_ms`` with the host ahead of the
card.  The last line is one JSON object.
"""

import argparse
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def kernel_us(torch, fn, reps: int = 10) -> dict:
    """Mean device microseconds per call of each kernel ``fn`` launches,
    from the profiler's device events over ``reps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            us[name] = us.get(name, 0.0) + (e.time_range.end
                                            - e.time_range.start) / reps
    return us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(CHECKOUT),
                    help="the directory holding the xgnn_tpu_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs

    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_unique: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import xgnn_tpu_torch
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import unique
    from xgnn_tpu_torch.ops.sampling import sample_khop0

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    package = os.path.dirname(xgnn_tpu_torch.__file__)
    print(f"card: {card}; package {package}", flush=True)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    graph = ds.graph
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    frontier = torch.from_numpy(seeds).to(dev)
    num = torch.full((), n, dtype=torch.int32, device=dev)
    gen = generator(dev, 11)
    rows = []
    for layer, k in enumerate(cs.FANOUT[:-1]):
        picks = sample_khop0(graph.indptr, graph.indices, frontier, k,
                             generator=gen).reshape(-1)
        ids = torch.cat([frontier, picks])
        prev_cap, cap = frontier.shape[0], cs.CAPS[layer + 1]

        def full():
            return unique.unique_seeded(ids, num, prev_cap, cap,
                                        num_node=graph.num_node)

        out = full()
        ref = unique.unique_seeded_plain(ids, num, prev_cap, cap)
        if not all(torch.equal(o, r) for o, r in zip(out, ref)):
            raise AssertionError(f"layer {layer}: unique_seeded differs from "
                                 "its plain version")
        row = {"layer": layer, "ids": ids.shape[0], "prefix": prev_cap,
               "out_cap": cap, "unique": int(out[1]),
               "ms": cs.time_ms(torch, full),
               "device_ms": cs.time_ms(torch, full, host_ahead=True)}
        if hasattr(unique, "unique_seeded_split"):
            def split():
                return unique.unique_seeded_split(frontier, picks, num, cap,
                                                  num_node=graph.num_node)

            got = split()
            if not (torch.equal(got[0], out[0]) and torch.equal(got[1], out[1])
                    and torch.equal(got[2], out[2][prev_cap:])):
                raise AssertionError(f"layer {layer}: unique_seeded_split "
                                     "differs from unique_seeded")
            row["split_ms"] = cs.time_ms(torch, split)
            row["split_device_ms"] = cs.time_ms(torch, split, host_ahead=True)
        row["kernel_us"] = kernel_us(torch, full)
        print(json.dumps(row), flush=True)
        rows.append(row)
        frontier, num = out[0], torch.clamp(out[1], max=cap)
    print(json.dumps({"card": card, "package": package, "dedups": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
