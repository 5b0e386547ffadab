#!/usr/bin/env python3
"""Time K9, the restart random walk with top-K visit counts, at PinSAGE's
two layers.

    python3 xgnn_tpu_torch/tools/time_walk.py [--root DIR]

``DIR`` holds the ``xgnn_tpu_torch`` package to time (default: this
checkout), so that two versions of the kernel are timed on one card, each
in a process of its own.  The inputs are those of ``chip_smoke.py``: the
products-scale synthetic graph, the seeds of its first batch, bench.py's
walk (W=4, L=3, restart 0.5, 5 neighbours) with PinSAGE's capacities
calibrated from 2 batches; layer 0 walks from the seeds, layer 1 from the
dedup of layer 0's picks.  At each layer it checks the kernel against the
plain version and times it with ``chip_smoke.time_ms`` (``ms`` back to
back, the wrapper's host time included; ``device_ms`` with the host ahead
of the card) and by the profiler's device events (``kernel_us``).  The
last line is one JSON object.
"""

import argparse
import json
import os
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(CHECKOUT),
                    help="the directory holding the xgnn_tpu_torch to time")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    from xgnn_tpu_torch.tools.time_unique import kernel_us

    sys.path.insert(0, os.path.abspath(args.root))
    for name in [m for m in sys.modules if m.startswith("xgnn_tpu_torch")]:
        del sys.modules[name]  # the package under --root, not this one
    import torch

    if not torch.cuda.is_available():
        print("time_walk: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import xgnn_tpu_torch
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine import Engine
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import random_walk, unique

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    package = os.path.dirname(xgnn_tpu_torch.__file__)
    print(f"card: {card}; package {package}", flush=True)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    graph = ds.graph
    cfg = RunConfig(batch_size=cs.BATCH, model="pinsage",
                    sample_type="random_walk", num_neighbor=cs.NUM_NEIGHBOR,
                    num_random_walk=cs.WALK["num_random_walk"],
                    random_walk_length=cs.WALK["random_walk_length"],
                    random_walk_restart_prob=cs.WALK["restart_prob"],
                    calibration_batches=2)
    caps = Engine(ds, cfg).init().sampler.capacities
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    frontier = torch.from_numpy(seeds).to(dev)
    num = torch.full((), n, dtype=torch.int32, device=dev)
    gen = generator(dev, 11)
    empty = torch.iinfo(torch.int32).max
    w, l, k = (cfg.num_random_walk, cfg.random_walk_length, cfg.num_neighbor)
    rows = []
    for layer in range(cfg.num_layer_pinsage):
        u = random_walk.draw_uniforms(w, l, frontier.shape[0], gen, dev)

        def walk(f=frontier, u=u):
            return random_walk.sample_random_walk(
                graph.indptr, graph.indices, f, k, u=u, **cs.WALK)

        got = walk()
        ref = random_walk.sample_random_walk_plain(
            graph.indptr, graph.indices, frontier, k, u=u, **cs.WALK)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"layer {layer}: the walk differs from its "
                                 "plain version")
        row = {"layer": layer, "rows": frontier.shape[0],
               "valid": int((frontier != empty).sum()),
               "ms": cs.time_ms(torch, walk),
               "device_ms": cs.time_ms(torch, walk, host_ahead=True),
               "kernel_us": kernel_us(torch, walk)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if layer + 1 < cfg.num_layer_pinsage:
            frontier, num = unique.unique_seeded_split(
                frontier, got[0].reshape(-1), num, caps[layer + 1],
                num_node=graph.num_node)[:2]
            num = torch.clamp(num, max=caps[layer + 1])
    print(json.dumps({"card": card, "package": package, "capacities": caps,
                      "walks": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
