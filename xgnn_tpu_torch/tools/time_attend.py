#!/usr/bin/env python3
"""Time K5, GAT's edge-softmax aggregate, forward and backward, at the gat1
and gat8 shapes of the main path.

    python3 xgnn_tpu_torch/tools/time_attend.py [--root DIR]

``DIR`` holds the ``xgnn_tpu_torch`` package to time (default: this
checkout), so that two versions of the kernel are timed on one card, each
in a process of its own: unpack the other version (``git archive``) into a
gitignored directory such as ``build/`` and alternate the two roots
(parent, change, change, parent) to see each build's run-to-run spread.
The inputs are those of ``chip_smoke.py``: the products-scale synthetic
graph, the first batch sampled with bench.py's default configuration
(fanout 15, 10, 5; batch 8000), the feature table at layer 0, random
(1,007,360, 256) and (133,376, 47) tables at layers 1 and 2, and random
``el_dst``, projections and ``g_out`` from fixed generator seeds.  The
cases: layer 0 shared at 1 and 8 heads (backward without the table's
gradient), layer 1 shared at 1 and 8 heads (with it) and layer 2 per head
at 1 head.  Each forward is checked against the plain version; each case
prints ``device_ms`` (``chip_smoke.time_ms`` with the host ahead of the
card) and ``kernel_us`` (the profiler's device time per call of each
kernel launched, the backward's segmented sum included).  The last line is
one JSON object.
"""

import argparse
import inspect
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
        print("time_attend: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import xgnn_tpu_torch
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine import Engine
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops import attend as k5

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    package = os.path.dirname(xgnn_tpu_torch.__file__)
    print(f"card: {card}; package {package}", flush=True)
    _build.build()
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    cfg = RunConfig(batch_size=cs.BATCH, fanout=cs.FANOUT,
                    num_layer=len(cs.FANOUT), num_hidden=256,
                    model="graphsage", sample_type="khop3",
                    frontier_capacities=cs.CAPS, calibration_batches=0)
    engine = Engine(ds, cfg).init()
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    batch = engine.sampler.sample(torch.from_numpy(seeds).to(dev), n,
                                  generator(dev, 7))
    b0, b1, b2 = batch.blocks
    gen = generator(dev, 11)
    h1 = torch.randn((b0.dst_cap, 256), generator=gen, device=dev)
    h2t = torch.randn((b1.dst_cap, cs.NUM_CLASS), generator=gen, device=dev)
    feat = engine.feature_source.feat
    # the parent's backward also took the forward's out
    takes_out = "out" in inspect.signature(k5.attend_backward).parameters
    cases = [("gat1", 0, feat, b0, 1, k5.SHARED, False),
             ("gat8", 0, feat, b0, 8, k5.SHARED, False),
             ("gat1", 1, h1, b1, 1, k5.SHARED, True),
             ("gat8", 1, h1, b1, 8, k5.SHARED, True),
             ("gat1", 2, h2t, b2, 1, k5.PER_HEAD, True)]
    rows = []
    for i, (path, layer, table, blk, heads, mode, need) in enumerate(cases):
        nb = blk.neigh
        g = generator(dev, 100 + i)
        el = torch.randn((nb.shape[0], heads), generator=g, device=dev)
        pshape = ((table.shape[1], heads) if mode == k5.SHARED
                  else (heads, table.shape[1] // heads))
        proj = 0.1 * torch.randn(pshape, generator=g, device=dev)

        def fwd(table=table, nb=nb, el=el, proj=proj, mode=mode):
            return k5.attend_forward(table, nb, el, proj, mode)

        out, m, s = fwd()
        ref = k5.attend_forward_plain(table, nb, el, proj, mode)
        if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                   for a, b in zip((out, m, s), ref)):
            raise AssertionError(f"{path} layer {layer}: the forward differs "
                                 "from its plain version")
        del ref
        g_out = torch.randn(out.shape, generator=g, device=dev)
        saved = (out, m, s) if takes_out else (m, s)
        if not takes_out:
            del out

        def bwd(table=table, nb=nb, el=el, proj=proj, mode=mode, need=need,
                g_out=g_out, saved=saved):
            return k5.attend_backward(g_out, table, nb, el, proj, *saved,
                                      mode, need)

        row = {"path": path, "layer": layer, "heads": heads, "mode": mode,
               "picks": list(nb.shape), "table": list(table.shape),
               "g_table": need}
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            us = kernel_us(torch, fn)
            row[name] = {"device_ms": cs.time_ms(torch, fn, host_ahead=True),
                         "kernel_us": us,
                         "profiler_ms": sum(us.values()) / 1e3}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del saved, g_out
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "package": package, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
