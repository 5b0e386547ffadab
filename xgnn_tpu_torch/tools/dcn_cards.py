#!/usr/bin/env python3
"""DCN groups and the multi-card placement solve over four cards.

    python3 xgnn_tpu_torch/tools/dcn_cards.py [--cpu] [--nodes N]

Four ranks, one process a card (``parallel.mesh.spawn``: NCCL, or gloo
with ``--cpu``), each building the same host graph
(``synthetic.make_synthetic_dataset``, ``--nodes`` nodes, 15 draws a
node, 128 features, 32 classes) and running ``MultiChipEngine`` over
every rank in several configurations:

- the fused store over the replicated topology in two DCN groups of two
  cards and on the flat mesh of four: a rank samples its own batch there,
  so the groups change only which ranks an exchange spans, and the
  per-step losses must be equal;
- the fused store over the partitioned topology at 2 x 2, in the host
  loop and under ``device_loop`` (on the cards a CUDA graph of the step,
  its collectives inside, over the groups' own NCCL communicators, which
  the eager warm-up makes): equal per-step losses;
- XGNN's two-phase GGMS at 2 x 2 (a partial cache partitioned over each
  group, the hot prefix with the host cold tier) and presample_static at
  2 x 2 against the flat mesh (the exact counts equal);
- ``auto_placement`` at 2 x 2 from each card's own memory: the same
  solved fields on every rank.

It prints a line for each configuration (epoch seconds, losses, hit
rate, valid accuracy) and one JSON object last; it exits non-zero when a
check fails or fewer than four cards are present.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]
WORLD = 4


def configs(cpu: bool) -> dict:
    """The configurations by name, each with its number of epochs (on the
    CPU the placement solve plans for a budget: the CPU has no memory
    size to read)."""
    base = dict(model="graphsage", sample_type="khop3", batch_size=1000,
                fanout=(10, 5), num_layer=2, num_hidden=128, lr=0.003,
                dropout=0.5, num_worker=WORLD, num_dcn_groups=2,
                part_cache=True, calibration_batches=2, seed=3)
    tier = dict(use_dist_graph=True, dist_graph_percentage=0.6)
    return {
        "fused_replicated": (dict(base), 3),
        "fused_replicated_flat": (dict(base, num_dcn_groups=1), 3),
        "fused_partitioned": (dict(base, use_dist_graph=True), 2),
        "fused_partitioned_device_loop": (dict(base, use_dist_graph=True,
                                               device_loop=True), 2),
        "ggms_tier": (dict(base, cache_percentage=0.25,
                           cache_policy="pre_sample", **tier), 3),
        "static": (dict(base, use_dist_graph=True, cache_percentage=0.2,
                        cache_policy="presample_static",
                        calibration_batches=0), 1),
        "static_flat": (dict(base, use_dist_graph=True, num_dcn_groups=1,
                             cache_percentage=0.2,
                             cache_policy="presample_static",
                             calibration_batches=0), 1),
        "auto_placement": (dict(base, auto_placement=True,
                                hbm_budget_gb=0.02 if cpu else None), 1),
    }


def rank_main(mesh, nodes: int, cases: dict) -> dict:
    import torch

    from xgnn_tpu_torch import RunConfig, synthetic
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    ds = synthetic.make_synthetic_dataset(num_node=nodes, avg_degree=15,
                                          feat_dim=128, num_class=32,
                                          seed=1, planted_signal=1.5)
    out = {}
    for name, (kw, epochs) in cases.items():
        t0 = time.perf_counter()
        eng = MultiChipEngine(ds, RunConfig(**kw), mesh=mesh).init()
        init_s = time.perf_counter() - t0
        try:
            rs = [eng.train_epoch(e) for e in range(epochs)]
            counts = (eng._presample_and_calibrate()
                      if kw.get("cache_policy") == "presample_static"
                      else None)
            cfg = eng.config
            params = torch.cat([p.detach().reshape(-1).float().cpu()
                                for p in eng.model.parameters()])
            out[name] = {
                "init_s": init_s, "epoch_s": [r["time"] for r in rs],
                "losses": [eng.history[e]["loss"] for e in range(epochs)],
                "hit_rate": [r["hit_rate"] for r in rs],
                "acc": eng.evaluate("valid", 4), "part": eng.part,
                "num_parts": eng.num_parts, "counts": counts,
                "captured": eng._fused is not None
                and eng._fused.graph is not None,
                "solved": [cfg.use_dist_graph, cfg.dist_graph_percentage,
                           cfg.cache_percentage],
                "params_sum": float(params.double().sum()),
            }
        finally:
            for held in (eng.host,
                         None if eng.tier is None else eng.tier.csr):
                if held is not None:
                    held.close()
    return out


def check(outs: list) -> list:
    """The failed checks, as text."""
    bad = []
    get = lambda name: [o[name] for o in outs]  # noqa: E731
    for name in outs[0]:
        rows = get(name)
        if not all(np.all(np.isfinite(np.concatenate(r["losses"])))
                   for r in rows):
            bad.append(f"{name}: a loss is not finite")
        if len({r["params_sum"] for r in rows}) != 1:
            bad.append(f"{name}: the ranks' parameters differ")
    for a, b in (("fused_replicated", "fused_replicated_flat"),
                 ("fused_partitioned", "fused_partitioned_device_loop")):
        for ra, rb in zip(get(a), get(b)):
            for la, lb in zip(ra["losses"], rb["losses"]):
                if not np.allclose(la, lb, rtol=1e-5, atol=0):
                    bad.append(f"{a} and {b}: losses differ: {la} / {lb}")
    for ra, rb in zip(get("static"), get("static_flat")):
        if not np.array_equal(ra["counts"], rb["counts"]):
            bad.append("static: the 2 x 2 counts differ from the flat "
                       "mesh's")
    if len({tuple(r["solved"]) for r in get("auto_placement")}) != 1:
        bad.append("auto_placement: the ranks solved different fields")
    hits = [r["hit_rate"][-1] for r in get("ggms_tier")]
    if not all(0.0 < h < 1.0 for h in hits):
        bad.append(f"ggms_tier: hit rate {hits} outside (0, 1)")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="four gloo ranks on the CPU")
    ap.add_argument("--nodes", type=int, default=200_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from xgnn_tpu_torch.parallel import mesh as pmesh

    device = "cpu" if args.cpu else None
    if not args.cpu:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < WORLD:
            print(f"dcn_cards: needs {WORLD} CUDA devices", file=sys.stderr)
            return 2
        import chip_smoke as cs

        print(cs.card_line(), flush=True)
    cases = configs(args.cpu)
    t0 = time.perf_counter()
    outs = pmesh.spawn(rank_main, WORLD, args.nodes, cases, device=device,
                       timeout=600, threads=2 if args.cpu else 4)
    wall = time.perf_counter() - t0
    for name in cases:
        r = outs[0][name]
        print(f"{name}: init {r['init_s']:.3f} s, epochs "
              f"{[round(t, 4) for t in r['epoch_s']]} s, mean losses "
              f"{[round(float(np.nanmean(l)), 6) for l in r['losses']]}, "
              f"hit rate {[round(h, 6) for h in r['hit_rate']]}, valid acc "
              f"(4 batches) {r['acc']:.4f}, solved {r['solved']}, captured "
              f"{r['captured']}", flush=True)
    bad = check(outs)
    for b in bad:
        print(f"FAILED {b}", flush=True)
    summary = {name: {k: v for k, v in outs[0][name].items()
                      if k not in ("counts", "losses")}
               for name in cases}
    print(json.dumps({"dcn_cards": summary, "wall_s": wall,
                      "ok": not bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
