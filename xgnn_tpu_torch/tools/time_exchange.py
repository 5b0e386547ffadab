#!/usr/bin/env python3
"""Time the owner exchange's pieces at P = 1 on one card, and name what
runs on the card for each.

    python3 xgnn_tpu_torch/tools/time_exchange.py

It builds ``chip_smoke.py``'s products-sized graph (phase 3's), a
``MultiChipEngine`` at bench width in a world of one over NCCL
(``use_dist_graph``, the interleaved store), and samples the first batch
of its first epoch, as ``train_epoch`` does.  It then times the exchange
that step runs for its features: the batch's input frontier (its
capacity, its valid prefix and EMPTY after it) through
``partitioned_gather_indirect`` at the step's segment ``min(seg_cap, n)``.
For each piece (K13-plan; the ids' ``all_to_all_single``; K1's serve; the
rows' ``all_to_all_single``; the whole ``partitioned_gather_indirect``;
and, beside them, one ``Tensor.copy_`` of the rows) it prints the device
ms (``chip_smoke.time_ms`` with the host ahead of the card) and the device
microseconds per call of each kernel or copy the profiler records, with
the bytes the piece must move over 3.35 TB/s.  The last line is one JSON
object.
"""

import dataclasses
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main() -> int:
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("time_exchange: no CUDA device", file=sys.stderr)
        return 2
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator, seed_of
    from xgnn_tpu_torch.engine.engine import _SAMPLE
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch.ops.gather import gather_rows
    from xgnn_tpu_torch.parallel.collocated import sample_any
    from xgnn_tpu_torch.parallel.exchange import (
        local_rows_of,
        partitioned_gather_indirect,
        plan_exchange,
    )
    from xgnn_tpu_torch.tools.time_unique import kernel_us

    card = cs.card_line()
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    cfg = dataclasses.replace(RunConfig(**cs.BENCH_CONFIG), arch="arch6",
                              num_worker=1, use_dist_graph=True,
                              part_cache=True)
    meng = MultiChipEngine(ds, cfg).init()
    try:
        mesh, p, table = meng.mesh, meng.num_parts, meng.feat_part
        it = meng._shuffler(ds.train_set, cfg.seed + 1).epoch_batches(0)
        seeds, n = meng._next(it)
        gen = generator(meng.device, seed_of(cfg.seed, _SAMPLE, 0, 0,
                                             meng.rank))
        batch = sample_any(meng.topo, seeds, n, cfg, meng.capacities,
                           meng.seg_cap, mesh, True, gen)
        ids = batch.input_nodes
        num_ids, num_valid = ids.shape[0], int(batch.num_input)
        seg = max(min(meng.seg_cap, num_ids), 1)
        feat_dim, item = table.shape[1], table.element_size()
        plan = plan_exchange(ids, p, seg)
        req = mesh.all_to_all(plan.send.reshape(-1))
        rows = gather_rows(table, local_rows_of(req, p))
        slots = p * seg
        row_bytes = slots * feat_dim * item
        pieces = {
            "plan_exchange": (lambda: plan_exchange(ids, p, seg),
                              num_ids * 8 + slots * 4),
            "all_to_all ids": (lambda: mesh.all_to_all(plan.send.reshape(-1)),
                               slots * 8),
            "K1 serve": (lambda: gather_rows(table, local_rows_of(req, p)),
                         num_valid * feat_dim * item + row_bytes + slots * 4),
            "all_to_all rows": (lambda: mesh.all_to_all(rows), 2 * row_bytes),
            "partitioned_gather_indirect": (
                lambda: partitioned_gather_indirect(table, ids, mesh, seg),
                num_ids * 8 + num_valid * feat_dim * item + row_bytes),
            "copy_ of the rows": (lambda: torch.empty_like(rows).copy_(rows),
                                  2 * row_bytes),
        }
        out = {"card": card, "num_ids": num_ids, "num_valid": num_valid,
               "seg": seg, "capacities": meng.capacities, "pieces": {}}
        print(f"[{card}] the step's feature exchange: {num_ids} ids "
              f"({num_valid} valid) into ({p}, {seg}), rows of {feat_dim} x "
              f"{item} bytes; capacities {meng.capacities}", flush=True)
        for name, (fn, nbytes) in pieces.items():
            device_ms = cs.time_ms(torch, fn, host_ahead=True)
            us = kernel_us(torch, fn)
            bound = nbytes / cs.HBM_BYTES_PER_S * 1e3
            out["pieces"][name] = {"device_ms": device_ms, "bound_ms": bound,
                                   "kernel_us": us}
            print(f"[{card}] {name}: {device_ms:.4f} device ms (bound "
                  f"{bound:.4f}); by kernel (us a call): "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                      us.items(), key=lambda kv: -kv[1])), flush=True)
    finally:
        meng.close()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
