#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Card: the card's name and power limit, from nvidia-smi.
2. Build: every CUDA source of ``xgnn_tpu_torch/csrc`` with nvcc, in
   parallel, into ``build/xgnn_tpu_torch/``.
3. Main-path set-up: the products-scale synthetic graph on the card
   (2,449,029 nodes, 62M power-law draws symmetrised, 128 features, 47
   classes) and ``Engine.init()`` with ``bench.py``'s default config
   (GraphSAGE 3x256, khop3 fanout (15, 10, 5), batch 8000, direct extract,
   pipelined, capacities (8000, 133376, 1007360, 2449152)).
4. Kernels against their plain PyTorch versions at the shapes of one
   sampled batch: K1 (row gather) on the direct-extract dst ids, as drawn
   and with 30% of them EMPTY, exact; K4
   forward at the layer-0 and layer-1 shapes and K4 backward at the
   layer-1 shape, rtol 1e-5 / atol 1e-5.  TF32 is off throughout.
5. Small reference: on a small graph the kernels' forward logits and loss
   agree with the plain path on the CPU for the same blocks and weights.
6. Main path: one warm-up epoch, then one counted epoch (25 steps) with the
   launch counters set to 0 before it; every kernel must have launched its
   expected count per step, and every loss must be finite.  Then one
   unpipelined epoch gives per-stage device-inclusive times, and one
   profiled pipelined epoch gives the device's busy share and its time by
   kernel.

Prints the kernels' JSON line, then the card's line (nvidia-smi's name and
power limit), then the result line.
Exits non-zero with no result line when there is no CUDA device.
"""

import json
import math
import os
import subprocess
import sys
import time

NUM_NODE = 2_449_029
NUM_EDGE = 62_000_000  # power-law draws before symmetrising
FEAT_DIM = 128
NUM_CLASS = 47
BATCH = 8000
FANOUT = (15, 10, 5)
CAPS = (BATCH, 133376, 1007360, 2449152)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
RTOL = ATOL = 1e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.nn import functional as F

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine import Engine
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
        fanout_reduce,
        fanout_reduce_plain,
    )
    from xgnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from xgnn_tpu_torch.train import loss_fn

    # plain versions are compared in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card -----------------------------------------------------------
    card = card_line()
    print(f"card: {card}", flush=True)
    tag = f"[{card}]"

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"{tag} build: {time.perf_counter() - t0:.3f} s wall for "
          f"{sorted(built) or 'nothing (already built)'}", flush=True)

    # ---- 3. main-path set-up -----------------------------------------------
    t0 = time.perf_counter()
    ds = make_device_dataset(NUM_NODE, NUM_EDGE, FEAT_DIM, NUM_CLASS,
                             train_frac=0.08, seed=0, name="products_synth")
    torch.cuda.synchronize()
    print(f"{tag} graph: {ds.num_node} nodes, {ds.num_edge} edges, built in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    cfg = RunConfig(  # bench.py's default configuration
        batch_size=BATCH, fanout=FANOUT, num_layer=len(FANOUT),
        num_hidden=256, model="graphsage", sample_type="khop3",
        cache_percentage=0.0, pipeline=True, agg_impl="loop",
        feat_dtype="float32", compute_dtype="float32", device_loop=False,
        frontier_capacities=CAPS, calibration_batches=0, remat=False,
    )
    t0 = time.perf_counter()
    engine = Engine(ds, cfg).init()
    torch.cuda.synchronize()
    print(f"{tag} engine init: {time.perf_counter() - t0:.3f} s; "
          f"capacities {engine.sampler.capacities}", flush=True)

    # ---- 4. kernels against their plain versions ---------------------------
    seeds, n = next(Shuffler(ds.train_set, BATCH, seed=7).epoch_batches(0))
    batch = engine.sampler.sample(torch.from_numpy(seeds).to(dev), n,
                                  generator(dev, 7))
    b0, b1 = batch.blocks[0], batch.blocks[1]
    feat = engine.feature_source.feat
    gen = generator(dev, 11)
    h1 = torch.randn((b0.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    g1 = torch.randn((b1.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    kernels = []

    def record(name, source, replaces, shape, err, tol, fn, plain, library,
               nbytes, flops, per_step):
        ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
        lib_ms = None if library is None else time_ms(torch, library)
        b_ms, b_by = bound_ms(nbytes, flops)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "launches": None,
            "launches_per_step": per_step, "max_abs_err": err,
            "tolerance": tol, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        })
        print(f"{tag} {name} {shape}: max_abs_err {err:.3e} ({tol}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)

    def max_err(a, b):
        return (float((a.detach().double() - b.detach().double()).abs().max())
                if a.numel() else 0.0)

    def assert_close(name, a, b, exact):
        ok = torch.equal(a, b) if exact else torch.allclose(
            a, b, rtol=RTOL, atol=ATOL)
        if not ok:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {max_err(a, b)})")

    # K1 on the direct-extract layer's dst ids, and on the same ids with
    # 30% of them EMPTY (a frontier further below its capacity)
    width = feat.shape[1]
    sparse = b0.dst_ids.clone()
    sparse[torch.rand(sparse.shape, generator=gen, device=dev) < 0.3] = \
        torch.iinfo(torch.int32).max
    for ids in (b0.dst_ids, sparse):
        out, ref = gather_rows(feat, ids), gather_rows_plain(feat, ids)
        torch.cuda.synchronize()
        assert_close("gather_rows", out, ref, exact=True)
        n_valid = int(((ids >= 0) & (ids < feat.shape[0])).sum())
        safe = torch.where((ids >= 0) & (ids < feat.shape[0]), ids, 0)
        record("gather_rows", "xgnn_tpu_torch/csrc/gather.cu",
               "xgnn_tpu/ops/pallas_gather.py:85",
               f"{ids.shape[0]} ids ({n_valid} valid) x {tuple(feat.shape)} "
               "f32", max_err(out, ref), "exact",
               lambda: gather_rows(feat, ids),
               lambda: gather_rows_plain(feat, ids),
               lambda: torch.index_select(feat, 0, safe),
               nbytes=n_valid * width * 4 + ids.shape[0] * (width * 4 + 4),
               flops=0, per_step=2)
        del out, ref

    def fwd_case(name, h, blk, per_step):
        nb = blk.neigh
        with torch.no_grad():
            s, d = fanout_reduce(h, nb)
            s_ref, d_ref = fanout_reduce_plain(h, nb)
        torch.cuda.synchronize()
        assert_close(name + " sum", s, s_ref, exact=False)
        assert_close(name + " denom", d, d_ref, exact=False)
        valid = (nb >= 0) & (nb < h.shape[0])
        picks = int(valid.sum())
        clamped = torch.where(valid, nb, 0).long()
        msk = valid.float()
        f = h.shape[1]
        with torch.no_grad():
            record(name, "xgnn_tpu_torch/csrc/fanout.cu",
                   "xgnn_tpu/models/gnn.py:62",
                   f"{tuple(nb.shape)} picks ({picks} valid) over "
                   f"{tuple(h.shape)} f32",
                   max(max_err(s, s_ref), max_err(d, d_ref)),
                   f"rtol {RTOL}, atol {ATOL}",
                   lambda: fanout_reduce(h, nb),
                   lambda: fanout_reduce_plain(h, nb),
                   lambda: F.embedding_bag(clamped, h, mode="sum",
                                           per_sample_weights=msk),
                   nbytes=picks * f * 4 + nb.numel() * 4
                   + nb.shape[0] * (f + 1) * 4,
                   flops=picks * f, per_step=per_step)

    fwd_case("fanout_fwd", feat, b0, 3)
    fwd_case("fanout_fwd", h1, b1, 3)

    # K4 backward at the layer-1 shape
    nb = b1.neigh
    gh = fanout_backward(g1, nb, None, h1.shape[0])
    gh_ref = fanout_backward_plain(g1, nb, None, h1.shape[0])
    torch.cuda.synchronize()
    assert_close("fanout_bwd", gh, gh_ref, exact=False)
    valid = (nb >= 0) & (nb < h1.shape[0])
    picks = int(valid.sum())
    hl = h1.clone().requires_grad_(True)
    lib_out = F.embedding_bag(torch.where(valid, nb, 0).long(), hl,
                              mode="sum", per_sample_weights=valid.float())
    f = h1.shape[1]
    record("fanout_bwd", "xgnn_tpu_torch/csrc/fanout.cu",
           "xgnn_tpu/models/gnn.py:62",
           f"{tuple(nb.shape)} picks ({picks} valid) into "
           f"{tuple(h1.shape)} f32",
           max_err(gh, gh_ref), f"rtol {RTOL}, atol {ATOL}",
           lambda: fanout_backward(g1, nb, None, h1.shape[0]),
           lambda: fanout_backward_plain(g1, nb, None, h1.shape[0]),
           lambda: torch.autograd.grad(lib_out, hl, g1, retain_graph=True),
           nbytes=g1.numel() * 4 + nb.numel() * 4 + h1.numel() * 4,
           flops=picks * f, per_step=2)
    del gh, gh_ref, hl, lib_out, h1, g1, batch, b0, b1

    # ---- 5. small reference: kernels on the card vs plain on the CPU -------
    small = make_device_dataset(3000, 12000, 32, 6, seed=1, device=dev)
    scfg = RunConfig(batch_size=64, fanout=(5, 4, 3), num_hidden=16,
                     frontier_capacities=(64, 512, 2048, 3072))
    from xgnn_tpu_torch.sampler import Sampler

    sb = Sampler(small.graph, scfg, direct_extract=True).sample(
        torch.from_numpy(small.train_set[:64]).to(dev), 64, generator(dev, 3))
    model = build_model(scfg, 32, 6)
    cpu_model = build_model(scfg, 32, 6)
    model.to(dev)
    logits = model(sb.blocks, small.feat)
    to_cpu = lambda blk: type(blk)(**{
        k: (v.cpu() if isinstance(v, torch.Tensor) else v)
        for k, v in vars(blk).items()
    })
    ref_logits = cpu_model([to_cpu(b) for b in sb.blocks], small.feat.cpu())
    labels = small.label[sb.output_nodes]
    loss, _ = loss_fn(logits, labels, sb.num_output)
    ref_loss, _ = loss_fn(ref_logits, labels.cpu(), sb.num_output.cpu())
    if not (torch.allclose(logits.cpu(), ref_logits, rtol=1e-4, atol=1e-5)
            and torch.allclose(loss.cpu(), ref_loss, rtol=1e-5)):
        raise AssertionError("small reference: card logits disagree with "
                             "the CPU plain path")
    print(f"{tag} small reference: logits {tuple(logits.shape)} max abs "
          f"diff {max_err(logits.cpu(), ref_logits):.3e}, loss "
          f"{loss.item():.6f} vs {ref_loss.item():.6f}", flush=True)
    del small, sb, model, logits

    # ---- 6. main path ------------------------------------------------------
    steps = Shuffler(ds.train_set, BATCH).num_local_step
    expected = {"gather_rows": 2 * steps, "fanout_fwd": 3 * steps,
                "fanout_bwd": 2 * steps}
    results = []
    for epoch in (0, 1):
        _build.LAUNCHES.reset()
        r = engine.train_epoch(epoch)
        torch.cuda.synchronize()
        counts = _build.LAUNCHES.snapshot()
        results.append(r)
        print(f"{tag} epoch {epoch} ({'warm-up' if epoch == 0 else 'counted'}"
              f", pipelined): {r['time']:.3f} s, {steps} steps, loss "
              f"{r['loss']:.4f}, acc {r['train_acc']:.4f}, launches {counts}",
              flush=True)
        if counts != expected:
            raise AssertionError(f"launch counts {counts} != {expected}")
        losses = engine.history[epoch]["loss"]
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"epoch {epoch}: a step loss is not finite: "
                                 f"{list(losses)}")
    for k in kernels:
        k["launches"] = counts[k["name"]]
    stage = engine.history[1]["stages"]
    mean = lambda v: sum(v) / max(len(v), 1)
    print(f"{tag} epoch 1 host enqueue per step: sample "
          f"{mean(stage['sample']) * 1e3:.3f} ms, extract "
          f"{mean(stage['extract']) * 1e3:.3f} ms, train "
          f"{mean(stage['train']) * 1e3:.3f} ms", flush=True)

    engine.config.pipeline = False
    r2 = engine.train_epoch(2)
    stage = engine.history[2]["stages"]
    print(f"{tag} epoch 2 (unpipelined, synchronised per stage): "
          f"{r2['time']:.3f} s; per step sample "
          f"{mean(stage['sample']) * 1e3:.3f} ms, extract "
          f"{mean(stage['extract']) * 1e3:.3f} ms, train "
          f"{mean(stage['train']) * 1e3:.3f} ms; loss {r2['loss']:.4f}",
          flush=True)
    if not all(math.isfinite(v) for v in engine.history[2]["loss"]):
        raise AssertionError("epoch 2: a step loss is not finite")

    # device busy share over one more pipelined epoch, from the profiler's
    # device events (the union of their intervals over the epoch's wall time)
    engine.config.pipeline = True
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.train_epoch(3)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    if not all(math.isfinite(v) for v in engine.history[3]["loss"]):
        raise AssertionError("epoch 3: a step loss is not finite")
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, reach, by_name = 0.0, -math.inf, {}
    for start, end, name in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    if spans:
        print(f"{tag} epoch 3 (profiled, pipelined): {wall_us / 1e3:.1f} ms "
              f"wall, device busy {busy_us / 1e3:.1f} ms, busy share "
              f"{busy_us / wall_us:.3f}, {len(spans)} device events; device "
              "ms per step by kernel:", flush=True)
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
            print(f"{tag}   {us / 1e3 / steps:9.3f}  {name[:100]}", flush=True)
    else:
        print(f"{tag} device busy share: not measured (the profiler "
              "recorded no device events)", flush=True)

    # edges aggregated per second, counted from the block masks (bench.py)
    counts_e = []
    for i, (seeds, n) in enumerate(Shuffler(ds.train_set, BATCH, seed=43)
                                   .epoch_batches(1)):
        if i >= 5:
            break
        b = engine.sampler.sample(torch.from_numpy(seeds).to(dev), n,
                                  generator(dev, 900 + i))
        counts_e.append(sum(int(blk.mask.sum()) for blk in b.blocks))
    edges_per_step = sum(counts_e) / len(counts_e)
    print(f"{tag} edges aggregated per step {edges_per_step:.1f}; "
          f"edges/s over the counted epoch "
          f"{edges_per_step * steps / results[1]['time']:.1f}; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB",
          flush=True)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
