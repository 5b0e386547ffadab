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
   sampled batch: K2 (khop sampler) at the three layers' frontiers and K3
   (seeded dedup, its split form) at the two dedup calls, walked layer by
   layer as the sampler walks them, exact, each dedup followed by two more
   with other picks (K3 keeps state across calls) and its kernel launches
   per call counted by the profiler; the whole batch sampled through K2
   and K3 equal, block by block, to the same batch sampled through their plain
   versions from the same generator seed; K1 (row gather) on the
   direct-extract dst ids, as drawn and with 30% of them EMPTY, and on the
   label column at the seeds, exact; K4 forward at the three layers'
   shapes and K4 backward (with the dst prefix's gradient) at the layer-1
   and layer-2 shapes, rtol 1e-5 / atol 1e-5, the backward also equal bit
   for bit across two launches, with its longest segment (the most picks
   of one src row) printed.  TF32 is off throughout.
5. Small reference: on a small graph the kernels' forward logits and loss
   agree with the plain path on the CPU for the same blocks and weights.
6. Main path: one warm-up epoch, then one counted epoch (25 steps) with the
   launch counters set to 0 before it; every kernel must have launched its
   expected count per step, and every loss must be finite.  Then one
   unpipelined epoch gives per-stage device-inclusive times, and one
   profiled pipelined epoch gives the device's busy share and its time by
   kernel.

Each kernel is timed twice: ``ms`` back to back (the wrapper's host time
included, where the host is the slower) and ``device_ms`` with the host
ahead of the card (the card's time alone).

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


def time_ms(torch, fn, reps: int = 10, host_ahead: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` launches, after one warm-up, by CUDA
    events.  Back to back, the events read the host's enqueue where the
    host is slower than the card.  With ``host_ahead`` the card first sleeps
    until the host has queued every launch, so they read the card's time
    alone; the sleep grows until the host was ahead."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cycles = 20_000_000  # about 10 ms at the H100's clock
    while True:
        if host_ahead:
            torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        # the card already past the start: the host was not ahead
        behind = host_ahead and start.query()
        torch.cuda.synchronize()
        if not behind:
            return start.elapsed_time(end) / reps
        if cycles > 2**34:
            raise RuntimeError("time_ms: the host never got ahead of the card")
        cycles *= 4


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
    from torch.autograd import DeviceType
    from torch.nn import functional as F
    from torch.profiler import ProfilerActivity, profile

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine import Engine
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.ops import _build, sampling, unique
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
        fanout_reduce,
        fanout_reduce_plain,
    )
    from xgnn_tpu_torch.ops.gather import gather_rows, gather_rows_plain
    from xgnn_tpu_torch.ops.sampling import sample_khop0, sample_khop0_plain
    from xgnn_tpu_torch.ops.unique import (
        unique_seeded_split,
        unique_seeded_split_plain,
    )
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
    seeds = torch.from_numpy(seeds).to(dev)
    batch = engine.sampler.sample(seeds, n, generator(dev, 7))
    b0, b1, b2 = batch.blocks
    feat = engine.feature_source.feat
    gen = generator(dev, 11)
    # the inputs of layers 1 and 2: (1,007,360, 256) and (133,376, 256)
    h1 = torch.randn((b0.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    h2 = torch.randn((b1.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    kernels = []

    def record(name, source, replaces, shape, err, tol, fn, plain, library,
               library_call, nbytes, flops, per_step):
        ms, plain_ms = time_ms(torch, fn), time_ms(torch, plain)
        device_ms = time_ms(torch, fn, host_ahead=True)
        lib_ms = None if library is None else time_ms(torch, library)
        b_ms, b_by = bound_ms(nbytes, flops)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "launches": None,
            "launches_per_step": per_step, "max_abs_err": err,
            "tolerance": tol, "ms": ms, "kernel_ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_call": library_call,
        })
        print(f"{tag} {name} {shape}: max_abs_err {err:.3e} ({tol}); "
              f"kernel {ms:.4f} ms ({device_ms:.4f} ms on the card alone), "
              f"plain {plain_ms:.4f} ms, library "
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

    # K2 at each layer's frontier and K3 at each dedup, one batch walked
    # layer by layer as sampler._sample_minibatch walks it
    empty = torch.iinfo(torch.int32).max
    graph = engine.sampler.graph
    frontier = seeds
    num = torch.full((), n, dtype=torch.int32, device=dev)
    for layer, k in enumerate(FANOUT):
        u = torch.rand((frontier.shape[0], k), generator=gen, device=dev)
        nbr = sample_khop0(graph.indptr, graph.indices, frontier, k, u=u)
        ref = sample_khop0_plain(graph.indptr, graph.indices, frontier, k,
                                 u=u)
        torch.cuda.synchronize()
        assert_close("sample_khop", nbr, ref, exact=True)
        rows = int((frontier != empty).sum())
        picks = int((nbr != empty).sum())
        record("sample_khop", "xgnn_tpu_torch/csrc/sampling.cu",
               "xgnn_tpu/ops/sampling.py:144",
               f"layer {layer}: frontier {frontier.shape[0]} ({rows} valid) "
               f"x K={k}, {picks} picks", max_err(nbr, ref), "exact",
               lambda: sample_khop0(graph.indptr, graph.indices, frontier, k,
                                    u=u),
               lambda: sample_khop0_plain(graph.indptr, graph.indices,
                                          frontier, k, u=u),
               None, None,
               # frontier, two indptr entries per valid row, u, one index
               # per pick, the output
               nbytes=frontier.numel() * 4 + rows * 8 + u.numel() * 4
               + picks * 4 + nbr.numel() * 4,
               flops=0, per_step=3)
        if layer == len(FANOUT) - 1:
            break
        cap = CAPS[layer + 1]
        picks = nbr.reshape(-1)

        def dedup(p):
            return unique_seeded_split(frontier, p, num, cap,
                                       num_node=graph.num_node)

        def dedup_plain(p):
            return unique_seeded_split_plain(frontier, p, num, cap)

        out, ref = dedup(picks), dedup_plain(picks)
        torch.cuda.synchronize()
        err = max(max_err(o, r) for o, r in zip(out, ref))
        for o, r in zip(out, ref):
            assert_close("unique_seeded", o, r, exact=True)
        # K3's table and bitmaps persist across calls: two more with other
        # picks of the same frontier
        for _ in range(2):
            other = sample_khop0(graph.indptr, graph.indices, frontier, k,
                                 generator=gen).reshape(-1)
            for o, r in zip(dedup(other), dedup_plain(other)):
                assert_close("unique_seeded (a later call)", o, r,
                             exact=True)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            dedup(picks)
            torch.cuda.synchronize()
        per_call = sum(1 for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        state_bytes = unique.state(dev, graph.num_node).buf.numel() * 8
        print(f"{tag} unique_seeded layer {layer}: equal to the plain version "
              f"on three calls; {per_call} kernel launches per call "
              f"(profiler); state {state_bytes} bytes per stream", flush=True)
        ids = torch.cat([frontier, picks])  # the library call's input
        record("unique_seeded", "xgnn_tpu_torch/csrc/unique.cu",
               "xgnn_tpu/ops/unique.py:178",
               f"layer {layer}: {ids.shape[0]} ids (prefix "
               f"{frontier.shape[0]}), out_cap {cap}, {int(out[1])} unique",
               err, "exact",
               lambda: dedup(picks), lambda: dedup_plain(picks),
               lambda: torch.unique(ids, sorted=True, return_inverse=True),
               "torch.unique(sorted=True, return_inverse=True) on the "
               "concatenated ids; its id order differs (no seeded prefix)",
               # prefix and picks in, the picks' local ids and the unique
               # ids out (the state's own traffic is the design's cost, not
               # the function's)
               nbytes=ids.numel() * 4 + picks.numel() * 4 + cap * 4 + 8,
               flops=0, per_step=2)
        kernels[-1]["launches_per_call"] = per_call
        kernels[-1]["state_bytes"] = state_bytes
        frontier, num = out[0], torch.clamp(out[1], max=cap)
    del u, nbr, ref, ids, out, frontier, picks, other

    # the whole batch through the plain versions, from the same seed
    kernels_fns = sampling.sample_khop0, unique.unique_seeded_split
    sampling.sample_khop0 = sample_khop0_plain
    unique.unique_seeded_split = (
        lambda prefix, picks, num_prev, out_cap, num_node=None:
        unique_seeded_split_plain(prefix, picks, num_prev, out_cap))
    try:
        plain_batch = engine.sampler.sample(seeds, n, generator(dev, 7))
    finally:
        sampling.sample_khop0, unique.unique_seeded_split = kernels_fns
    pairs = [(f"block {i} {f}", getattr(kb, f), getattr(pb, f))
             for i, (kb, pb) in enumerate(zip(batch.blocks,
                                              plain_batch.blocks))
             for f in ("neigh", "num_dst", "num_src", "dst_ids")]
    pairs += [(f, getattr(batch, f), getattr(plain_batch, f))
              for f in ("input_nodes", "num_input", "overflow")]
    for what, a, b in pairs:
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            raise AssertionError(f"sampled batch: {what} through the kernels "
                                 "differs from the plain path")
    print(f"{tag} sampled batch: {len(pairs)} fields of "
          f"{len(batch.blocks)} blocks through K2/K3 equal the plain path's",
          flush=True)
    del plain_batch

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
               "torch.index_select on the ids clamped into the table",
               nbytes=n_valid * width * 4 + ids.shape[0] * (width * 4 + 4),
               flops=0, per_step=2)
        del out, ref

    # K1 on the label column at the seeds (LabelSource.extract)
    lab = engine.label_source.label[:, None]
    out, ref = gather_rows(lab, seeds), gather_rows_plain(lab, seeds)
    torch.cuda.synchronize()
    assert_close("gather_rows", out, ref, exact=True)
    n_valid = int(((seeds >= 0) & (seeds < lab.shape[0])).sum())
    safe = torch.where((seeds >= 0) & (seeds < lab.shape[0]), seeds, 0)
    record("gather_rows", "xgnn_tpu_torch/csrc/gather.cu",
           "xgnn_tpu/ops/pallas_gather.py:85",
           f"labels: {seeds.shape[0]} ids ({n_valid} valid) x "
           f"{tuple(lab.shape)} int32", max_err(out, ref), "exact",
           lambda: gather_rows(lab, seeds),
           lambda: gather_rows_plain(lab, seeds),
           lambda: torch.index_select(lab, 0, safe),
           "torch.index_select on the ids clamped into the table",
           nbytes=n_valid * 4 + seeds.shape[0] * 8, flops=0, per_step=2)
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
                   "F.embedding_bag(mode='sum', per_sample_weights=mask)",
                   nbytes=picks * f * 4 + nb.numel() * 4
                   + nb.shape[0] * (f + 1) * 4,
                   flops=picks * f, per_step=per_step)

    fwd_case("fanout_fwd", feat, b0, 3)
    fwd_case("fanout_fwd", h1, b1, 3)
    fwd_case("fanout_fwd", h2, b2, 3)

    def bwd_case(h, blk):
        """K4 backward of a local-id block: the gradient w.r.t. h of the
        dst prefix h[:D] and the fanout sum, given both their gradients."""
        nb = blk.neigh
        d, (rows, f) = nb.shape[0], h.shape
        g_sum = torch.randn((d, f), generator=gen, device=dev)
        g_dst = torch.randn((d, f), generator=gen, device=dev)
        gh = fanout_backward(g_sum, nb, None, rows, g_dst)
        again = fanout_backward(g_sum, nb, None, rows, g_dst)
        ref = fanout_backward_plain(g_sum, nb, None, rows, g_dst)
        torch.cuda.synchronize()
        assert_close("fanout_bwd", gh, ref, exact=False)
        if not torch.equal(gh, again):
            raise AssertionError("fanout_bwd: two launches on the same "
                                 "inputs differ")
        valid = (nb >= 0) & (nb < rows)
        picks = int(valid.sum())
        longest = int(torch.bincount(nb[valid].long(), minlength=rows).max())
        print(f"{tag} fanout_bwd {tuple(nb.shape)} into ({rows}, {f}): "
              f"longest segment {longest} picks of one src row; two launches "
              "equal bit for bit", flush=True)
        hl = h.clone().requires_grad_(True)
        lib_sum = F.embedding_bag(torch.where(valid, nb, 0).long(), hl,
                                  mode="sum", per_sample_weights=valid.float())
        record("fanout_bwd", "xgnn_tpu_torch/csrc/fanout.cu",
               "xgnn_tpu/models/gnn.py:62",
               f"{tuple(nb.shape)} picks ({picks} valid) into ({rows}, {f}) "
               f"f32 with the prefix gradient; longest segment {longest}",
               max_err(gh, ref),
               f"rtol {RTOL}, atol {ATOL}; bit-equal across launches",
               lambda: fanout_backward(g_sum, nb, None, rows, g_dst),
               lambda: fanout_backward_plain(g_sum, nb, None, rows, g_dst),
               lambda: torch.autograd.grad((hl[:d], lib_sum), hl,
                                           (g_dst, g_sum), retain_graph=True),
               "torch.autograd.grad of (h[:D], F.embedding_bag(mode='sum', "
               "per_sample_weights=mask)) w.r.t. h",
               # grad_sum, grad_dst and neigh in, every grad_h row out
               nbytes=2 * d * f * 4 + nb.numel() * 4 + rows * f * 4,
               flops=picks * f + d * f, per_step=2)
        kernels[-1]["longest_segment"] = longest

    bwd_case(h1, b1)
    bwd_case(h2, b2)
    del h1, h2, batch, b0, b1, b2

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
                "fanout_bwd": 2 * steps, "sample_khop": 3 * steps,
                "unique_seeded": 2 * steps}
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
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:16]:
            print(f"{tag}   {us / 1e3 / steps:9.3f}  {name[:120]}", flush=True)
        for what, key in (("fill", "fill"), ("add", "add"),
                          ("K4 backward", "bwd_")):
            us = sum(t for name, t in by_name.items() if key in name.lower())
            print(f"{tag}   device ms per step in kernels named *{key}* "
                  f"({what}): {us / 1e3 / steps:.3f}", flush=True)
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
