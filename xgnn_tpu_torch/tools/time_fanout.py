#!/usr/bin/env python3
"""Time K4 against its parent version and the variants it was chosen over.

    python3 xgnn_tpu_torch/tools/time_fanout.py [--parent DIR]

``csrc/fanout.cu`` as the package builds it ("new") is timed beside other
builds, each into a library of its own under ``build/``:

- "parent": ``DIR/xgnn_tpu_torch/csrc/fanout.cu``, bound with the C
  interface that ``DIR``'s ``ops/_build.py`` declares.  ``DIR`` holds the
  version before the mean form (its forward the first design, one
  dependent load a pick, the sum form only; its backward without
  ``denom``): unpack it into a gitignored directory, as in
  ``git archive <commit> | tar -x -C build/parent``.
- Variants of this checkout's source, each made here by text
  substitution: "hint" (table rows read with an L2 evict-last policy) and
  "no_l1" (read without allocating in L1); and of the backward's rows
  kernel, "uncapped" (no 32-register cap from 32,768 dst rows on),
  "capped" (the cap below 32,768 dst rows too), "task4", "task8" and
  "task_row" (4 or 8 picks a task from 32,768 dst rows on, or a whole
  row's, in place of 5) and "branch_free" (a zero gradient element
  divided as 1 and selected, in place of a branch round the division).

The inputs are those of ``chip_smoke.py``'s phase 4: the products-scale
synthetic dataset (seed 0), the first batch of ``Shuffler`` seed 7 sampled
with generator seed 7, graphsage's three layer shapes (the 128-wide
feature table, then 256-wide hidden tables drawn from generator seed 11)
and GCN's layer 2 over a 47-wide table with K7's weights.

- Forward, at each shape: the mean form timed as parent's sum followed by
  ``s / torch.clamp(denom, min=1e-9)`` (two launches) against every other
  build's one launch, and the sum form likewise; every result first
  checked equal to the plain version bit for bit.
- Backward, at graphsage's layers 1 and 2 (the mean form's gradient with
  the dst prefix's): every build's mean form; parent's sum form after the
  division (its composition, two launches) and alone (the kernel the
  mean form's gradient replaced); new's sum form; on dense normal
  gradients and on gradients half zeros, as a step's are after ReLU.  Each
  build is checked equal to new's bit for bit.
- Host, at GCN's 47-wide shape: microseconds a call of the wrappers under
  ``torch.no_grad``, of ``F.embedding_bag`` and of the outputs' allocation
  (two ``torch.empty`` against one with two views), 200 calls queued
  without a wait; 7 turns, each function once a turn, the order reversed
  every other turn; the median is printed beside every turn's.

Device times are ``chip_smoke.time_ms`` with the host ahead of the card
(the card's time alone), in turns: parent, new, the others, then the same
backwards.  The last line is one JSON object.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
_LD4 = ("__device__ __forceinline__ float4 ld_table(const float4* p) "
        "{ return __ldg(p); }")
_LD1 = ("__device__ __forceinline__ float ld_table(const float* p) "
        "{ return __ldg(p); }")
_HINT = "createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
# name: the substitutions that make the variant from csrc/fanout.cu
VARIANTS = {
    "hint": [
        (_LD4, """__device__ __forceinline__ float4 ld_table(const float4* p) {
  uint64_t pol;
  asm("%s" : "=l"(pol));
  float4 v;
  asm volatile("ld.global.nc.L2::cache_hint.v4.f32 {%%0, %%1, %%2, %%3}, [%%4], %%5;"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p), "l"(pol));
  return v;
}""" % _HINT),
        (_LD1, """__device__ __forceinline__ float ld_table(const float* p) {
  uint64_t pol;
  asm("%s" : "=l"(pol));
  float v;
  asm volatile("ld.global.nc.L2::cache_hint.f32 %%0, [%%1], %%2;"
               : "=f"(v) : "l"(p), "l"(pol));
  return v;
}""" % _HINT)],
    "no_l1": [
        (_LD4, """__device__ __forceinline__ float4 ld_table(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}"""),
        (_LD1, """__device__ __forceinline__ float ld_table(const float* p) {
  float v;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}""")],
    "uncapped": [("constexpr int kRowsBlocks = 8;",
                  "constexpr int kRowsBlocks = 1;")],
    "capped": [("bwd_rows_kernel<V, kDiv, 1, kRank1>",
                "bwd_rows_kernel<V, kDiv, kRowsBlocks, kRank1>")],
    "task4": [("constexpr int kPicksPerWarpLarge = 5;",
               "constexpr int kPicksPerWarpLarge = 4;")],
    "task8": [("constexpr int kPicksPerWarpLarge = 5;",
               "constexpr int kPicksPerWarpLarge = 8;")],
    "task_row": [("constexpr int kPicksPerWarpLarge = 5;",
                  "constexpr int kPicksPerWarpLarge = 32;")],
    "branch_free": [("  return x == 0.f && q > 0.f ? x : __fdiv_rn(x, q);",
                     "  const float y = __fdiv_rn(x == 0.f ? 1.f : x, q);\n"
                     "  return x == 0.f && q > 0.f ? x : y;")],
}


class Build:
    """A library of K4, whether its C interface has the mean form (a
    ``mean`` flag in the forward, ``denom`` in the backward) and whether
    its backward takes the rank-1 term and the prefix's length (``c``,
    ``u`` and ``num_prefix``)."""

    def __init__(self, lib, mean: bool, rank1: bool = False):
        self.lib, self.mean, self.rank1 = lib, mean, rank1

    def forward(self, h, nb, w, out, den, mean, stream):
        args = [h.data_ptr(), nb.data_ptr(), None if w is None else
                w.data_ptr(), out.data_ptr(), den.data_ptr(), h.shape[0],
                nb.shape[0], nb.shape[1], h.shape[1]]
        if self.mean:
            args.append(int(mean))
        elif mean:
            raise ValueError("this build has no mean form")
        return self.lib.xg_fanout_fwd(*args, stream)

    def backward(self, g, nb, g_dst, den, out, scratch, rows, stream):
        args = [g.data_ptr(), nb.data_ptr(), None, g_dst.data_ptr()]
        if self.mean:
            args.append(None if den is None else den.data_ptr())
        elif den is not None:
            raise ValueError("this build has no mean form")
        if self.rank1:
            args += [None, None]
        tail = [nb.shape[0]] if self.rank1 else []
        return self.lib.xg_fanout_bwd(
            *args, out.data_ptr(), scratch.data_ptr(), scratch.numel(), rows,
            nb.shape[0], nb.shape[1], g.shape[1], *tail, stream)


def _bind(path: Path, signatures: dict):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all(_build, parent) -> dict:
    """``{name: Build}`` of the variants and, given ``parent``, the parent
    source, compiled in parallel; a build that fails is reported and left
    out."""
    out_dir = _build.BUILD_DIR / "time_fanout"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "fanout.cu").read_text()
    jobs = {}  # name: (source path, signatures, has the mean form)
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"time_fanout: the {name} variant's "
                                   f"text is not in fanout.cu once: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"fanout_{name}.cu"
        src.write_text(text)
        jobs[name] = (src, _build.SIGNATURES["fanout"], True)
    if parent is not None:
        root = Path(parent).resolve() / "xgnn_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "parent_build", root / "ops" / "_build.py")
        parent_build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent_build)
        sigs = parent_build.SIGNATURES["fanout"]
        jobs["parent"] = (root / "csrc" / "fanout.cu", sigs,
                          len(sigs["xg_fanout_fwd"])
                          == len(_build.SIGNATURES["fanout"]["xg_fanout_fwd"]))
    procs = {}
    for name, (src, sigs, mean) in jobs.items():
        lib = out_dir / f"libfanout_{name}.so"
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib, sigs, mean)
    builds = {}
    for name, (p, lib, sigs, mean) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            print(f"time_fanout: the {name} build failed (nvcc exit "
                  f"{p.returncode}):\n{log[-2000:]}", flush=True)
            continue
        builds[name] = Build(_bind(lib, sigs), mean,
                             len(sigs["xg_fanout_bwd"]) > 13)
    return builds


def in_turns(cs, torch, fns: dict) -> dict:
    """Device ms of each function, parent's first and new's second, then
    the same order backwards."""
    order = sorted(fns, key=lambda x: (not x.startswith("parent"),
                                       not x.startswith("new")))
    times = {x: [] for x in order}
    for name in order + order[::-1]:
        times[name].append(cs.time_ms(torch, fns[name], host_ahead=True))
    return times


HOST_TURNS = 7


def host_us(torch, fn, reps: int = 200) -> float:
    """Host microseconds a call, ``reps`` calls queued without a wait."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the version before the mean form")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    import torch
    from torch.nn import functional as F

    if not torch.cuda.is_available():
        print("time_fanout: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.degree import pick_multiplicity
    from xgnn_tpu_torch.ops.fanout import (
        MEAN_EPS,
        _scratch_len,
        fanout_reduce,
        fanout_reduce_plain,
        masked_mean,
        masked_mean_plain,
    )
    from xgnn_tpu_torch.sampler import Sampler

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build(["fanout", "sampling", "unique"])
    builds = {"new": Build(_build.load("fanout"), True, True),
              **build_all(_build, args.parent)}
    print(f"builds: {time.perf_counter() - t0:.3f} s, {sorted(builds)}",
          flush=True)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth")
    cfg = RunConfig(**cs.BENCH_CONFIG)
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    batch = Sampler(ds.graph, cfg, direct_extract=True).sample(
        torch.from_numpy(seeds).to(dev), n, generator(dev, 7))
    b0, b1, b2 = batch.blocks
    gen = generator(dev, 11)
    h1 = torch.randn((b0.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    h2 = torch.randn((b1.dst_cap, cfg.num_hidden), generator=gen, device=dev)
    h2t = torch.randn((b1.dst_cap, cs.NUM_CLASS), generator=gen, device=dev)
    cnt = pick_multiplicity(b2.neigh, h2t.shape[0])
    gcn_w = torch.rsqrt(torch.clamp(cnt.to(torch.float32), min=1.0))
    stream = _build.stream_handle(dev)
    result = {"card": card, "forward": [], "backward": [], "host_us": {}}

    for label, h, nb, w in (
            ("graphsage layer 0", ds.feat, b0.neigh, None),
            ("graphsage layer 1", h1, b1.neigh, None),
            ("graphsage layer 2", h2, b2.neigh, None),
            ("gcn layer 2 (47 wide, K7 weights)", h2t, b2.neigh, gcn_w)):
        d = nb.shape[0]
        out = torch.empty((d, h.shape[1]), device=dev)
        den = torch.empty((d, 1), device=dev)

        def launch(b, mean):
            _build.check(b.forward(h, nb, w, out, den, mean, stream),
                         "fanout_fwd")
            return out

        def sum_then_divide(b):
            return launch(b, False) / torch.clamp(den, min=MEAN_EPS)

        refs = {"mean": masked_mean_plain(h, nb, w)[0],
                "sum": fanout_reduce_plain(h, nb, w)[0]}
        forms = {"mean": {}, "sum": {}}
        for name, b in builds.items():
            forms["sum"][name] = (lambda b=b: launch(b, False))
            # a build without the mean form: its sum, then a division
            forms["mean"][name] = (
                (lambda b=b: launch(b, True)) if b.mean
                else (lambda b=b: sum_then_divide(b)))
        row = {"shape": f"{label}: {tuple(nb.shape)} picks over "
                        f"{tuple(h.shape)}",
               "valid_picks": int(((nb >= 0) & (nb < h.shape[0])).sum())}
        for form, fns in forms.items():
            for name, fn in fns.items():
                if not torch.equal(fn(), refs[form]):
                    raise AssertionError(f"{label}, {form} form: the {name} "
                                         "build differs from the plain "
                                         "version")
            row[form + "_device_ms"] = in_turns(cs, torch, fns)
        print(json.dumps(row), flush=True)
        result["forward"].append(row)

    for label, h, blk in (("graphsage layer 1", h1, b1),
                          ("graphsage layer 2", h2, b2)):
        nb = blk.neigh
        d = nb.shape[0]
        rows_n, f = h.shape
        with torch.no_grad():
            den = masked_mean(h, nb)[1]
        q = torch.clamp(den, min=MEAN_EPS)  # saved by the parent's forward
        g_dst = torch.randn((d, f), generator=gen, device=dev)
        out = torch.empty((rows_n, f), device=dev)
        scratch = torch.empty((_scratch_len(rows_n, nb.numel()),),
                              dtype=torch.int32, device=dev)
        dense = torch.randn((d, f), generator=gen, device=dev)
        zeros = torch.rand((d, f), generator=gen, device=dev) < 0.5
        for grads, g in (("dense", dense),
                         ("half zeros", torch.where(zeros, 0.0, dense))):

            def backward(b, grad, divide):
                _build.check(b.backward(grad, nb, g_dst,
                                        den if divide else None, out,
                                        scratch, rows_n, stream),
                             "fanout_bwd")
                return out

            ref = backward(builds["new"], g, True).clone()
            fns = {"new sum form": lambda: backward(builds["new"], g, False)}
            for name, b in builds.items():
                if b.mean:
                    fns[name] = (lambda b=b: backward(b, g, True))
                else:  # autograd's division, then the sum form's gradient
                    fns[name] = (lambda b=b: backward(b, g / q, False))
                    fns[name + " sum form"] = (
                        lambda b=b: backward(b, g, False))
                if not torch.equal(fns[name](), ref):
                    raise AssertionError(f"{label} backward: the {name} "
                                         "build differs from new's")
            row = {"shape": f"{label}: {tuple(nb.shape)} picks into "
                            f"{(rows_n, f)}, {grads}",
                   "device_ms": in_turns(cs, torch, fns)}
            print(json.dumps(row), flush=True)
            result["backward"].append(row)

    nb = b2.neigh
    d, f = nb.shape[0], h2t.shape[1]
    valid = (nb >= 0) & (nb < h2t.shape[0])
    idx, msk = torch.where(valid, nb, 0).long(), valid.float() * gcn_w

    def one_allocation():
        buf = torch.empty(d * (f + 1), dtype=torch.float32, device=dev)
        return buf[: d * f].view(d, f), buf[d * f:].view(d, 1)

    fns = {
        "fanout_reduce": lambda: fanout_reduce(h2t, nb, gcn_w),
        "masked_mean": lambda: masked_mean(h2t, nb, gcn_w),
        "F.embedding_bag": lambda: F.embedding_bag(
            idx, h2t, mode="sum", per_sample_weights=msk),
        "two torch.empty": lambda: (
            torch.empty((d, f), dtype=torch.float32, device=dev),
            torch.empty((d, 1), dtype=torch.float32, device=dev)),
        "one torch.empty, two views": one_allocation,
    }
    samples = {name: [] for name in fns}
    with torch.no_grad():
        for turn in range(HOST_TURNS):  # in turns, forwards then backwards
            for name in (list(fns) if turn % 2 == 0 else list(fns)[::-1]):
                samples[name].append(host_us(torch, fns[name]))
    result["host_us"] = {name: sorted(v)[len(v) // 2]
                         for name, v in samples.items()}
    result["host_us_turns"] = samples
    print(json.dumps({"host_us": result["host_us"],
                      "host_us_turns": samples}), flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
