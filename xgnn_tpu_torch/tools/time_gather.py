#!/usr/bin/env python3
"""Time K1, the row gather, against its parent version and the variants
it was chosen over.

    python3 xgnn_tpu_torch/tools/time_gather.py [--parent DIR]

Builds ``csrc/gather.cu`` as it is ("shipped"); variants made from it by
text substitution: "warp_per_row" (a warp for every row, whatever its
width: the first design, which differs from the shipped one only on rows
of 16 words or fewer, so it is not timed on the float32 table's rows of
32 16-byte words), "unrolled" (the copy loop unrolled, as nvcc does
without ``#pragma unroll 1``), and "unrolled" without
``__launch_bounds__``, with a 32-bit row index, or with at most 32
registers (``__launch_bounds__(256, 8)``); and, given ``DIR``, "parent":
``DIR/xgnn_tpu_torch/csrc/gather.cu``, bound with the C interface that
``DIR``'s ``ops/_build.py`` declares (unpack it into a gitignored
directory, as in ``git archive <commit> | tar -x -C build/parent``; a
parent without the element-size argument gathers 4-byte words, so it is
not timed on the bfloat16 table).  Each build's registers and stack a
thread are read with ``cuobjdump -res-usage``.  Each is timed with
``chip_smoke.time_ms`` at the main path's shapes, in turns (the others,
shipped, shipped, the others backwards, twice): 1,007,360 ids, 958,286 of
them distinct rows drawn at random and the rest EMPTY, over a
(2,449,029, 128) table in float32 and in bfloat16 ("f32", "bf16"); layer
0's dst ids of the main path's first batch (``chip_smoke``'s graph and
configuration, seed 7) over its feature table, float32 and bfloat16
("f32_main", "bf16_main"); and the label column (8,000 ids over
(2,449,029, 1) int32).  Each result is checked against the plain
version.  ``ms`` runs ten calls back to back, ``device_ms`` queues them
while the card sleeps (the card's time alone).  The last line is one
JSON object.
"""

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
NUM_NODE, NUM_IDS, NUM_VALID, WIDTH = 2_449_029, 1_007_360, 958_286, 128
_DISPATCH = """  if (width <= 1)
    launch_lanes<Word, 1>(feat, ids, out, num_rows, num_ids, width, s);"""
_UNROLLED = ("#pragma unroll 1\n", "")
_BOUNDS = ("__global__ void __launch_bounds__(kThreads)\n",
           "__global__ void\n")
_INDEX = ("""  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t row = t / kLanes;
  const int lane = (int)(t % kLanes);""",
          """  const int64_t row =
      (int64_t)blockIdx.x * (kThreads / kLanes) + threadIdx.x / kLanes;
  const int lane = (int)(threadIdx.x % kLanes);""")
_MIN8 = ("__launch_bounds__(kThreads)\n", "__launch_bounds__(kThreads, 8)\n")
VARIANTS = {
    "warp_per_row": [(_DISPATCH, """  if (false)
    launch_lanes<Word, 1>(feat, ids, out, num_rows, num_ids, width, s);"""),
                     ("  else if (width <= 2)", "  else if (false)"),
                     ("  else if (width <= 4)", "  else if (false)"),
                     ("  else if (width <= 8)", "  else if (false)"),
                     ("  else if (width <= 16)", "  else if (false)")],
    # the copy loop unrolled, as nvcc unrolls it by default
    "unrolled": [_UNROLLED],
    # and without __launch_bounds__
    "unrolled_no_bounds": [_UNROLLED, _BOUNDS],
    # and a row's index from the block's and the thread's in 32 bits
    "unrolled_block_index": [_UNROLLED, _INDEX],
    # and at most 32 registers (8 blocks of 256 an SM)
    "unrolled_min_blocks8": [_UNROLLED, _MIN8],
}


def registers(_build, lib: Path) -> dict:
    """``{kernel: "REG:n STACK:m"}`` of the library's gather kernels as
    ``cuobjdump -res-usage`` reads them (empty where it is missing)."""
    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-res-usage", str(lib)],
                          capture_output=True, text=True).stdout
    found = re.findall(r"Function (\S*gather_rows_kernel\S*):\s*"
                       r"(REG:\d+ STACK:\d+)", text)
    return {name.split("gather_rows_kernel")[1]: use for name, use in found}


def build(_build, parent) -> dict:
    """``{name: (ctypes library, takes the element size)}``: the shipped
    source, its variants and, given ``parent``, the parent source,
    compiled in parallel."""
    out_dir = _build.BUILD_DIR / "time_gather"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "gather.cu").read_text()
    sigs = _build.SIGNATURES["gather"]
    sources = {"shipped": (_build.CSRC / "gather.cu", sigs)}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"time_gather: the {name} variant's text "
                                   f"is not in gather.cu once: {old!r}")
            text = text.replace(old, new)
        src = out_dir / f"gather_{name}.cu"
        src.write_text(text)
        sources[name] = (src, sigs)
    if parent is not None:
        root = Path(parent).resolve() / "xgnn_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            "parent_build", root / "ops" / "_build.py")
        parent_build = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(parent_build)
        sources["parent"] = (root / "csrc" / "gather.cu",
                             parent_build.SIGNATURES["gather"])
    procs = {}
    for name, (src, _) in sources.items():
        lib = out_dir / f"libgather_{name}.so"
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + ["-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    libs = {}
    for name, (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"time_gather: the {name} build failed:\n"
                               f"{log[-2000:]}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in sources[name][1].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        # 8 arguments: the element size before the stream
        libs[name] = (cdll, len(sources[name][1]["xg_gather_rows"]) == 8,
                      registers(_build, lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout of the version to compare with")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    import torch

    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.gather import DTYPES, gather_rows_plain
    from xgnn_tpu_torch.sampler import Sampler

    if not torch.cuda.is_available():
        print("time_gather: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    libs = build(_build, args.parent)
    g = torch.Generator(device=dev).manual_seed(5)
    feat = torch.randn((NUM_NODE, WIDTH), generator=g, device=dev)
    ids = torch.full((NUM_IDS,), torch.iinfo(torch.int32).max,
                     dtype=torch.int32, device=dev)
    ids[:NUM_VALID] = torch.randperm(NUM_NODE, generator=g,
                                     device=dev)[:NUM_VALID].to(torch.int32)
    ids = ids[torch.randperm(NUM_IDS, generator=g, device=dev)].contiguous()
    labels = torch.randint(0, 47, (NUM_NODE, 1), generator=g, device=dev,
                           dtype=torch.int32)
    seeds = torch.randperm(NUM_NODE, generator=g,
                           device=dev)[:8000].to(torch.int32)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", dedup=False)
    batch_seeds, n = next(Shuffler(ds.train_set, cs.BATCH,
                                   seed=7).epoch_batches(0))
    dst_ids = Sampler(ds.graph, RunConfig(**cs.BENCH_CONFIG),
                      direct_extract=True).sample(
        torch.from_numpy(batch_seeds).to(dev), n,
        generator(dev, 7)).blocks[0].dst_ids
    cases = {
        "f32": (feat, ids),
        "bf16": (feat.to(torch.bfloat16), ids),
        "f32_main": (ds.feat, dst_ids),
        "bf16_main": (ds.feat.to(torch.bfloat16), dst_ids),
        "labels": (labels, seeds),
    }
    rows = {"registers": {name: use for name, (_, _, use) in libs.items()}}
    print(f"registers: {rows['registers']}", flush=True)
    for case, (table, cids) in cases.items():
        ref = gather_rows_plain(table, cids)
        width = table.shape[1]
        n_valid = int(((cids >= 0) & (cids < table.shape[0])).sum())
        s = table.element_size()
        nbytes = n_valid * width * s + cids.shape[0] * (width * s + 4)
        rows[case] = {"bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3}
        # warp_per_row is the shipped code on rows of more than 16 words
        narrow = width * table.element_size() <= 256
        others = [x for x in libs if x != "shipped"
                  and (x != "warp_per_row" or narrow)
                  and (libs[x][1] or table.element_size() == 4)]
        for name in 2 * (others + ["shipped", "shipped"] + others[::-1]):
            lib, sized, _ = libs[name]
            out = torch.empty_like(ref)
            size = (DTYPES[table.dtype],) if sized else ()

            def call():
                rc = lib.xg_gather_rows(
                    table.data_ptr(), cids.data_ptr(), out.data_ptr(),
                    table.shape[0], cids.shape[0], width, *size,
                    _build.stream_handle(dev))
                _build.check(rc, f"time_gather {name}")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"time_gather: {name} on {case} differs "
                                     "from the plain version")
            ms = cs.time_ms(torch, call)
            device_ms = cs.time_ms(torch, call, host_ahead=True)
            rows[case].setdefault(name, []).append(
                {"ms": ms, "device_ms": device_ms})
            print(f"[{card}] {case} {name}: {ms:.4f} ms, {device_ms:.4f} ms "
                  f"on the card alone (bound {rows[case]['bound_ms']:.4f})",
                  flush=True)
    print(json.dumps({"card": card, "gather": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
