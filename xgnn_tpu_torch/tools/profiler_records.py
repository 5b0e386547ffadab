#!/usr/bin/env python3
"""Count the kernel records that short profiler sessions keep.

    [TEARDOWN_CUPTI=0] python3 xgnn_tpu_torch/tools/profiler_records.py \
        [--sessions N] [--settle S] [--capture]

Each session profiles one call of K3 (``unique_seeded_split``, three
kernels) at the main path's layer-1 dedup size, waits for the card, sleeps
``--settle`` seconds and stops; the script counts the device events each
session kept.  ``--capture`` first captures that call in a CUDA graph and
replays it once, so the sessions follow a replay in the process.
``TEARDOWN_CUPTI=0`` keeps CUPTI set up between sessions (PyTorch sets it
so when ``torch.compile`` uses CUDA graphs).  The last line is one JSON
object: the sessions that kept all three records, some, and none.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=40)
    ap.add_argument("--settle", type=float, default=0.2)
    ap.add_argument("--capture", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(CHECKOUT))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from xgnn_tpu_torch.ops.unique import unique_seeded_split

    if not torch.cuda.is_available():
        print("profiler_records: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    num_node, cap = 2_449_029, 1_007_360
    g = torch.Generator(device=dev).manual_seed(9)
    prefix = torch.randint(0, num_node, (133_376,), generator=g, device=dev,
                           dtype=torch.int32)
    picks = torch.randint(0, num_node, (1_333_760,), generator=g,
                          device=dev, dtype=torch.int32)
    num = torch.full((), 123_000, dtype=torch.int32, device=dev)

    def call():
        return unique_seeded_split(prefix, picks, num, cap,
                                   num_node=num_node)

    call()  # the state made and the kernels loaded
    torch.cuda.synchronize()
    if args.capture:
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            call()
        graph.replay()
        torch.cuda.synchronize()
    kept = []
    for _ in range(args.sessions):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
            time.sleep(args.settle)
        kept.append(sum(e.device_type == DeviceType.CUDA
                        for e in prof.events()))
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI"),
        "capture": args.capture, "settle_s": args.settle,
        "sessions": args.sessions,
        "all_three": sum(k >= 3 for k in kept),
        "some": sum(0 < k < 3 for k in kept),
        "none": sum(k == 0 for k in kept), "kept": kept}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
