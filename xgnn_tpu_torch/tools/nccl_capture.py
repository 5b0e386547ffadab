"""What a CUDA graph captures of the collocated step's collectives at P = 1.

The multi-card ``device_loop`` captures the rank's fused step, its
``all_reduce`` (the gradients' weighted sum) and ``all_to_all_single``
(the owner exchange) among it.  In a world of one, NCCL may run a
collective as a copy or as nothing, and the profiler lists its
``nccl:*`` annotations on the card's timeline beside the kernels.  This
captures the two collectives and an add after them, writes the graph as
a DOT file (``CUDAGraph.debug_dump``) and prints its nodes' kinds and the
device events of three eager rounds and of three replays:

    python3 xgnn_tpu_torch/tools/nccl_capture.py [DOT_PATH]

It needs a card and NCCL (a world of one through a file store in a
temporary directory).
"""

from __future__ import annotations

import re
import shutil
import sys
import tempfile
import time


def device_events(torch, fn) -> list:
    """The names of the device events that ``fn`` queues, sorted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a lead-in of short kernels: a session may lose its first records
        for _ in range(30):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.2)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.3)
    return sorted(e.name[:80] for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and "spin" not in e.name)


def main(argv) -> int:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("nccl_capture: no CUDA device", file=sys.stderr)
        return 2
    path = argv[0] if argv else "nccl_graph.dot"
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    store = tempfile.mkdtemp(prefix="xgnn_mesh_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            world_size=1, rank=0)
    try:
        print(f"torch {torch.__version__}, NCCL "
              f"{torch.cuda.nccl.version()}, {torch.cuda.get_device_name(0)}",
              flush=True)
        x = torch.randn(1 << 20, device=dev)
        y = torch.empty_like(x)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))

        def step():
            dist.all_reduce(x)
            dist.all_to_all_single(y, x)
            y.add_(1.0)

        with torch.cuda.stream(stream):  # the communicator, before capture
            step()
        torch.cuda.synchronize()
        print("eager:", device_events(torch, lambda: [step()
                                                      for _ in range(3)]))
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            step()
        graph.debug_dump(path)
        dot = open(path).read()
        kinds = re.findall(r'label="\{\s*(\w+)', dot)
        print(f"graph nodes ({path}): {kinds}")
        print("replayed:", device_events(torch, lambda: [graph.replay()
                                                         for _ in range(3)]))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
