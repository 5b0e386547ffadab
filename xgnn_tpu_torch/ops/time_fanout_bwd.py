"""Time the two forms of K4's backward on one CUDA card.

    python -m xgnn_tpu_torch.ops.time_fanout_bwd

``csrc/fanout.cu`` adds each pick's gradient row with 16-byte vector
atomics when the width allows, or with one scalar atomic per column.  This
script builds the source a second time with ``-DXG_FANOUT_BWD_VEC4=0`` (the
scalar form only), samples one batch of the main path (the products-scale
synthetic graph, batch 8000, fanout (15, 10, 5)), and times at the layer-1
shape, by CUDA events: each form's kernel alone, the zero fill of the
gradient table alone, and the whole wrapper (fill plus vector kernel).
Both forms are checked against the plain PyTorch version first.  Prints the
card's line and one JSON object.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from . import _build
from .fanout import fanout_backward, fanout_backward_plain

NUM_NODE, NUM_EDGE, FEAT_DIM, NUM_CLASS = 2_449_029, 62_000_000, 128, 47
BATCH, FANOUT, HIDDEN = 8000, (15, 10, 5), 256
CAPS = (BATCH, 133376, 1007360, 2449152)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def _scalar_library() -> ctypes.CDLL:
    path = _build.library_path("fanout").with_name(
        _build.library_path("fanout").stem + "_scalar.so")
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run(
            [_build.nvcc()] + _build.NVCC_FLAGS
            + ["-DXG_FANOUT_BWD_VEC4=0", "-o", str(path),
               str(_build.CSRC / "fanout.cu")],
            check=True,
        )
    lib = ctypes.CDLL(str(path))
    lib.xg_fanout_bwd.argtypes = _build.SIGNATURES["fanout"]["xg_fanout_bwd"]
    lib.xg_fanout_bwd.restype = ctypes.c_int
    return lib


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("time_fanout_bwd: no CUDA device", file=sys.stderr)
        return 2
    from ..config import RunConfig
    from ..device import generator
    from ..engine.shuffler import Shuffler
    from ..sampler import Sampler
    from ..synthetic_device import make_device_dataset

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    vec_lib, scalar_lib = _build.load("fanout"), _scalar_library()

    ds = make_device_dataset(NUM_NODE, NUM_EDGE, FEAT_DIM, NUM_CLASS,
                             train_frac=0.08, seed=0, device=dev)
    cfg = RunConfig(batch_size=BATCH, fanout=FANOUT, num_hidden=HIDDEN,
                    frontier_capacities=CAPS, calibration_batches=0)
    seeds, n = next(Shuffler(ds.train_set, BATCH, seed=7).epoch_batches(0))
    batch = Sampler(ds.graph, cfg, direct_extract=True).sample(
        torch.from_numpy(seeds).to(dev), n, generator(dev, 7))
    neigh = batch.blocks[1].neigh
    num_rows = CAPS[2]
    d, k = neigh.shape
    grad_sum = torch.randn((d, HIDDEN), generator=generator(dev, 11),
                           device=dev)
    ref = fanout_backward_plain(grad_sum, neigh, None, num_rows)
    stream = _build.stream_handle(dev)

    def launch(lib, out):
        _build.check(lib.xg_fanout_bwd(
            grad_sum.data_ptr(), neigh.data_ptr(), None, out.data_ptr(),
            num_rows, d, k, HIDDEN, stream), "fanout_bwd")

    times, errors = {}, {}
    for name, lib in (("vector_atomics", vec_lib),
                      ("scalar_atomics", scalar_lib)):
        out = torch.zeros((num_rows, HIDDEN), device=dev)
        launch(lib, out)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
        errors[name] = float((out - ref).abs().max())
        times[name + "_kernel_ms"] = _time_ms(lambda: launch(lib, out))
    times["zero_fill_ms"] = _time_ms(
        lambda: torch.zeros((num_rows, HIDDEN), device=dev))
    times["wrapper_ms"] = _time_ms(
        lambda: fanout_backward(grad_sum, neigh, None, num_rows))

    valid = (neigh >= 0) & (neigh < num_rows)
    nbytes = grad_sum.numel() * 4 + neigh.numel() * 4 + num_rows * HIDDEN * 4
    print(card)
    print(json.dumps({
        "card": card, "shape": f"{tuple(neigh.shape)} picks "
        f"({int(valid.sum())} valid) into ({num_rows}, {HIDDEN}) f32",
        **times, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "max_abs_err": errors,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
