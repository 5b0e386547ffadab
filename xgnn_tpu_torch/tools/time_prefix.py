#!/usr/bin/env python3
"""Time K8b-prefix against the coarse-rows-only design it was chosen over.

    python3 xgnn_tpu_torch/tools/time_prefix.py

The kept kernel reads a row of at most 128 entries whole and searches a
longer row through its coarse row.  The other design sends every row
through its coarse row: the same source, ``csrc/weighted.cu``, built here
with ``-DXG_PREFIX_DIRECT_MAX=0`` into a library of its own.  The inputs
are those of ``chip_smoke.py``'s phase 7: the weighted products-scale
synthetic dataset (seed 0), the seeds of its first batch, and one batch
walked layer by layer through K8b-prefix and K3 with uniforms from
generator seed 11.  At each layer both builds are checked exactly against
the plain version and timed with ``chip_smoke.time_ms`` with the host
ahead of the card (``device_ms``, the card's time alone), alternating
kept, coarse-only, coarse-only, kept.  The bytes each design reads of the
rows (whole rows of at most 128 entries; a 512-byte coarse row for every
live row) are printed beside.  The last line is one JSON object.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]


def build_coarse_only(_build) -> ctypes.CDLL:
    """``csrc/weighted.cu`` with every prefix row through its coarse row."""
    flags = _build.NVCC_FLAGS + ["-DXG_PREFIX_DIRECT_MAX=0"]
    out = _build.BUILD_DIR / "libweighted_coarse_only.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc()] + flags + [
        "-o", str(out), str(_build.CSRC / "weighted.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.xg_sample_prefix
    fn.argtypes = _build.SIGNATURES["weighted"]["xg_sample_prefix"]
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    sys.path.insert(0, str(CHECKOUT))
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        print("time_prefix: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.engine.shuffler import Shuffler
    from xgnn_tpu_torch.ops import _build
    from xgnn_tpu_torch.ops.sampling import (
        EMPTY,
        sample_weighted_khop_prefix,
        sample_weighted_khop_prefix_plain,
    )
    from xgnn_tpu_torch.ops.unique import unique_seeded_split

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    _build.build(["weighted", "unique"])
    only = build_coarse_only(_build)
    ds = make_device_dataset(cs.NUM_NODE, cs.NUM_EDGE, cs.FEAT_DIM,
                             cs.NUM_CLASS, train_frac=0.08, seed=0,
                             name="products_synth", weighted=True)
    g = ds.graph
    seeds, n = next(Shuffler(ds.train_set, cs.BATCH, seed=7).epoch_batches(0))
    frontier = torch.from_numpy(seeds).to(dev)
    num = torch.full((), n, dtype=torch.int32, device=dev)
    gen = generator(dev, 11)
    rows = []
    for layer, k in enumerate(cs.FANOUT):
        u = torch.rand((frontier.shape[0], k), generator=gen, device=dev)
        a = (g.indptr, g.indices, g.prob_prefix_table, frontier, k, None,
             g.n_max_deg, g.coarse_cdf)
        out_only = torch.empty((frontier.shape[0], k), dtype=torch.int32,
                               device=dev)

        def kept():
            return sample_weighted_khop_prefix(*a, u=u)

        def coarse_only():
            rc = only.xg_sample_prefix(
                g.indptr.data_ptr(), g.indices.data_ptr(),
                g.prob_prefix_table.data_ptr(), g.coarse_cdf.data_ptr(),
                frontier.data_ptr(), u.data_ptr(), out_only.data_ptr(),
                g.num_node, frontier.shape[0], k, _build.stream_handle(dev))
            _build.check(rc, "coarse-only sample_prefix")
            return out_only

        ref = sample_weighted_khop_prefix_plain(*a, u=u)
        got = kept()
        for what, out in (("kept", got), ("coarse-only", coarse_only())):
            if not torch.equal(out, ref):
                raise AssertionError(f"layer {layer}: the {what} build "
                                     "differs from the plain version")
        times = {"kept": [], "coarse_only": []}
        for name in ("kept", "coarse_only", "coarse_only", "kept"):
            fn = kept if name == "kept" else coarse_only
            times[name].append(cs.time_ms(torch, fn, host_ahead=True))
        ok = (frontier >= 0) & (frontier < g.num_node)
        node = torch.where(ok, frontier, 0).long()
        deg = torch.where(ok, g.indptr[node + 1] - g.indptr[node], 0)
        live = deg[deg > 0]
        row = {"layer": layer, "frontier": frontier.shape[0],
               "live_rows": live.numel(),
               "rows_past_128": int((live > 128).sum()), "fanout": k,
               "picks": int((got != EMPTY).sum()),
               "kept_device_ms": times["kept"],
               "coarse_only_device_ms": times["coarse_only"],
               "direct_read_bytes": int(live[live <= 128].sum()) * 4,
               "coarse_row_bytes": live.numel() * 512}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if layer == len(cs.FANOUT) - 1:
            break
        nxt = unique_seeded_split(frontier, got.reshape(-1), num,
                                  cs.CAPS[layer + 1], num_node=g.num_node)
        frontier, num = nxt[0], torch.clamp(nxt[1], max=cs.CAPS[layer + 1])
    print(json.dumps({"card": card, "layers": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
