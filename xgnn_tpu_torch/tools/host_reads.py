"""The card's rate for scattered reads of pinned, mapped host memory.

The tiered topology's cold rows (K2, K8a, K8b and K9 on a tiered
topology) are read in place from the whole graph's CSR in pinned, mapped
host memory, a 32-byte sector or a few at a time.  PCIe gen 5's rated
63.0 GB/s a direction is not a rate that such reads reach: each is a
request that the link and the host answer.  :func:`host_read_rates`
measures what they do reach, with ``csrc/host_read.cu``: warps filling the
card read random 32- or 128-byte pieces of a pinned, mapped buffer, a
range of reads in flight a warp, and the rates are sectors (32 bytes) and
bytes a second.  ``tools/time_samplers.py --tiered`` and ``chip_smoke.py``
(phase 12) print them beside the tiered samplers as their ceiling.
"""

from __future__ import annotations

from xgnn_tpu_torch.ops import _build
from xgnn_tpu_torch.ops.tiered import MappedHostTensor

# the buffer: about the products graph's host CSR (124M int32 indices)
BUFFER_BYTES = 512 * 2**20
WIDTHS = (32, 128)  # bytes a read
UNROLLS = (1, 2, 4, 8, 16)  # a lane's reads in flight


def host_read_rates(torch, dev, nbytes: int = BUFFER_BYTES,
                    widths=WIDTHS, unrolls=UNROLLS, reads: int = 1 << 22,
                    reps: int = 3) -> list:
    """``[{"bytes_per_read", "reads_per_warp", "reads", "ms",
    "sectors_per_s", "bytes_per_s"}]``, one a (width, unroll), each the
    best of ``reps`` launches of about ``reads`` reads by CUDA events, over
    a pinned, mapped buffer of ``nbytes``.  Raises without a CUDA device."""
    if dev.type != "cuda":
        raise ValueError("host_read_rates: the probe runs on a CUDA device")
    words = nbytes // 4
    host = MappedHostTensor(torch.ones(words, dtype=torch.int32), dev,
                            torch.int32, "host_read_rates")
    lib = _build.load("host_read")
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = _build.stream_handle(dev)
    props = torch.cuda.get_device_properties(dev)
    blocks = props.multi_processor_count * 8  # 2048 threads an SM
    warps = blocks * 8
    rows = []
    try:
        for width in widths:
            lanes = width // 4
            for unroll in unrolls:
                per_warp = unroll * 32 // lanes  # reads in flight a warp
                rounds = max(1, reads // (warps * per_warp))
                n = warps * rounds * per_warp

                def launch(seed):
                    _build.check(lib.xg_host_read(
                        host.dev_ptr, words, lanes, unroll, rounds, blocks,
                        seed, sink.data_ptr(), stream), "host_read_rates")

                launch(0)  # warm-up
                best = None
                for rep in range(reps):
                    t0, t1 = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                    t0.record()
                    launch(rep + 1)
                    t1.record()
                    torch.cuda.synchronize()
                    ms = t0.elapsed_time(t1)
                    best = ms if best is None else min(best, ms)
                rows.append({
                    "bytes_per_read": width, "reads_per_warp": per_warp,
                    "reads": n, "ms": best,
                    "sectors_per_s": n * (width // 32) / best * 1e3,
                    "bytes_per_s": n * width / best * 1e3})
    finally:
        host.close()
    return rows


def ceiling(rows, width: int = 32) -> dict:
    """The row of ``rows`` with the most sectors a second at ``width``
    bytes a read."""
    return max((r for r in rows if r["bytes_per_read"] == width),
               key=lambda r: r["sectors_per_s"])


def describe(rows) -> str:
    """One line a width: sectors and GB a second by reads in flight a
    warp."""
    out = []
    for width in sorted({r["bytes_per_read"] for r in rows}):
        part = ", ".join(
            f"{r['reads_per_warp']}: {r['sectors_per_s'] / 1e6:.1f}M "
            f"sectors/s {r['bytes_per_s'] / 1e9:.2f} GB/s"
            for r in rows if r["bytes_per_read"] == width)
        out.append(f"{width}-byte reads (reads in flight a warp: rate) "
                   f"{part}")
    return "; ".join(out)
