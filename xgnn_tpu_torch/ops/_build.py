"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/xgnn_tpu_torch/``
at the root of the checkout, and bound with ``ctypes``.  A source may
include the shared headers ``csrc/*.cuh`` (``-I csrc``, so a copy of a
source built elsewhere finds them too).  A library's file name carries a
hash of its source, the headers and the flags, so an edited one is
rebuilt.  A library of :data:`VARIANTS` is its source built with extra
flags (K5's 2-byte tables: ``attend.cu`` with ``-DXG_ATTEND_ELEM``).
:func:`build` compiles several libraries at once, one ``nvcc`` process
each.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
wrappers raise when it is not 0.  Each wrapper counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xgnn_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-I", str(CSRC),
]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F = ctypes.c_float
# the C entry points of each source, with their argument types
SIGNATURES = {
    "gather": {
        "xg_gather_rows": [_P, _P, _P, _LL, _LL, _LL, _I, _P],
    },
    "fanout": {
        # the int before the stream: the table's element (0 float32, 1
        # bfloat16, 2 float16)
        "xg_fanout_fwd": [_P] * 5 + [_LL, _LL, _I, _LL, _I, _I, _P],
        "xg_fanout_bwd": [_P] * 9 + [_LL, _LL, _LL, _I, _LL, _LL, _P],
    },
    "sampling": {
        # the last four: the tier's host indptr and indices, num_total, the
        # stream (xgnn_tpu_torch/ops/sampling.py, _cold_args)
        "xg_sample_khop": [_P] * 5 + [_LL, _LL, _I, _P, _P, _LL, _P],
        "xg_sample_wr": [_P] * 5 + [_LL, _LL, _I, _I, _P, _P, _LL, _P],
    },
    "random_walk": {
        "xg_random_walk": [_P] * 7 + [_LL, _LL, _I, _I, _I, _F, _P, _P, _LL,
                                      _P],
        "xg_walk_topk": [_P] * 4 + [_LL, _I, _I, _I, _P],
    },
    "exchange": {
        # ids, n, parts, hot_limit, seg_cap, the buffer, the stream
        "xg_plan_exchange": [_P, _LL, _I, _LL, _LL, _P, _P],
        "xg_plan_buffer_words": [_LL, _I, _LL],
    },
    "unique": {
        "xg_unique_seeded": [_P, _LL, _P, _LL, _P, _LL, _LL, _P, _LL,
                             _P, _P, _P, _P, _P],
    },
    "degree": {
        "xg_pick_multiplicity": [_P] * 4 + [_LL, _LL, _P],
    },
    "weighted": {
        "xg_sample_prefix": [_P] * 7 + [_LL, _LL, _I] + [_P] * 3 + [_LL, _P],
        "xg_sample_alias": [_P] * 8 + [_LL, _LL, _I, _I, _I] + [_P] * 4
        + [_LL, _P],
    },
    "tiered": {
        # host, bytes, device, read_only, the device address's address
        "xg_host_map": [_P, _LL, _I, _I, _P],
        "xg_host_unmap": [_P, _I],
        "xg_host_map_count": [_P],
        "xg_tiered_split": [_P, _LL, _P, _P, _LL, _P, _LL, _I] + [_P] * 6,
        "xg_tiered_split_positions": [_P, _LL, _P, _P, _LL] + [_P] * 6,
        "xg_tiered_positions_scratch_bytes": [_LL],
        # host_bytes (4 float32, 2 float16), out_bf16
        "xg_tiered_direct": [_P, _LL, _P, _P, _P, _P, _LL, _I, _I, _P],
    },
    "presample": {
        "xg_accumulate_freq": [_P, _LL, _P, _LL, _P, _I, _P],
        "xg_closure_expand": [_P, _P, _LL, _LL, _P, _LL, _I, _P, _LL, _P,
                              _I, _P],
        "xg_closure_scratch_bytes": [_LL, _LL],
        # indptr, indices, rows, num_node, num_edge, parts, part, level,
        # recv, tag, known, scratch, its bytes, counts, the device, stream
        "xg_closure_parts": [_P, _P, _LL, _LL, _LL, _I, _I, _P, _P, _I, _P,
                             _P, _LL, _P, _I, _P],
        "xg_closure_parts_scratch_bytes": [_LL, _I, _LL],
        "xg_closure_parts_known_words": [_LL, _I],
    },
    "spmm": {
        "xg_spmm_csr": [_P] * 4 + [_LL, _LL, _LL, _I, _LL, _P],
        "xg_gat_csr": [_P] * 6 + [_LL, _LL, _I, _I, _F, _LL, _P],
        "xg_spmm_csr_f16": [_P] * 4 + [_LL, _LL, _LL, _I, _LL, _LL, _P],
    },
    "host_read": {  # a probe of the card's mapped host reads, no path's
        "xg_host_read": [_P, _LL, _I, _I, _I, _I, ctypes.c_uint, _P, _P],
    },
    "attend": {
        "xg_attend_fwd": [_P] * 7 + [_LL, _LL, _I, _I, _I, _I, _F, _P],
        "xg_attend_bwd": [_P] * 13 + [_I, _LL, _LL, _I, _I, _I, _I, _F, _P],
    },
}


# entry points that return something other than a cudaError_t
RESTYPES = {"xg_closure_scratch_bytes": _LL,
            "xg_tiered_positions_scratch_bytes": _LL,
            "xg_closure_parts_scratch_bytes": _LL,
            "xg_closure_parts_known_words": _LL, "xg_plan_buffer_words": _LL}

# K5 over a 2-byte table: attend.cu with its element chosen at build time
VARIANTS = {
    "attend_bf16": ("attend", ["-DXG_ATTEND_ELEM=1"]),
    "attend_f16": ("attend", ["-DXG_ATTEND_ELEM=2"]),
}
for _name in VARIANTS:
    SIGNATURES[_name] = SIGNATURES["attend"]


class LaunchCounter:
    """Launches of each kernel, counted by its wrapper (thread-safe: the
    prefetch thread launches kernels too)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n: collections.Counter = collections.Counter()

    def add(self, name: str):
        with self._lock:
            self._n[name] += 1

    def reset(self):
        with self._lock:
            self._n.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._n)


LAUNCHES = LaunchCounter()

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc"
    ]:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _source(name: str):
    """``(source file, nvcc flags)`` of a library."""
    src, extra = VARIANTS.get(name, (name, []))
    return CSRC / f"{src}.cu", NVCC_FLAGS + extra


def library_path(name: str) -> Path:
    src, flags = _source(name)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(flags).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names: Optional[Iterable[str]] = None):
    """Compile every named source whose library is missing, all at once.

    Returns ``{name: (seconds, compiler_output)}`` for the sources built.
    """
    names = list(SIGNATURES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for n in todo:
        tmp = BUILD_DIR / f".{library_path(n).name}.{os.getpid()}.tmp"
        src, flags = _source(n)
        cmd = [compiler] + flags + ["-o", str(tmp), str(src)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, time.perf_counter())
    out, failed = {}, []
    for n, (p, tmp, t0) in procs.items():
        log, _ = p.communicate()
        out[n] = (time.perf_counter() - t0, log)
        if p.returncode != 0:
            failed.append(f"{n} (nvcc exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
            _libs[name] = lib
        return lib


def check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


# the raw handle without a Stream object (CUDA builds of PyTorch have it)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device) -> int:
    """The handle of PyTorch's current stream on ``device``."""
    if _raw_stream is not None and device.index is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def int32_scalar(num, device) -> torch.Tensor:
    """``num`` (an int or a one-element tensor) as an int32 scalar on
    ``device``, for a kernel that reads a count on the device; an int is
    filled in there, so nothing waits on the host."""
    if isinstance(num, torch.Tensor):
        return num.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(num), dtype=torch.int32, device=device)
