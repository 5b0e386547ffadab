"""The ``xgnn-convert`` command line, built from the checkout's
``cpp/convert.cpp`` (the counterpart of ``xgnn_tpu/clib.py``'s
``convert_path``).

``xgnn-convert`` writes a dataset directory's optional tables: the degree
files (``degrees``), the static cache rankings (``cache-by-degree``,
``cache-by-heuristic``, ``cache-by-degree-hop``, ``cache-by-random``) and
the weighted samplers' tables (``create-weights``), which
:func:`~xgnn_tpu_torch.dataset.load_dataset` reads.  It is built with
``g++`` (``$CXX`` where set) at first use into ``build/xgnn_tpu_torch/``,
under a name that carries a hash of the source and the flags: first into a
file named by the process id, then renamed, so that processes that build
it at once never see a half-written binary.  It is built with OpenMP
where the compiler has its runtime, and serially where it has not (a
compiler without ``libgomp``); the tables are the same either way.  The
port needs no host gather library: K11 reads the host table in place.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from .ops._build import BUILD_DIR

CONVERT_SOURCE = Path(__file__).resolve().parents[1] / "cpp" / "convert.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-std=c++17"]
OPENMP_FLAGS = ["-fopenmp"]

_lock = threading.Lock()


def _binary(flags) -> Path:
    digest = hashlib.sha256(CONVERT_SOURCE.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:12]
    return BUILD_DIR / f"xgnn-convert_{digest}"


def convert_path() -> Optional[str]:
    """The path of the built ``xgnn-convert``, built first if needed; None
    when there is no C++ compiler or no source to build it from.  Raises
    when the compiler fails without OpenMP too."""
    compiler = shutil.which(os.environ.get("CXX", "g++"))
    if compiler is None or not CONVERT_SOURCE.is_file():
        return None
    flavours = (CXX_FLAGS + OPENMP_FLAGS, CXX_FLAGS)
    with _lock:
        for flags in flavours:
            if _binary(flags).is_file():
                return str(_binary(flags))
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        errors = []
        for flags in flavours:
            exe = _binary(flags)
            tmp = BUILD_DIR / f".{exe.name}.{os.getpid()}.tmp"
            r = subprocess.run([compiler] + flags
                               + ["-o", str(tmp), str(CONVERT_SOURCE)],
                               capture_output=True, text=True, timeout=300)
            if r.returncode == 0:
                os.replace(tmp, exe)
                return str(exe)
            tmp.unlink(missing_ok=True)
            errors.append(f"{' '.join(flags)} (exit {r.returncode}):\n"
                          f"{r.stderr}")
    raise RuntimeError("building xgnn-convert failed:\n" + "\n".join(errors))
