"""Where the port's entry points run.

They run on the card unless the caller names another device.  Without a
card and without a named device they raise: they never carry on on the CPU.
"""

from __future__ import annotations

import warnings
from typing import Optional, Union

import numpy as np
import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "xgnn_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def seed_of(*parts: int) -> int:
    """A 63-bit generator seed mixed from integers (the counterpart of the
    JAX package's ``fold_in`` chains)."""
    s = np.random.SeedSequence([int(p) & 0xFFFFFFFF for p in parts])
    return int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))


def generator(device: torch.device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def feature_dtype(feat) -> torch.dtype:
    """The type a feature table is kept in: float16 for an F16 file's
    table (a float16 array or tensor), float32 for any other."""
    half = str(getattr(feat, "dtype", "")) in ("float16", "torch.float16")
    return torch.float16 if half else torch.float32


def to_tensor(a, device: Union[str, torch.device],
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``a`` (a tensor or an array, a dataset file's read-only memory map
    among them) as a tensor on ``device``, of ``dtype`` where given.  A
    read-only array is read in place and copied once: to the card, or on
    the CPU into memory of the tensor's own, so that nothing writes to a
    file's pages.  A uint32 array (a CSR's offsets from 2^31 edges on)
    becomes int64 on the host first: torch's uint32 support is partial."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    device = torch.device(device)
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if not a.flags.writeable and device.type != "cuda":
        a = np.array(a)
    with warnings.catch_warnings():
        # a read-only array is only read here, by the copy to the card
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        t = torch.as_tensor(a)
    return t.to(device=device, dtype=dtype)
