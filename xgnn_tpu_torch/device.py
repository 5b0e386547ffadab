"""Where the port's entry points run.

They run on the card unless the caller names another device.  Without a
card and without a named device they raise: they never carry on on the CPU.
"""

from __future__ import annotations

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
