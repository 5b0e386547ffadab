"""xgnn_tpu_torch: the PyTorch / CUDA port of xgnn_tpu for NVIDIA Hopper.

The JAX package ``xgnn_tpu`` stays beside it as the reference.  This
package imports torch, numpy and the standard library only.  Its entry
points (``Engine``, ``Sampler``, ``make_device_dataset``) run on the CUDA
device unless the caller names another, and raise when none is there.
"""

from .config import RunConfig, SampleType  # noqa: F401
from .dataset import Dataset  # noqa: F401
from .engine import Engine  # noqa: F401
from .sampler import Sampler  # noqa: F401
from .synthetic_device import make_device_dataset  # noqa: F401

__version__ = "0.1.0"
