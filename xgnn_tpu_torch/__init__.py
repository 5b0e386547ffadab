"""xgnn_tpu_torch: the PyTorch / CUDA port of xgnn_tpu for NVIDIA Hopper.

The JAX package ``xgnn_tpu`` stays beside it as the reference.  This
package imports torch, numpy and the standard library only.  Its entry
points (``Engine``, ``Sampler``, ``make_device_dataset``, and
``inference.full_graph_inference`` and ``evaluate_full``) run on the CUDA
device unless the caller names another, and raise when none is there.
``load_dataset`` and ``save_dataset`` read and write a dataset directory
on the host.
"""

from .config import RunConfig, SampleType  # noqa: F401
from .dataset import Dataset, load_dataset, save_dataset  # noqa: F401
from .engine import Engine  # noqa: F401
from .sampler import Sampler  # noqa: F401
from .synthetic_device import make_device_dataset  # noqa: F401

__version__ = "0.1.0"
