"""Framework-wide constants of the PyTorch port.

The port's own copy of what it needs from ``xgnn_tpu/constants.py``: ids are
int32 and the padding sentinel is the int32 maximum, so blocks and frontiers
hold the same values in both packages.
"""

import numpy as np

# int32 ids, with the int32 max as the padding sentinel: it sorts after every
# valid id, which the sort-based frontier dedup relies on, and it is out of
# range for every real table, which the gather kernels rely on
ID_DTYPE = np.int32
EMPTY_KEY = int(np.iinfo(np.int32).max)  # 2147483647

# headroom when calibrating static frontier capacities (reference
# constant.h:82 scales workspace allocations by the same factor)
ALLOC_SCALE = 1.25
# calibrated capacities are rounded up to a multiple of this
CAPACITY_ALIGN = 256
