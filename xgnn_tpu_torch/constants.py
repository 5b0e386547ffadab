"""Framework-wide constants of the PyTorch port.

The port's own copy of what it needs from ``xgnn_tpu/constants.py``: the
dataset directory's file names and ``meta.txt`` keys (the reference's
binary layout, so that both packages read and write the same files), and
int32 ids with the int32 maximum as the padding sentinel, so blocks and
frontiers hold the same values in both packages.
"""

import numpy as np

# dataset binary layout (reference constant.cc:23-42)
META_FILE = "meta.txt"
FEAT_FILE = "feat.bin"
LABEL_FILE = "label.bin"
INDPTR_FILE = "indptr.bin"
INDICES_FILE = "indices.bin"
TRAIN_SET_FILE = "train_set.bin"
TEST_SET_FILE = "test_set.bin"
VALID_SET_FILE = "valid_set.bin"

PROB_TABLE_FILE = "prob_table.bin"
ALIAS_TABLE_FILE = "alias_table.bin"
PROB_PREFIX_TABLE_FILE = "prob_prefix_table.bin"

IN_DEGREE_FILE = "in_degrees.bin"
OUT_DEGREE_FILE = "out_degrees.bin"

CACHE_BY_DEGREE_FILE = "cache_by_degree.bin"
CACHE_BY_HEURISTIC_FILE = "cache_by_heuristic.bin"
CACHE_BY_DEGREE_HOP_FILE = "cache_by_degree_hop.bin"
CACHE_BY_FAKE_OPTIMAL_FILE = "cache_by_fake_optimal.bin"
CACHE_BY_RANDOM_FILE = "cache_by_random.bin"

# meta.txt keys (reference constant.h:58-66)
META_NUM_NODE = "NUM_NODE"
META_NUM_EDGE = "NUM_EDGE"
META_FEAT_DIM = "FEAT_DIM"
META_FEAT_DATA_TYPE = "FEAT_DATA_TYPE"
META_NUM_CLASS = "NUM_CLASS"
META_NUM_TRAIN_SET = "NUM_TRAIN_SET"
META_NUM_TEST_SET = "NUM_TEST_SET"
META_NUM_VALID_SET = "NUM_VALID_SET"

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

# environment overrides (the JAX package's names)
ENV_SANITY_CHECK = "XGNN_SANITY_CHECK"
ENV_DUMP_TRACE = "XGNN_DUMP_TRACE"
ENV_LOG_NODE_ACCESS = "XGNN_LOG_NODE_ACCESS"
