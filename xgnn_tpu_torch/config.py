"""Run configuration of the PyTorch port.

The fields of ``RunConfig`` in ``xgnn_tpu/config.py`` that the main path
reads, under the same names and defaults.  A value that selects a path the
port does not have yet raises ``NotImplementedError`` naming the ROADMAP
item that ports it; nothing is silently replaced by another path.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional, Sequence


class SampleType(Enum):
    """Sampling algorithms (same values as the JAX package's enum)."""

    KHOP0 = "khop0"
    KHOP1 = "khop1"
    KHOP2 = "khop2"
    KHOP3 = "khop3"
    WEIGHTED_KHOP = "weighted_khop"
    WEIGHTED_KHOP_PREFIX = "weighted_khop_prefix"
    WEIGHTED_KHOP_HASH_DEDUP = "weighted_khop_hash_dedup"
    RANDOM_WALK = "random_walk"


# khop0/khop2/khop3 are one distribution (uniform K-subset without
# replacement) and share one sampler
UNIFORM_KHOP = (SampleType.KHOP0, SampleType.KHOP2, SampleType.KHOP3)

# the convolutions of the JAX model zoo that the port has
PORTED_MODELS = ("graphsage", "gcn", "gat")


@dataclasses.dataclass
class RunConfig:
    # --- execution ---------------------------------------------------------
    sample_type: SampleType = SampleType.KHOP3
    batch_size: int = 8000
    fanout: Sequence[int] = (15, 10, 5)
    pipeline: bool = True  # overlap sample(n+1) with train(n)
    prefetch_depth: int = 2
    device_loop: bool = False

    # --- model -------------------------------------------------------------
    model: str = "graphsage"  # graphsage, gcn or gat
    num_hidden: int = 256
    num_head: int = 1  # GAT heads on the hidden layers
    num_layer: int = 3
    lr: float = 0.003
    dropout: float = 0.5
    compute_dtype: str = "float32"
    remat: bool = False
    agg_impl: str = "loop"
    feat_dtype: str = "float32"

    # --- feature store -----------------------------------------------------
    cache_percentage: float = 0.0
    use_dist_graph: bool = False
    gpu_extract: bool = True

    # --- capacity planning -------------------------------------------------
    frontier_capacities: Optional[Sequence[int]] = None
    calibration_batches: int = 3

    # --- misc --------------------------------------------------------------
    seed: int = 42

    def __post_init__(self):
        if isinstance(self.sample_type, str):
            self.sample_type = SampleType(self.sample_type)
        self.fanout = tuple(int(f) for f in self.fanout)
        self._check_supported()

    def _check_supported(self):
        todo = []
        if self.model not in PORTED_MODELS:
            todo.append(
                f"model={self.model!r}: ROADMAP open item 9 (model zoo)"
            )
        if self.sample_type not in UNIFORM_KHOP:
            todo.append(
                f"sample_type={self.sample_type.value!r}: ROADMAP open item "
                "10 (other samplers)"
            )
        if 0.0 < self.cache_percentage < 1.0:
            todo.append(
                f"cache_percentage={self.cache_percentage}: ROADMAP open item "
                "11 (stores and caching)"
            )
        if self.use_dist_graph:
            todo.append("use_dist_graph: ROADMAP open items 11 and 14")
        if self.device_loop:
            todo.append("device_loop: ROADMAP open item 12 (tooling)")
        if self.agg_impl != "loop":
            todo.append(f"agg_impl={self.agg_impl!r}: ROADMAP kernel K14")
        if self.compute_dtype != "float32" or self.feat_dtype != "float32":
            todo.append("bfloat16 compute or features: ROADMAP open item 6 "
                        "(train.py)")
        if self.remat:
            todo.append("remat: ROADMAP open item 5 (models/gnn.py)")
        if todo:
            raise NotImplementedError(
                "not ported to xgnn_tpu_torch yet: " + "; ".join(todo)
            )
