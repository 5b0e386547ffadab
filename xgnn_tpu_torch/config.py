"""Run configuration of the PyTorch port.

The fields of ``RunConfig`` in ``xgnn_tpu/config.py`` that the ported paths
read, under the same names and defaults; every value they take has its
path in the port, and nothing is silently replaced by another path (the
command line's multi-card flags that select a path not ported yet raise,
naming their ROADMAP item).  PinSAGE is the random-walk path: ``model="pinsage"`` coerces the
sampler to ``random_walk`` with the JAX package's warning.  A
``cache_percentage`` in (0, 1) selects the tiered feature store, with the
ranking of ``cache_policy``.  ``device_loop`` runs an epoch as one
training step captured in a CUDA graph and replayed once a step
(``engine/fused.py``).  The environment overrides ``XGNN_SANITY_CHECK``
and ``XGNN_DUMP_TRACE`` are read as the JAX package reads them; JAX's
``profile_level`` is left out, since no level changes what its profiler
logs.  ``root_path`` and ``dataset`` name the dataset directory
(``dataset_path``) that the command lines load.  The training options are
JAX's: ``feat_dtype="bfloat16"`` keeps the feature table (the tiered
store's device cache) in bfloat16, ``compute_dtype="bfloat16"`` casts the
model's input to it (every model, GAT too), ``remat`` recomputes each
convolution in the backward, ``weight_decay > 0`` is AdamW, and
``agg_impl`` names JAX's fanout-reduce formulation (``loop``, ``tiled`` or
``chunk<N>``), each of which K4 computes.  On one card,
``use_dist_graph`` with ``dist_graph_percentage < 1`` is the tiered
topology (the hot CSR prefix on the device, the rest read in place from
host memory), and ``auto_placement`` solves ``use_dist_graph``,
``dist_graph_percentage`` and ``cache_percentage`` from the device memory
(``hbm_budget_gb`` where given) and the degree skew.  ``arch``,
``num_worker``, ``num_dcn_groups`` and ``exchange_headroom`` are the
multi-card fields that ``MultiChipEngine`` reads; with a
``cache_percentage`` in (0, 1) it runs XGNN's two-phase GGMS, whose cache
``part_cache`` partitions over the cards (else each holds all of it), and
with none it changes nothing, as in the JAX engine's fused shape.
``num_sample_worker``, ``num_train_worker`` and ``balance_switcher`` are
the disaggregated engine's (arch5, ``DisaggregatedEngine``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from enum import Enum
from typing import Optional, Sequence

from . import constants


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


class RunArch(Enum):
    """Execution architectures (same values as the JAX package's enum):
    one card (the single-store ``Engine``), every card sampling, reading
    and training its own shard over the shared stores (XGNN's arch6,
    ``MultiChipEngine``), or sampler cards feeding trainer cards (arch5,
    ``DisaggregatedEngine``)."""

    SINGLE = "single"
    COLLOCATED = "collocated"
    DISAGGREGATED = "disaggregated"


# the reference's arch names, as the JAX package takes them
ARCH_ALIASES = {
    "arch1": RunArch.SINGLE, "arch2": RunArch.SINGLE,
    "arch3": RunArch.SINGLE, "arch4": RunArch.SINGLE,
    "arch5": RunArch.DISAGGREGATED, "arch6": RunArch.COLLOCATED,
    "arch7": RunArch.COLLOCATED, "single": RunArch.SINGLE,
    "collocated": RunArch.COLLOCATED, "disaggregated": RunArch.DISAGGREGATED,
}


class CachePolicy(Enum):
    """Hot-row cache rankings (same names and values as the JAX package's
    enum)."""

    DEGREE = "degree"
    HEURISTIC = "heuristic"
    PRE_SAMPLE = "pre_sample"  # frequency ranking from presample epochs
    DEGREE_HOP = "degree_hop"
    PRE_SAMPLE_STATIC = "presample_static"
    FAKE_OPTIMAL = "fake_optimal"
    DYNAMIC = "dynamic_cache"
    RANDOM = "random"


# khop0/khop2/khop3 are one distribution (uniform K-subset without
# replacement) and share one sampler
UNIFORM_KHOP = (SampleType.KHOP0, SampleType.KHOP2, SampleType.KHOP3)
# the samplers that read the graph's weighted tables
WEIGHTED = (SampleType.WEIGHTED_KHOP, SampleType.WEIGHTED_KHOP_PREFIX,
            SampleType.WEIGHTED_KHOP_HASH_DEDUP)

# the convolutions of the JAX model zoo, all ported
PORTED_MODELS = ("graphsage", "gcn", "gat", "pinsage", "mlp")
DTYPES = ("float32", "bfloat16")
# JAX's fanout_reduce formulations: the loop, K14's tiles, or chunks of N
# picks ("chunk" alone is 3)
AGG_IMPL = re.compile(r"loop|tiled|chunk([1-9][0-9]*)?")


@dataclasses.dataclass
class RunConfig:
    # --- dataset -----------------------------------------------------------
    # the directory that load_dataset reads is root_path/dataset
    root_path: str = "/graph-learning/samgraph/"
    dataset: str = "products"

    # --- execution ---------------------------------------------------------
    arch: RunArch = RunArch.SINGLE
    sample_type: SampleType = SampleType.KHOP3
    num_epoch: int = 10
    batch_size: int = 8000
    fanout: Sequence[int] = (15, 10, 5)
    num_worker: int = 1  # data-parallel cards (MultiChipEngine's ranks)
    # the JAX package's hierarchical mesh; only 1 group is ported
    num_dcn_groups: int = 1
    # each rank's segment for each peer in the owner exchange, over the
    # even split ceil(cap / P); an overflow replays the step at grown
    # capacities, so this is a speed knob
    exchange_headroom: float = 1.25
    # the disaggregated engine (arch5): sampler and trainer roles
    num_sample_worker: int = 1
    num_train_worker: int = 1
    # re-role the devices between samplers and trainers at epoch ends
    # from the measured sample share of the epoch (JAX's balance_switcher)
    balance_switcher: bool = False
    pipeline: bool = True  # overlap sample(n+1) with train(n)
    prefetch_depth: int = 2
    device_loop: bool = False

    # --- model -------------------------------------------------------------
    model: str = "graphsage"  # graphsage, gcn, gat, pinsage or mlp
    num_hidden: int = 256
    num_head: int = 1  # GAT heads on the hidden layers
    num_layer: int = 3
    lr: float = 0.003
    dropout: float = 0.5
    weight_decay: float = 0.0  # > 0: AdamW
    compute_dtype: str = "float32"
    remat: bool = False
    agg_impl: str = "loop"
    feat_dtype: str = "float32"

    # --- feature store -----------------------------------------------------
    cache_policy: CachePolicy = CachePolicy.PRE_SAMPLE
    # in (0, 1): the tiered store, that share of the rows cached on the
    # device; 0 or >= 1: the whole table on the device
    cache_percentage: float = 0.0
    presample_epoch: int = 1
    # the wide-khop fanout of presample_static on a tiered topology
    presample_static_fanout: int = 32
    use_dist_graph: bool = False
    gpu_extract: bool = True
    # the share of the EDGES whose rows stay on the device when
    # use_dist_graph is on; the other rows' adjacency is read from host
    # memory (reference dist_graph_percentage, dist_engine.cc:224-235)
    dist_graph_percentage: float = 1.0
    # MultiChipEngine's two-phase GGMS (a partial cache over the cards):
    # the cache partitioned over the ranks, else replicated on each (SGNN);
    # the fused store interleaves the whole table whatever its value
    part_cache: bool = False
    # solve dist_graph_percentage, cache_percentage and use_dist_graph from
    # the device memory and the degree skew at init (store/placement.py);
    # values the caller set win
    auto_placement: bool = False
    # the device memory auto_placement plans for (GiB); None reads the
    # card's, and must be given on the CPU
    hbm_budget_gb: Optional[float] = None

    # --- random walk (PinSAGE) --------------------------------------------
    random_walk_length: int = 3
    random_walk_restart_prob: float = 0.5
    num_random_walk: int = 4
    num_neighbor: int = 5
    num_layer_pinsage: int = 2

    # --- capacity planning -------------------------------------------------
    frontier_capacities: Optional[Sequence[int]] = None
    calibration_batches: int = 3

    # --- checkpointing -----------------------------------------------------
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1  # epochs

    # --- misc --------------------------------------------------------------
    seed: int = 42
    # the dynamic cache refreshes at an epoch's end when this is -1 or 0
    # (every epoch) or equal to the epoch
    barriered_epoch: int = -1
    report_acc: int = 0
    sanity_check: bool = False
    dump_trace: bool = False

    def __post_init__(self):
        if isinstance(self.arch, str):
            self.arch = ARCH_ALIASES[self.arch]
        if isinstance(self.sample_type, str):
            self.sample_type = SampleType(self.sample_type)
        if isinstance(self.cache_policy, str):
            self.cache_policy = CachePolicy(self.cache_policy)
        self.fanout = tuple(int(f) for f in self.fanout)
        if (self.model == "pinsage"
                and self.sample_type != SampleType.RANDOM_WALK):
            # a khop sampler would give num_layer blocks to a
            # num_layer_pinsage-layer model
            logging.getLogger(__name__).warning(
                "model=pinsage requires random_walk sampling; overriding "
                "sample_type=%s", self.sample_type,
            )
            self.sample_type = SampleType.RANDOM_WALK
        self._load_env()
        self._check_supported()

    def _load_env(self):
        """The environment's overrides, as the JAX package reads them."""
        env = os.environ
        if constants.ENV_SANITY_CHECK in env:
            self.sanity_check = env[constants.ENV_SANITY_CHECK] not in ("",
                                                                        "0")
        if constants.ENV_DUMP_TRACE in env:
            self.dump_trace = env[constants.ENV_DUMP_TRACE] not in ("", "0")

    @property
    def dataset_path(self) -> str:
        return os.path.join(self.root_path, self.dataset)

    def to_dict(self) -> dict:
        out = dataclasses.asdict(self)
        out["arch"] = self.arch.value
        out["sample_type"] = self.sample_type.value
        out["cache_policy"] = self.cache_policy.value
        return out

    def print_run_config(self):
        """The ``config:key=value`` stdout lines, as the JAX package prints
        them."""
        for k, v in sorted(self.to_dict().items()):
            print(f"config:{k}={v}")

    def _check_supported(self):
        if self.model not in PORTED_MODELS:
            raise ValueError(f"model={self.model!r}: not a model of the zoo "
                             f"{PORTED_MODELS}")
        for field in ("compute_dtype", "feat_dtype"):
            if getattr(self, field) not in DTYPES:
                raise ValueError(f"{field}={getattr(self, field)!r}: not one "
                                 f"of {DTYPES}")
        if not AGG_IMPL.fullmatch(self.agg_impl):
            raise ValueError(f"agg_impl={self.agg_impl!r}: not loop, tiled "
                             "or chunk<N>")
