"""Profiler: step, epoch and init metrics, trace events, stdout contract.

The port of ``xgnn_tpu/profiler.py`` under the same metric names: three
metric tiers (init, per step, per epoch), the warm-up epoch 0 left out of
the averages, Chrome trace-event JSON with one tid per pipeline stage, the
node-access analytics (``XGNN_LOG_NODE_ACCESS``) and the
``test_result:key=value`` stdout protocol.  Device memory comes from
``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Optional

import torch

from . import constants as C


# canonical step items (reference profiler.h LogStepItem taxonomy)
L1_SAMPLE_TIME = "sample_time"
L1_COPY_TIME = "copy_time"
L1_CONVERT_TIME = "convert_time"
L1_TRAIN_TIME = "train_time"
L1_FEATURE_BYTES = "feature_bytes"
L1_LABEL_BYTES = "label_bytes"
L1_GRAPH_BYTES = "graph_bytes"
L1_MISS_BYTES = "miss_bytes"
L1_NUM_NODE = "num_nodes"
L1_NUM_SAMPLE = "num_samples"
L2_CACHE_HIT_RATE = "cache_hit_rate"
L2_SHUFFLE_TIME = "shuffle_time"
L2_CORE_SAMPLE_TIME = "core_sample_time"
L2_ID_REMAP_TIME = "id_remap_time"
L2_EXTRACT_TIME = "extract_time"
L3_OVERFLOW_RETRY = "overflow_retries"

_STAGE_TIDS = {"sample": 1, "copy": 2, "convert": 3, "train": 4}


class Profiler:
    def __init__(self):
        self._step_items = collections.defaultdict(dict)  # key -> {item: val}
        self._epoch_items = collections.defaultdict(
            lambda: collections.defaultdict(float)
        )
        self._init_items = {}
        self._trace = []
        self._node_access = collections.Counter()
        self._log_node_access = (
            os.environ.get(C.ENV_LOG_NODE_ACCESS, "") not in ("", "0")
        )
        self._prev_access: set = set()
        self._similarity: list = []  # (num_accessed, overlap_with_prev)

    # --- step/epoch/init logging (reference Profiler::LogStep etc.) -------
    def log_step(self, epoch: int, step: int, item: str, value: float):
        self._step_items[(epoch, step)][item] = value

    def log_epoch_add(self, epoch: int, item: str, value: float):
        self._epoch_items[epoch][item] += value

    def log_init(self, item: str, value: float):
        self._init_items[item] = value

    # --- node-access analytics (reference Profiler::LogNodeAccess) --------
    def enable_node_access_log(self):
        """Turn on node-access analytics.  The multi-card engine reads the
        flag at each epoch's start, so it may be turned on after ``init``,
        on every rank alike (each step gathers the ranks' input nodes)."""
        self._log_node_access = True

    def node_access_frequency(self) -> list:
        """``(node, accesses)`` pairs, hottest first."""
        return self._node_access.most_common()

    def log_node_access(self, node_ids):
        """Count per-node accesses and per-step similarity with the
        previous step's accessed set (reference LogNodeAccess; similarity
        column of profiler.cc:784-789)."""
        if not self._log_node_access:
            return
        ids = node_ids.tolist()
        self._node_access.update(ids)
        cur = set(ids)
        overlap = len(cur & self._prev_access) if self._prev_access else 0
        self._similarity.append((len(cur), overlap))
        self._prev_access = cur

    def dump_node_access(self, path: str, in_degrees=None, out_degrees=None):
        """Per-node access log, hottest first: ``node access in_deg out_deg``
        (reference ofs0, profiler.cc:754-759)."""
        get = lambda d, n: int(d[n]) if d is not None else 0
        with open(path, "w") as f:
            for node, count in self._node_access.most_common():
                f.write(
                    f"{node} {count} {get(in_degrees, node)} "
                    f"{get(out_degrees, node)}\n"
                )

    def dump_node_access_frequency(self, path: str, num_node: int):
        """Frequency histogram with count/access prefix percentages —
        the optimal-cache-hit curve: the access%% prefix at a given count%%
        prefix is the best hit rate a cache of that size could achieve
        (reference ofs1, profiler.cc:761-782)."""
        freq_count = collections.Counter(self._node_access.values())
        access_sum = sum(self._node_access.values()) or 1
        count_prefix = access_prefix = 0.0
        with open(path, "w") as f:
            for freq, count in sorted(freq_count.items(), reverse=True):
                count_pct = count / max(num_node, 1)
                count_prefix += count_pct
                access = freq * count
                access_pct = access / access_sum
                access_prefix += access_pct
                f.write(
                    f"{freq} {count} {count_pct:.6f} {count_prefix:.6f} "
                    f"{access} {access_pct:.6f} {access_prefix:.6f}\n"
                )

    def optimal_cache_hit_rate(self, cache_percentage: float, num_node: int):
        """Best achievable hit rate caching the hottest
        ``cache_percentage`` of nodes (derived from the frequency curve)."""
        budget = int(num_node * cache_percentage)
        total = sum(self._node_access.values()) or 1
        hit = sum(c for _, c in self._node_access.most_common(budget))
        return hit / total

    def dump_node_access_similarity(self, path: str):
        """Per-step overlap with the previous step's accessed node set
        (reference ofs2, profiler.cc:784-789)."""
        with open(path, "w") as f:
            for i, (n, overlap) in enumerate(self._similarity):
                f.write(f"{i} {n} {overlap} {overlap / max(n, 1):.6f}\n")

    # --- memory accounting (reference LOG_MEM_USAGE, dist_engine.cc:54-67) -
    def log_mem_usage(self, tag: str, device=None):
        """Snapshot device memory at an init phase boundary, as init items
        ``mem:{tag}:{bytes_in_use,peak_bytes_in_use}`` (MB), from
        ``torch.cuda.memory_stats``; 0 on a device without them (the
        CPU)."""
        stats = {}
        if device is not None and torch.device(device).type == "cuda":
            stats = torch.cuda.memory_stats(device)
        mb = 1024 * 1024
        self.log_init(f"mem:{tag}:bytes_in_use",
                      stats.get("allocated_bytes.all.current", 0) / mb)
        self.log_init(f"mem:{tag}:peak_bytes_in_use",
                      stats.get("allocated_bytes.all.peak", 0) / mb)

    # --- trace events (reference TraceItem + DumpTrace) -------------------
    def trace_begin(self, epoch: int, step: int, stage: str):
        self._trace.append((stage, epoch, step, "B",
                            time.perf_counter_ns() // 1000))

    def trace_end(self, epoch: int, step: int, stage: str):
        self._trace.append((stage, epoch, step, "E",
                            time.perf_counter_ns() // 1000))

    def dump_trace(self, path: str):
        """Chrome trace-event JSON, one tid per pipeline stage
        (reference profiler.cc:349-380)."""
        events = [
            {
                "name": f"{stage} e{epoch}s{step}",
                "ph": ph,
                "ts": ts,
                "pid": 0,
                "tid": _STAGE_TIDS.get(stage, 9),
            }
            for stage, epoch, step, ph, ts in self._trace
        ]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    # --- reports ----------------------------------------------------------
    def _steps_after_warmup(self, item: str):
        vals = [
            v[item]
            for (epoch, _), v in self._step_items.items()
            if epoch > 0 and item in v
        ]
        return vals

    def step_average(self, item: str) -> Optional[float]:
        """Average excluding epoch 0 (warm-up skip, profiler.cc:302-327)."""
        vals = self._steps_after_warmup(item)
        return sum(vals) / len(vals) if vals else None

    def step_sum_per_epoch(self, item: str) -> Optional[float]:
        vals = self._steps_after_warmup(item)
        if not vals:
            return None
        epochs = {e for (e, _) in self._step_items.keys() if e > 0}
        return sum(vals) / max(len(epochs), 1)

    def epoch_average(self, item: str) -> Optional[float]:
        vals = [v[item] for e, v in self._epoch_items.items()
                if e > 0 and item in v]
        return sum(vals) / len(vals) if vals else None

    def test_results(self, extra: Optional[dict] = None) -> dict:
        """Emit the ``test_result:`` stdout protocol
        (reference train_gcn.py:316-347)."""
        out = {}
        for item, name in (
            (L1_SAMPLE_TIME, "epoch_time:sample_total"),
            (L1_COPY_TIME, "epoch_time:copy_time"),
            (L1_TRAIN_TIME, "epoch_time:train_total"),
            # convert_time (reference: COO→DGLBlock torch-view assembly,
            # train_gcn.py:222-231) is identically absent here by design:
            # dense fanout blocks feed the train step directly, so there
            # is no conversion stage to time.
            (L1_CONVERT_TIME, "epoch_time:convert_time"),
        ):
            v = self.step_sum_per_epoch(item)
            if v is not None:
                out[name] = v
        hit = self.step_average(L2_CACHE_HIT_RATE)
        if hit is not None:
            out["cache_hit_rate"] = hit
        nodes = self.step_sum_per_epoch(L1_NUM_NODE)
        if nodes is not None:
            out["epoch:sample_nodes"] = nodes
            # M sampled-nodes/s (reference train_gcn.py:353-356)
            st = out.get("epoch_time:sample_total")
            if st:
                out["epoch:sample_thpt"] = nodes / st / 1e6
        times = [
            out.get(k, 0.0)
            for k in ("epoch_time:sample_total", "epoch_time:copy_time",
                      "epoch_time:train_total")
        ]
        total = sum(times)
        if total == 0.0:
            # device_loop epochs (one replayed graph a step) have no
            # per-stage splits: report the measured wall epoch time instead
            total = self.epoch_average("epoch_time") or 0.0
        out["epoch_time:total"] = total
        if extra:
            out.update(extra)
        for k, v in out.items():
            if isinstance(v, float):
                print(f"test_result:{k}={v:.6f}")
            else:
                print(f"test_result:{k}={v}")
        return out
