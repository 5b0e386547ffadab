"""Epoch and step batch generation.

A copy of ``xgnn_tpu/engine/shuffler.py``: for the same seed it yields the
same batches.  One deterministic permutation per (seed, epoch) is sliced
into per-worker shards.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C


class Shuffler:
    def __init__(
        self,
        train_set: np.ndarray,
        batch_size: int,
        num_worker: int = 1,
        worker_id: int = 0,
        seed: int = 42,
        drop_last: bool = False,
    ):
        self.train_set = np.asarray(train_set, dtype=C.ID_DTYPE)
        self.batch_size = batch_size
        self.num_worker = num_worker
        self.worker_id = worker_id
        self.seed = seed
        self.drop_last = drop_last

        n = len(self.train_set)
        shard = int(np.ceil(n / num_worker))
        self._shard_size = max(0, min(shard, n - worker_id * shard))
        if drop_last:
            self.num_local_step = self._shard_size // batch_size
        else:
            self.num_local_step = int(np.ceil(self._shard_size / batch_size))
        first_shard = min(shard, n)
        self.num_global_step = (
            first_shard // batch_size
            if drop_last
            else int(np.ceil(first_shard / batch_size))
        )

    def epoch_batches(self, epoch: int):
        """Yield ``(padded_seeds, num_valid)`` for this worker's shard."""
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(len(self.train_set))
        shard = int(np.ceil(len(perm) / self.num_worker))
        lo = self.worker_id * shard
        local = self.train_set[perm[lo: lo + shard]]
        for s in range(self.num_local_step):
            chunk = local[s * self.batch_size: (s + 1) * self.batch_size]
            seeds = np.full(self.batch_size, C.EMPTY_KEY, C.ID_DTYPE)
            seeds[: len(chunk)] = chunk
            yield seeds, len(chunk)
