"""Frequency-based cache rankings by presampling.

The port of ``xgnn_tpu/store/presample.py``: run ``presample_epoch``
epochs of the real sampler and count each node's accesses (K12 over each
batch's input nodes), or, for ``presample_static``, count the exact
all-neighbour closure of each batch's seeds (K12b).  The counts stay on the
device until the one pull at the end.  The port's generators draw the
batches (``seed_of(seed, ...)``, as ``Engine._calibrate`` does), so the
presample counts differ from the JAX package's for a seed; the static
closure is deterministic and equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import SampleType
from ..device import generator, seed_of
from ..engine.shuffler import Shuffler
from ..ops.presample import accumulate_freq, closure_expand

_PRESAMPLE = 0x5EED  # the stream tag of the presample batches


def static_presample_config(cfg):
    """``presample_static`` on a tiered topology presamples with a wide
    khop0 (every neighbour of a node of degree <= the fanout) instead of
    the configured sampler."""
    return dataclasses.replace(
        cfg,
        sample_type=SampleType.KHOP0,
        fanout=(cfg.presample_static_fanout,) * len(cfg.fanout),
        frontier_capacities=None,
    )


def _to(device, seeds: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(seeds)
    return t.to(device) if device.type != "cuda" else \
        t.pin_memory().to(device, non_blocking=True)


def static_exact_ranking(graph, train_set, config, num_node: int,
                         device) -> np.ndarray:
    """Per batch, the nodes within ``len(config.fanout)`` hops of the seeds
    (every neighbour), each counted once a batch, over
    ``presample_epoch`` epochs: a host array of counts."""
    device = torch.device(device)
    counts = torch.zeros(num_node, dtype=torch.int32, device=device)
    shuffler = Shuffler(train_set, config.batch_size, seed=config.seed,
                        num_worker=1)
    for epoch in range(config.presample_epoch):
        for seeds, num_valid in shuffler.epoch_batches(epoch):
            closure_expand(graph.indptr, graph.indices,
                           _to(device, seeds[:num_valid]),
                           len(config.fanout), counts)
    return counts.cpu().numpy()


def presample_ranking(sampler, train_set, config, num_node: int, device,
                      halves: bool = False):
    """Per-node access counts of ``presample_epoch`` epochs of ``sampler``
    (a host array).  ``halves=True`` also returns the counts of the even
    and of the odd batches, ``(freq, freq_a, freq_b)``: ranking by one and
    scoring the other estimates a ranking's out-of-sample hit rate."""
    device = torch.device(device)
    freq_a = torch.zeros(num_node, dtype=torch.int32, device=device)
    freq_b = torch.zeros(num_node, dtype=torch.int32, device=device)
    shuffler = Shuffler(train_set, config.batch_size, seed=config.seed,
                        num_worker=1)
    i = 0
    for epoch in range(config.presample_epoch):
        for seeds, num_valid in shuffler.epoch_batches(epoch):
            gen = generator(device, seed_of(config.seed, _PRESAMPLE, epoch, i))
            batch = sampler.sample(_to(device, seeds), num_valid, gen)
            accumulate_freq(freq_a if i % 2 == 0 else freq_b,
                            batch.input_nodes, batch.num_input)
            i += 1
    fa, fb = freq_a.cpu().numpy(), freq_b.cpu().numpy()
    freq = fa + fb
    if halves:
        return freq, fa, fb
    return freq
