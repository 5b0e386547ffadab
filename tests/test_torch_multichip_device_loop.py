"""The collocated multi-card engine's sanity check, node-access log and
``device_loop`` against the JAX package.

JAX's multi-card steps max-reduce ``sanity.check_batch``'s flags over the
chips and its engine raises ``sanity check failed: [...]`` once an epoch
(``tests/test_parallel.py:371``); its node-access mode logs every chip's
input nodes (``:354``, ``:642``); its ``device_loop`` scans the fused step
and matches the host loop, and replays an overflowed step (``:328``,
``:829``).  Here ``MultiChipEngine`` runs at P = 2 over gloo ranks (one
spawn, ``tests/torch_device_loop_ranks.py``) and at P = 1 in this process:
the frequencies logged on rank 0 equal the JAX engine's over two chips for
the same seed shards (every fanout at least the largest degree, so the
sampled frontiers are the whole 2-hop closures, whichever the draws), a
batch corrupted on one rank raises JAX's message on every rank in the
fused host loop, under ``device_loop`` and in the two-phase store, and
``device_loop``'s per-step losses and accuracies equal the host loop's bit
for bit over two epochs, with an overflow replayed.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.config import RunConfig as JRunConfig  # noqa: E402

import torch_device_loop_ranks as ranks  # noqa: E402
from xgnn_tpu_torch import RunConfig  # noqa: E402
from xgnn_tpu_torch.dataset import Dataset  # noqa: E402
from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine  # noqa: E402
from xgnn_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SPAWN_S = 150  # the spawn's time limit
EPOCHS = 2
# the node-access runs: every fanout at least the sparse graph's largest
# degree, no calibration and no overflow
ACCESS = dict(model="graphsage", batch_size=40, fanout=(20, 20),
              num_layer=2, num_hidden=8, lr=0.01, use_dist_graph=True,
              part_cache=True, calibration_batches=0, dropout=0.0)


def _arrays(ds):
    return {k: getattr(ds, k) for k in (
        "name", "num_node", "num_edge", "feat_dim", "num_class", "indptr",
        "indices", "feat", "label", "train_set", "valid_set", "test_set")}


def _config(num_worker, **kw):
    cfg = dict(model="graphsage", batch_size=96, fanout=(4, 3),
               num_layer=2, num_hidden=16, lr=0.01, num_worker=num_worker,
               arch="arch6", use_dist_graph=True, part_cache=True,
               calibration_batches=2, dropout=0.5, seed=11)
    cfg.update(kw)
    return cfg


def _jax_steps(train_set, batch_size, num_parts, seed):
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler

    return max(JShuffler(np.asarray(train_set), batch_size,
                         num_worker=num_parts, worker_id=w,
                         seed=seed + 1).num_local_step
               for w in range(num_parts))


@pytest.fixture(scope="module")
def graph():
    return jsyn.make_synthetic_dataset(num_node=600, avg_degree=6,
                                       feat_dim=12, num_class=5, seed=4,
                                       planted_signal=2.0, train_frac=0.4)


@pytest.fixture(scope="module")
def sparse():
    ds = jsyn.make_synthetic_dataset(num_node=300, avg_degree=3, feat_dim=8,
                                     num_class=4, seed=3, power_law=False,
                                     train_frac=0.5)
    assert np.diff(ds.indptr).max() <= min(ACCESS["fanout"])
    return ds


@pytest.fixture(scope="module")
def two_ranks(graph, sparse):
    return pmesh.spawn(ranks.faults_run, 2, _arrays(graph), _config(2),
                       dict(ACCESS, num_worker=2), _arrays(sparse), EPOCHS,
                       device="cpu", timeout=SPAWN_S)


def test_node_access_log_over_two_ranks_equals_jax(sparse, two_ranks,
                                                   monkeypatch):
    """Rank 0 logs every rank's input nodes: the frequencies of one epoch
    equal the JAX engine's over two chips (the fused store built in
    logging mode, as JAX needs), for the fused store and the two-phase
    one; rank 1 logs nothing."""
    from xgnn_tpu.engine.multi_engine import MultiChipEngine as JEngine

    monkeypatch.setenv("XGNN_LOG_NODE_ACCESS", "1")
    jeng = JEngine(sparse, JRunConfig(**ACCESS, num_worker=2,
                                      cache_percentage=1.0, num_epoch=1,
                                      root_path="/tmp")).init()
    r = jeng.train_epoch(0)
    assert r["contributed_steps"] == r["steps"]
    want = dict(jeng.profiler.node_access_frequency())
    assert sum(want.values()) > len(want) > 0
    for shape in ("fused", "two_phase"):
        assert two_ranks[0]["frequency"][shape] == want, shape
        assert two_ranks[1]["frequency"][shape] == {}, shape


def test_sanity_check_over_two_ranks_raises_jax_message(two_ranks):
    """Clean batches pass (the device_loop runs checked every step); a
    duplicate input node on rank 1 raises JAX's message on both ranks, in
    the fused host loop, under device_loop and in the two-phase store."""
    from xgnn_tpu.ops import sanity as jsanity

    want = f"sanity check failed: {jsanity.explain(1)}"
    for o in two_ranks:
        assert o["raised"] == {"fused": want, "device_loop": want,
                               "two_phase": want}


def test_device_loop_over_two_ranks_equals_the_host_loop(graph, two_ranks):
    """JAX's step count; each step's loss and accuracy bit-equal to the
    host loop's over two epochs at dropout 0.5, and the parameters after
    them equal, on both ranks."""
    steps = _jax_steps(graph.train_set, 96, 2, 11)
    for o in two_ranks:
        host, dev = o["history"][False], o["history"][True]
        assert dev["fused"] and not host["fused"]
        assert [r["steps"] for r in dev["results"]] == [steps] * EPOCHS
        for e in range(EPOCHS):
            assert np.all(np.isfinite(dev["loss"][e]))
            np.testing.assert_array_equal(dev["loss"][e], host["loss"][e])
            np.testing.assert_array_equal(dev["acc"][e], host["acc"][e])
        for name, v in dev["params"].items():
            np.testing.assert_array_equal(v, host["params"][name])
            np.testing.assert_array_equal(
                v, two_ranks[0]["history"][True]["params"][name])


def test_device_loop_over_two_ranks_replays_overflowed_steps(two_ranks):
    """Tiny capacities overflow under device_loop: the steps are skipped
    on the device, the capacities grow and the host loop replays them, no
    step lost; the next epoch captures again."""
    for o in two_ranks:
        r = o["overflow"]["result"]
        assert r["contributed_steps"] == r["steps"], r
        assert np.isfinite(r["loss"])
        assert o["overflow"]["caps"][-1] > 256
        assert o["overflow"]["dropped"] and o["overflow"]["again"]
        assert np.isfinite(o["overflow"]["next"]["loss"])


def test_device_loop_at_p1_equals_the_host_loop_and_replays(graph, caplog):
    """At P = 1 (a world of one in this process): the losses bit-equal to
    the host loop's over two epochs; an overflow under device_loop
    replayed with no step lost; the two-phase store and the node-access
    log fall back to the host loop with the single engine's warning,
    once."""
    ds = Dataset(**_arrays(graph))
    hist = {}
    for device_loop in (False, True):
        eng = MultiChipEngine(ds, RunConfig(**_config(
            1, device_loop=device_loop)), device="cpu").init()
        try:
            rs = [eng.train_epoch(e) for e in range(EPOCHS)]
            assert rs[0]["steps"] == _jax_steps(ds.train_set, 96, 1, 11)
            hist[device_loop] = [eng.history[e]["loss"]
                                 for e in range(EPOCHS)]
            assert (eng._fused is not None) == device_loop
        finally:
            eng.close()
    for e in range(EPOCHS):
        np.testing.assert_array_equal(hist[True][e], hist[False][e])
    eng = MultiChipEngine(ds, RunConfig(**_config(
        1, device_loop=True, frontier_capacities=[96, 128, 256],
        calibration_batches=0, exchange_headroom=0.05)), device="cpu").init()
    try:
        r = eng.train_epoch(0)
        assert r["contributed_steps"] == r["steps"] and eng._fused is None
        assert eng.capacities[-1] > 256
    finally:
        eng.close()
    for change in (dict(cache_percentage=0.3, cache_policy="degree"),
                   dict(node_access=True)):
        access = change.pop("node_access", False)
        eng = MultiChipEngine(ds, RunConfig(**_config(1, device_loop=True,
                                                      **change)),
                              device="cpu").init()
        try:
            if access:
                eng.profiler.enable_node_access_log()
            caplog.clear()
            with caplog.at_level(logging.WARNING):
                for e in range(2):
                    assert np.isfinite(eng.train_epoch(e)["loss"])
            warned = [r for r in caplog.records
                      if "device_loop requested but ineligible" in
                      r.getMessage()]
            assert len(warned) == 1 and eng._fused is None
        finally:
            eng.close()
