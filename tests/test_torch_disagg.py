"""The disaggregated engine (XGNN's arch5) against the JAX package.

``make_disagg_train_step`` at two trainers against JAX's over a 2-device
trainer mesh (``xgnn_tpu/parallel/disaggregated.py:143-204``): the same
batches (sampled by the port, packed as JAX's ``pack_batch`` packs them),
input rows, labels and flax weights at dropout 0, the seed-weighted
reduction with an empty shard weighing nothing; the per-trainer seed
shards of an epoch against JAX's ``work()``; and ``DisaggregatedEngine``
on the CPU as JAX's tests drive it (``tests/test_disaggregated.py``,
``test_engine_e2e.py:435``, ``test_checkpoint.py:65``): 2 + 2 roles
learning with a trainer-side cache, one device shared by both roles,
overflow growth, the presample cache, the sampler tier, the re-roles and
a checkpoint resume.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.config import RunConfig as JRunConfig  # noqa: E402
from xgnn_tpu.constants import EMPTY_KEY as EMPTY  # noqa: E402

from xgnn_tpu_torch import RunConfig  # noqa: E402
from xgnn_tpu_torch.engine.disagg_engine import (  # noqa: E402
    DisaggregatedEngine,
)

BASE = dict(batch_size=64, fanout=(4, 3), num_layer=2, num_hidden=16,
            model="graphsage", sample_type="khop3", lr=0.01,
            arch="disaggregated")


@pytest.fixture(scope="module")
def learn_ds():
    return jsyn.make_synthetic_dataset(num_node=3000, avg_degree=8,
                                       feat_dim=32, num_class=6, seed=2,
                                       planted_signal=2.0, train_frac=0.3)


def _engine(ds, devices=None, **kw):
    cfg = RunConfig(**dict(BASE, **kw))
    return DisaggregatedEngine(ds, cfg, devices=devices,
                               device=None if devices else "cpu").init()


def _pack(batch, x, labels):
    """A port batch as JAX's ``pack_batch`` packs it, with ``x`` and the
    labels, numpy."""
    out = {"input_nodes": batch.input_nodes.numpy(),
           "num_input": batch.num_input.numpy().reshape(1),
           "output_nodes": batch.output_nodes.numpy(),
           "num_output": batch.num_output.numpy().reshape(1),
           "overflow": batch.overflow.numpy().reshape(1)}
    for i, b in enumerate(batch.blocks):
        out[f"neigh{i}"] = b.neigh.numpy()
        out[f"ndst{i}"] = b.num_dst.numpy().reshape(1)
        out[f"nsrc{i}"] = b.num_src.numpy().reshape(1)
    return out, x.numpy(), labels.numpy()


@pytest.mark.parametrize("empty", [False, True],
                         ids=["two_shards", "empty_shard"])
def test_disagg_train_step_matches_jax(learn_ds, empty):
    """The port's step over two trainer replicas against JAX's over a
    2-device trainer mesh: loss and accuracy within 1e-6, the parameters
    after the update within 1e-5 where Adam's first step moved them by
    the learning rate (where |g| is about eps the gradients' last bits
    decide the step), the replicas bit-equal.  Trainer 1's shard is
    smaller, or empty: JAX weighs it by its seed count, 0."""
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu.parallel.collocated import put_replicated, put_sharded
    from xgnn_tpu.parallel.disaggregated import (
        make_disagg_train_step as jax_step,
    )
    from xgnn_tpu.parallel.mesh import make_mesh as jax_mesh
    from xgnn_tpu.train import TrainState, make_optimizer
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.parallel.disaggregated import (
        batch_to_shard,
        make_disagg_train_step,
    )
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.store.feature_store import (
        HBMFeatureSource,
        LabelSource,
    )
    from xgnn_tpu_torch.types import Graph

    ds = learn_ds
    cfg = RunConfig(**dict(BASE, dropout=0.0))
    graph = Graph.from_dataset(ds, "cpu")
    sampler = Sampler(graph, cfg)
    feat = HBMFeatureSource(ds.feat, "cpu")
    lab = LabelSource(ds.label, "cpu")
    shards, packed = [], []
    for t, n in enumerate((64, 0 if empty else 37)):
        seeds = np.full(64, EMPTY, np.int32)
        seeds[:n] = ds.train_set[t * 64:t * 64 + n]
        batch = sampler.sample(torch.from_numpy(seeds), n,
                               torch.Generator().manual_seed(5 + t))
        x, _ = feat.extract(batch.input_nodes, batch.num_input)
        labels = lab.extract(batch.output_nodes, batch.num_output)
        shards.append(batch_to_shard(batch, x, labels))
        packed.append(_pack(batch, x, labels))

    model = JGNN(conv="graphsage", hidden_dim=16, out_dim=ds.num_class,
                 num_layers=2, dropout=0.0)
    blocks = [JBlock(neigh=jnp.asarray(packed[0][0][f"neigh{i}"]),
                     num_dst=jnp.int32(packed[0][0][f"ndst{i}"][0]),
                     num_src=jnp.int32(packed[0][0][f"nsrc{i}"][0]))
              for i in range(2)]
    params = model.init({"params": jax.random.key(3)}, blocks,
                        jnp.asarray(packed[0][1]), False)["params"]
    # the step donates the state: keep the weights on the host
    params_np = jax.tree.map(np.asarray, params)
    jcfg = JRunConfig(**dict(BASE, dropout=0.0, root_path="/tmp"))
    tx = make_optimizer(jcfg)
    mesh = jax_mesh(devices=jax.devices()[:2])
    state = put_replicated(TrainState(params=params,
                                      opt_state=tx.init(params),
                                      step=jnp.zeros((), jnp.int32)), mesh)
    cat = lambda i: np.concatenate([p[i] for p in packed])
    stitched = {k: put_sharded(np.concatenate([p[0][k] for p in packed]),
                               mesh) for k in packed[0][0]}
    dkeys = put_sharded(np.asarray(jax.random.key_data(
        jax.random.split(jax.random.key(9), 2))), mesh)
    new_state, jm = jax_step(model, jcfg, mesh)(
        state, stitched, put_sharded(cat(1), mesh),
        put_sharded(cat(2), mesh), dkeys)
    want = params_from_flax(jax.tree.map(np.asarray, new_state.params))
    step0 = params_from_flax(jax.tree.map(
        lambda a, b: np.asarray(a) - b, new_state.params, params_np))

    from xgnn_tpu_torch.train import Adam

    models, opts = [], []
    for _ in range(2):
        m = build_model(cfg, ds.feat_dim, ds.num_class)
        m.load_state_dict(params_from_flax(params_np))
        models.append(m)
        opts.append(Adam(list(m.parameters()), cfg.lr))
    got = make_disagg_train_step(models, opts)(shards, [None, None])
    assert not bool(got["overflow"]) and not bool(jm["exchange_overflow"])
    np.testing.assert_allclose(float(got["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got["acc"]), float(jm["acc"]),
                               rtol=1e-6, atol=1e-7)
    firm_total = 0
    for name, v in models[0].state_dict().items():
        # Adam's first step moves a weight by lr * |g| / (|g| + eps): by
        # lr where |g| is well above eps, by a part of it that the
        # gradients' last bits decide where |g| is about eps
        firm = np.abs(step0[name].numpy()) > 0.999 * cfg.lr
        firm_total += firm.mean() / len(want)
        np.testing.assert_allclose(v.numpy()[firm],
                                   want[name].numpy()[firm], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        # the replicas stay bit-equal
        assert torch.equal(v, models[1].state_dict()[name]), name
    assert firm_total > 0.5


def test_epoch_shards_equal_jax_work(learn_ds):
    """Each step's per-trainer seeds and counts of an epoch equal what
    JAX's ``train_epoch`` ``work()`` gives its trainers (an exhausted
    trainer an EMPTY shard of count 0: 610 nodes over 3 trainers in
    batches of 203 give the last trainer one step of the two)."""
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler

    nodes, bs = np.asarray(learn_ds.train_set[:610]), 203
    eng = DisaggregatedEngine(learn_ds, RunConfig(**dict(
        BASE, batch_size=bs, num_sample_worker=1, num_train_worker=3)),
        device="cpu")
    for epoch in (0, 1):
        num_steps, steps = eng.epoch_shards(nodes, 43, epoch)
        js = [JShuffler(nodes, bs, num_worker=3, worker_id=t, seed=43)
              for t in range(3)]
        assert num_steps == max(s.num_local_step for s in js) == 2
        assert js[-1].num_local_step == 1
        its = [s.epoch_batches(epoch) for s in js]
        for shards in steps:
            for (seeds, n), it in zip(shards, its):
                want = next(it, (np.full(bs, EMPTY, np.int32), 0))
                np.testing.assert_array_equal(seeds, want[0])
                assert n == want[1]


def test_disagg_engine_2x2_learns(learn_ds):
    """2 samplers feed 2 trainers, each with a tiered cache (degree, 0.3;
    K11's plain version here), pipelined: the loss falls, the accuracy is
    real, the replicas stay equal."""
    eng = _engine(learn_ds, num_hidden=32, num_sample_worker=2,
                  num_train_worker=2, cache_percentage=0.3,
                  cache_policy="degree", pipeline=True)
    try:
        assert len(eng.feature_sources) == 2
        assert len(eng.svc.samplers) == 2
        losses = [eng.train_epoch(e)["loss"] for e in range(3)]
        assert all(np.isfinite(v) for v in losses)
        assert losses[-1] < losses[0] * 0.9, losses
        assert 0.0 < eng.history[2]["hit_rate"] < 1.0
        acc = eng.evaluate("valid", max_batches=2)
        assert np.isfinite(acc) and acc > 0.0
        for name, v in eng.models[0].state_dict().items():
            assert torch.equal(v, eng.models[1].state_dict()[name]), name
    finally:
        eng.close()


def test_disagg_role_degenerate_one_device(learn_ds):
    """1 sampler + 1 trainer sharing one device (the one-card benchmark
    shape): the handoff is a no-op, and it learns."""
    eng = _engine(learn_ds, devices=["cpu"], num_sample_worker=1,
                  num_train_worker=1, pipeline=True)
    try:
        assert eng.sample_devices[0] is eng.train_devices[0]
        losses = [eng.train_epoch(e)["loss"] for e in range(2)]
        assert all(np.isfinite(v) for v in losses)
        assert losses[-1] < losses[0]
        assert np.isfinite(eng.evaluate("valid", max_batches=2))
    finally:
        eng.close()


def test_disagg_overflow_grows_and_presample_cache(learn_ds):
    """Capacities far below the frontier overflow: the steps are skipped
    and the samplers grow for the next epoch; and the pre_sample cache
    presamples on sampler 0."""
    eng = _engine(learn_ds, num_sample_worker=1, num_train_worker=1,
                  pipeline=False, frontier_capacities=(64, 128, 128))
    try:
        eng.train_epoch(0)
        assert eng.history[0]["overflow"].sum() > 0
        assert eng.svc.capacities[-1] > 128
        assert np.isfinite(eng.train_epoch(1)["loss"])
    finally:
        eng.close()
    eng = _engine(learn_ds, num_sample_worker=1, num_train_worker=1,
                  pipeline=False, cache_percentage=0.2,
                  cache_policy="pre_sample", presample_epoch=1)
    try:
        assert eng._ranking is not None
        r = eng.train_epoch(0)
        assert np.isfinite(r["loss"]) and 0.0 < r["hit_rate"] < 1.0
    finally:
        eng.close()


def test_disagg_sampler_tier(learn_ds):
    """The samplers hold only the hot prefix (0.5 of the edges) and read
    the rest from the mapped host CSR."""
    eng = _engine(learn_ds, num_sample_worker=2, num_train_worker=2,
                  use_dist_graph=True, dist_graph_percentage=0.5,
                  pipeline=False)
    try:
        for s in eng.svc.samplers:
            assert s.tier is not None
            assert s.graph.num_node < learn_ds.num_node
        assert np.isfinite(eng.train_epoch(0)["loss"])
    finally:
        eng.close()


def test_disagg_rerole_keeps_state(learn_ds):
    """``_rebalance(1, 3)`` then ``(3, 1)``: the stores and samplers follow
    the new roles, Adam's count and the weights carry over."""
    eng = _engine(learn_ds, num_sample_worker=2, num_train_worker=2,
                  pipeline=False, balance_switcher=True)
    try:
        eng.train_epoch(0)
        count = int(eng.opts[0].count)
        before = {k: v.clone() for k, v in eng.models[0].state_dict().items()}
        eng._rebalance(1, 3)
        assert len(eng.feature_sources) == 3 and len(eng.svc.devices) == 1
        assert all(int(o.count) == count for o in eng.opts)
        for k, v in eng.models[2].state_dict().items():
            assert torch.equal(v, before[k]), k
        assert np.isfinite(eng.train_epoch(1)["loss"])
        eng._rebalance(3, 1)
        assert len(eng.feature_sources) == 1 and len(eng.svc.samplers) == 3
        assert np.isfinite(eng.train_epoch(2)["loss"])
    finally:
        eng.close()


def test_disagg_checkpoint_resume(learn_ds, tmp_path):
    """run() with checkpoints, then a longer run resumes at the next
    epoch only."""
    common = dict(num_sample_worker=1, num_train_worker=1, pipeline=False,
                  checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=1)
    e1 = DisaggregatedEngine(learn_ds, RunConfig(**dict(BASE, num_epoch=2,
                                                        **common)),
                             device="cpu")
    try:
        assert len(e1.run()["epochs"]) == 2
    finally:
        e1.close()
    e2 = DisaggregatedEngine(learn_ds, RunConfig(**dict(BASE, num_epoch=3,
                                                        **common)),
                             device="cpu")
    try:
        r2 = e2.run()
    finally:
        e2.close()
    assert [r["epoch"] for r in r2["epochs"]] == [2]
    assert np.isfinite(r2["epochs"][0]["loss"])
    assert int(e2.opts[0].count) == 3 * e2.history[2]["loss"].size
