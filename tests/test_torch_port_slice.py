"""The port's main path as a whole against the JAX package, on the CPU.

Sampler blocks are held equal to the JAX sampler's for the same uniforms,
and a 20+ step training trajectory (sampler, converted initial weights,
loss, Adam) is held to the JAX ``Engine``'s losses step by step.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu_torch.dataset import Dataset  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer_uniforms(key, frontier_lens, fanouts, walk=None):
    """The uniforms the JAX ``_sample_minibatch`` draws for each layer:
    ``key, k = split(key)``, then ``uniform(k, (frontier_len, K))``, or
    with ``walk = (num_walk, walk_len)`` the walk's from ``k``."""
    us = []
    for b, k_fan in zip(frontier_lens, fanouts):
        key, k = jax.random.split(key)
        us.append(_t(jax.random.uniform(k, (b, k_fan))) if walk is None
                  else _walk_uniforms(k, b, *walk))
    return us


def _walk_uniforms(key, num_rows, num_walk, walk_len):
    """``(u_step, u_restart)`` as ``sample_random_walk`` draws them: at each
    step ``key, k_step, k_restart = split(key, 3)``, a step draw and, past
    step 0, a restart draw, each ``(num_rows, num_walk)``; ``u_restart[0]``
    is never read."""
    u_step, u_restart = [], []
    for s in range(walk_len):
        key, k_step, k_restart = jax.random.split(key, 3)
        u_step.append(np.asarray(jax.random.uniform(k_step,
                                                    (num_rows, num_walk))))
        u_restart.append(
            np.asarray(jax.random.uniform(k_restart, (num_rows, num_walk)))
            if s else np.ones((num_rows, num_walk), np.float32))
    return _t(np.stack(u_step)), _t(np.stack(u_restart))


def _assert_same_batch(port, ref):
    assert len(port.blocks) == len(ref.blocks)
    for pb, rb in zip(port.blocks, ref.blocks):
        np.testing.assert_array_equal(pb.neigh.numpy(), np.asarray(rb.neigh))
        if rb.weights is None:
            assert pb.weights is None
        else:
            np.testing.assert_array_equal(pb.weights.numpy(),
                                          np.asarray(rb.weights))
        assert int(pb.num_src) == int(rb.num_src)
        assert int(pb.num_dst) == int(rb.num_dst)
        if rb.dst_ids is None:
            assert pb.dst_ids is None
        else:
            np.testing.assert_array_equal(pb.dst_ids.numpy(),
                                          np.asarray(rb.dst_ids))
    np.testing.assert_array_equal(port.input_nodes.numpy(),
                                  np.asarray(ref.input_nodes))
    assert int(port.num_input) == int(ref.num_input)
    assert bool(port.overflow) == bool(ref.overflow)


@pytest.mark.parametrize("direct,caps", [
    (True, None),
    (False, None),
    (True, (48, 160, 512, 1024)),  # layer 1 overflows its capacity
])
def test_sample_minibatch_matches_jax(small_ds, direct, caps):
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.sampler import Sampler as JSampler
    from xgnn_tpu.types import Graph as JGraph
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.types import Graph

    fanout = (5, 4, 3)
    jcfg = JConfig(batch_size=48, fanout=fanout, frontier_capacities=caps)
    jsampler = JSampler(JGraph.from_dataset(small_ds), jcfg,
                        direct_extract=direct)
    sampler = Sampler(Graph.from_dataset(small_ds, "cpu"),
                      RunConfig(batch_size=48, fanout=fanout,
                                frontier_capacities=caps),
                      direct_extract=direct)
    assert sampler.capacities == jsampler.capacities
    seeds = np.full(48, np.iinfo(np.int32).max, np.int32)
    seeds[:40] = small_ds.train_set[:40]
    key = jax.random.key(11)
    ref = jsampler.sample(jnp.asarray(seeds), 40, key)
    us = _layer_uniforms(key, [48] + sampler.capacities[1:-1], fanout)
    port = sampler.sample(_t(seeds), 40, u=us)
    _assert_same_batch(port, ref)
    assert bool(port.overflow) == (caps is not None)


@pytest.mark.parametrize("model,heads,sample_type", [
    pytest.param("graphsage", 1, "khop3", id="graphsage-1"),
    pytest.param("gcn", 1, "khop3", id="gcn-1"),
    pytest.param("gat", 1, "khop3", id="gat-1"),
    pytest.param("gat", 2, "khop3", id="gat-2"),
    pytest.param("pinsage", 1, "random_walk", id="pinsage-1"),
    pytest.param("mlp", 1, "khop3", id="mlp-1"),
    pytest.param("graphsage", 1, "khop1", id="graphsage-1-khop1"),
    pytest.param("graphsage", 1, "weighted_khop_prefix",
                 id="graphsage-1-weighted_khop_prefix"),
])
def test_training_trajectory_matches_jax_engine(learn_ds, model, heads,
                                                sample_type):
    """>= 20 steps of the JAX Engine (direct extract, pipeline off) against
    the port's sampler (same uniforms), model (converted initial weights),
    loss and Adam: blocks (and the walk's weights) equal every step, losses
    close step by step (rtol/atol 2e-3: float32 sums in other orders,
    compounded over the steps' updates).  PinSAGE samples two walk layers
    of 5 picks (W=4, L=3, p=0.5).  The weighted sampler reads the JAX
    package's tables, built on a copy of the dataset."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.engine import Engine as JEngine
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.store import HBMFeatureSource, LabelSource
    from xgnn_tpu_torch.train import Adam, train_step
    from xgnn_tpu_torch.types import Graph

    ds = learn_ds
    weighted = sample_type.startswith("weighted")
    if weighted:
        from xgnn_tpu import synthetic as jsyn

        ds = copy.copy(learn_ds)
        jsyn.build_alias_tables(ds, seed=3)
    fanout = (5, 4, 3)
    common = dict(batch_size=len(ds.train_set) // 21, fanout=fanout,
                  num_layer=3, num_hidden=16, model=model, num_head=heads,
                  sample_type=sample_type, dropout=0.0,
                  lr=0.01, pipeline=False, gpu_extract=True,
                  cache_percentage=0.0)
    engine = JEngine(ds, JConfig(**common, num_epoch=1)).init()
    params_np = jax.tree.map(np.asarray, engine.state.params)

    cfg = RunConfig(**common, frontier_capacities=engine.sampler.capacities)
    sampler = Sampler(Graph.from_dataset(ds, "cpu", weighted=weighted), cfg,
                      direct_extract=True)
    feat = HBMFeatureSource(ds.feat, "cpu")
    labels_src = LabelSource(ds.label, "cpu")
    model = build_model(cfg, ds.feat_dim, ds.num_class)
    model.load_state_dict(params_from_flax(params_np))
    opt = Adam(list(model.parameters()), cfg.lr)

    walk = ((cfg.num_random_walk, cfg.random_walk_length)
            if sample_type == "random_walk" else None)
    shuffler = JShuffler(ds.train_set, cfg.batch_size, seed=cfg.seed + 1)
    sample_base = jax.random.fold_in(engine._sample_key, 0)
    drop_base = jax.random.fold_in(engine._dropout_key, 0)
    state = engine.state
    jax_losses, port_losses = [], []
    for step, (seeds, n) in enumerate(shuffler.epoch_batches(0)):
        key = jax.random.fold_in(sample_base, step)
        batch, x, labels, _, _ = engine._produce(((seeds, n), key, (0, step)))
        state, metrics = engine._train_step(
            state, batch.blocks, x, labels, batch.num_output,
            jax.random.fold_in(drop_base, step), batch.overflow,
        )
        jax_losses.append(metrics["loss"])

        us = _layer_uniforms(key, [len(seeds)] + sampler.capacities[1:-1],
                             sampler.fanouts, walk)
        pbatch = sampler.sample(_t(seeds), n, u=us)
        _assert_same_batch(pbatch, batch)
        plabels = labels_src.extract(pbatch.output_nodes, pbatch.num_output)
        np.testing.assert_array_equal(plabels.numpy()[:n],
                                      np.asarray(labels)[:n])
        m = train_step(model, opt, pbatch.blocks, feat.feat, plabels,
                       pbatch.num_output, None, pbatch.overflow)
        port_losses.append(float(m["loss"]))
    jax_losses = np.asarray(jnp.stack(jax_losses))
    assert len(port_losses) >= 20
    assert np.isfinite(jax_losses).all()
    assert jax_losses[-1] < jax_losses[0] * 0.9  # it really learns
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("pipeline,direct", [
    (True, True), (False, True),
    (True, False),  # local-id blocks: features extracted through K1
])
def test_port_engine_learns_on_cpu(learn_ds, pipeline, direct):
    from xgnn_tpu_torch import Engine, RunConfig

    cfg = RunConfig(batch_size=64, fanout=(5, 4, 3), num_hidden=16, lr=0.01,
                    pipeline=pipeline, calibration_batches=2,
                    gpu_extract=direct)
    engine = Engine(Dataset.from_arrays(learn_ds), cfg, device="cpu").init()
    results = [engine.train_epoch(e) for e in range(3)]
    losses = [r["loss"] for r in results]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert set(results[0]) == {"epoch", "loss", "train_acc", "time",
                               "hit_rate"}
    hist = engine.history[2]
    assert len(hist["loss"]) == len(hist["stages"]["train"]) > 1
    # a step is NaN exactly where it overflowed and was skipped
    np.testing.assert_array_equal(np.isnan(hist["loss"]),
                                  hist["overflow"] > 0)


def test_pipelined_and_serial_epochs_agree(learn_ds):
    from xgnn_tpu_torch import Engine, RunConfig

    runs = []
    for pipeline in (True, False):
        cfg = RunConfig(batch_size=128, fanout=(4, 3), num_layer=2,
                        num_hidden=8, pipeline=pipeline, dropout=0.5,
                        frontier_capacities=(128, 768, 2560))
        engine = Engine(Dataset.from_arrays(learn_ds), cfg, device="cpu")
        engine.init()
        runs.append([engine.train_epoch(e)["loss"] for e in range(2)])
    assert runs[0] == runs[1]


def test_overflow_skips_the_step_and_grows_capacities(learn_ds):
    from xgnn_tpu_torch import Engine, RunConfig

    cfg = RunConfig(batch_size=100, fanout=(5, 4), num_layer=2, num_hidden=8,
                    pipeline=False, frontier_capacities=(100, 256, 512))
    engine = Engine(Dataset.from_arrays(learn_ds), cfg, device="cpu").init()
    before = [p.detach().clone() for p in engine.model.parameters()]
    r = engine.train_epoch(0)
    assert engine.history[0]["overflow"].all()  # every step overflowed
    assert np.isnan(r["loss"])
    for p, q in zip(engine.model.parameters(), before):
        assert torch.equal(p, q)  # no step changed a weight
    assert engine.sampler.capacities[1] == 512


def test_entry_points_need_cuda_unless_told(learn_ds, monkeypatch):
    from xgnn_tpu_torch import Engine, RunConfig, make_device_dataset

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(Dataset.from_arrays(learn_ds), RunConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_dataset(100, 200, 4, 2, dedup=False)


@pytest.mark.parametrize("sample_type", ["weighted_khop_prefix",
                                         "weighted_khop_hash_dedup",
                                         "weighted_khop"])
def test_weighted_configs_construct_and_sample(sample_type):
    """The weighted samplers, once refused, take a config and sample a
    batch from a weighted graph made on the CPU (the port's alias tables
    on a weighted device dataset)."""
    from xgnn_tpu_torch import RunConfig, make_device_dataset
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.synthetic import build_alias_tables
    from xgnn_tpu_torch.types import Graph

    cfg = RunConfig(sample_type=sample_type, batch_size=32, fanout=(4, 3))
    assert cfg.sample_type.value == sample_type
    ds = make_device_dataset(400, 2000, 4, 3, seed=2, device="cpu",
                             weighted=True, dedup=False)
    graph = ds.graph
    if sample_type != "weighted_khop_prefix":
        build_alias_tables(ds, seed=2)
        graph = Graph.from_dataset(ds, "cpu", weighted=True)
    batch = Sampler(graph, cfg).sample(torch.from_numpy(ds.train_set[:32]),
                                       32)
    outer, seed_block = batch.blocks  # outermost first
    assert seed_block.neigh.shape[1] == 4 and outer.neigh.shape[1] == 3
    assert bool(seed_block.mask[:32].any(1).all())
    assert not bool(batch.overflow)
    assert int(batch.num_input) > 32


@pytest.mark.parametrize("field,value", [
    ("remat", True),
    ("compute_dtype", "bfloat16"),
    ("cache_percentage", 0.5),
    ("device_loop", True),
    ("use_dist_graph", True),
    ("agg_impl", "tiled"),
])
def test_unported_configs_raise(field, value, learn_ds):
    from xgnn_tpu_torch import Engine, RunConfig

    if field == "cache_percentage":
        # once refused, a cache share in (0, 1) now builds the tiered store
        from xgnn_tpu_torch.store import TieredFeatureSource

        cfg = RunConfig(**{field: value}, batch_size=64, fanout=(4, 3),
                        num_layer=2, num_hidden=8, calibration_batches=1)
        assert cfg.cache_percentage == value
        engine = Engine(Dataset.from_arrays(learn_ds), cfg,
                        device="cpu").init()
        assert type(engine.feature_source) is TieredFeatureSource
        return
    if field == "device_loop":
        # once refused, device_loop now builds and trains: each step runs
        # the captured step's function (uncaptured on the CPU)
        cfg = RunConfig(**{field: value}, batch_size=64, fanout=(4, 3),
                        num_layer=2, num_hidden=8, calibration_batches=1)
        engine = Engine(Dataset.from_arrays(learn_ds), cfg,
                        device="cpu").init()
        r = engine.train_epoch(0)
        assert engine._fused is not None and np.isfinite(r["loss"])
        return
    if field == "use_dist_graph":
        # once refused, the tiered topology now builds on one card (its
        # hot prefix on the device; tests/test_torch_port_tiered_topology.py
        # holds it to JAX), and use_dist_graph alone keeps the whole graph
        # on the device, as in JAX
        for pct, tiered in ((1.0, False), (0.5, True)):
            cfg = RunConfig(**{field: value}, dist_graph_percentage=pct,
                            batch_size=64, fanout=(4, 3), num_layer=2,
                            num_hidden=8, calibration_batches=1)
            engine = Engine(Dataset.from_arrays(learn_ds), cfg,
                            device="cpu").init()
            assert (engine._tier is not None) == tiered
            assert np.isfinite(engine.train_epoch(0)["loss"])
        return
    if field in ("remat", "compute_dtype", "agg_impl"):
        # once refused, the training options now build and train
        # (tests/test_torch_port_options.py holds them to JAX), GAT under
        # bfloat16 too (tests/test_torch_gat_bf16.py)
        models = ("graphsage", "gat") if field == "compute_dtype" else (
            "graphsage",)
        for model in models:
            cfg = RunConfig(**{field: value}, model=model, batch_size=64,
                            fanout=(4, 3), num_layer=2, num_hidden=8,
                            calibration_batches=1)
            engine = Engine(Dataset.from_arrays(learn_ds), cfg,
                            device="cpu").init()
            assert np.isfinite(engine.train_epoch(0)["loss"])
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RunConfig(**{field: value})
