"""The port's main path as a whole against the JAX package, on the CPU.

Sampler blocks are held equal to the JAX sampler's for the same uniforms,
and a 20+ step training trajectory (sampler, converted initial weights,
loss, Adam) is held to the JAX ``Engine``'s losses step by step.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu_torch.dataset import Dataset  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer_uniforms(key, frontier_lens, fanouts):
    """The uniforms the JAX ``_sample_minibatch`` draws for each layer:
    ``key, k = split(key)``, then ``uniform(k, (frontier_len, K))``."""
    us = []
    for b, k_fan in zip(frontier_lens, fanouts):
        key, k = jax.random.split(key)
        us.append(_t(jax.random.uniform(k, (b, k_fan))))
    return us


def _assert_same_batch(port, ref):
    assert len(port.blocks) == len(ref.blocks)
    for pb, rb in zip(port.blocks, ref.blocks):
        np.testing.assert_array_equal(pb.neigh.numpy(), np.asarray(rb.neigh))
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


@pytest.mark.parametrize("model,heads", [
    ("graphsage", 1), ("gcn", 1), ("gat", 1), ("gat", 2),
])
def test_training_trajectory_matches_jax_engine(learn_ds, model, heads):
    """>= 20 steps of the JAX Engine (direct extract, pipeline off) against
    the port's sampler (same uniforms), model (converted initial weights),
    loss and Adam: blocks equal every step, losses close step by step
    (rtol/atol 2e-3: float32 sums in other orders, compounded over the
    steps' updates)."""
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
    fanout = (5, 4, 3)
    common = dict(batch_size=len(ds.train_set) // 21, fanout=fanout,
                  num_layer=3, num_hidden=16, model=model, num_head=heads,
                  dropout=0.0,
                  lr=0.01, pipeline=False, gpu_extract=True,
                  cache_percentage=0.0)
    engine = JEngine(ds, JConfig(**common, num_epoch=1)).init()
    params_np = jax.tree.map(np.asarray, engine.state.params)

    cfg = RunConfig(**common, frontier_capacities=engine.sampler.capacities)
    sampler = Sampler(Graph.from_dataset(ds, "cpu"), cfg, direct_extract=True)
    feat = HBMFeatureSource(ds.feat, "cpu")
    labels_src = LabelSource(ds.label, "cpu")
    model = build_model(cfg, ds.feat_dim, ds.num_class)
    model.load_state_dict(params_from_flax(params_np))
    opt = Adam(list(model.parameters()), cfg.lr)

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
                             fanout)
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
        make_device_dataset(100, 200, 4, 2)


@pytest.mark.parametrize("field,value", [
    ("model", "pinsage"),
    ("model", "mlp"),
    ("sample_type", "weighted_khop"),
    ("sample_type", "random_walk"),
    ("cache_percentage", 0.5),
    ("device_loop", True),
    ("use_dist_graph", True),
    ("agg_impl", "tiled"),
])
def test_unported_configs_raise(field, value):
    from xgnn_tpu_torch import RunConfig

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RunConfig(**{field: value})
