"""The port's training options against the JAX package, on the CPU.

``feat_dtype`` and ``compute_dtype`` "bfloat16", ``agg_impl`` (``loop``,
``tiled``, ``chunk<N>``), ``remat`` and AdamW (``weight_decay > 0``):

- K4's plain forward over a bfloat16 table (every form: sum, mean,
  weighted, the dst prefix) against JAX's ``fanout_reduce`` loop, K14 and
  the chunked form over the same table, the two tables bit-equal;
- the GNN's outputs and gradients under each ``agg_impl`` against flax's;
- AdamW against ``optax.adamw`` step by step, a skipped step included, and
  a resume from a checkpoint under AdamW;
- ``remat``'s per-step losses against the plain run's and JAX's remat run;
- trajectories under bfloat16 features and compute against the JAX
  ``Engine`` (direct and non-direct extract, GCN, PinSAGE, the tiered
  store), and the stores' dtypes.

GAT under bfloat16 has a file of its own, ``tests/test_torch_gat_bf16.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402
from xgnn_tpu_torch.dataset import Dataset  # noqa: E402

from test_torch_port_slice import (  # noqa: E402
    _assert_same_batch,
    _layer_uniforms,
    _t,
)

TOL_AGG = dict(rtol=1e-5, atol=1e-5)  # float32 sums in other orders
TOL_ADAMW = dict(rtol=1e-6, atol=0)  # the same arithmetic, step by step
TOL_STEPS = dict(rtol=1e-4, atol=1e-4)  # a few steps of float32 training


def _bits(a) -> np.ndarray:
    """A bfloat16 array's (JAX) or tensor's (port) 16 bits, as uint16."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _bf16_tables(rng, n, f):
    """A float32 table rounded to bfloat16 by both packages: the two bit
    patterns must agree (round to nearest, ties to even)."""
    feat = rng.standard_normal((n, f)).astype(np.float32)
    jtab = jnp.asarray(feat).astype(jnp.bfloat16)
    ptab = torch.from_numpy(feat).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(ptab), _bits(jtab))
    return jtab, ptab


def _picks(rng, d, k, n, empty=0.3):
    neigh = rng.integers(0, n, (d, k)).astype(np.int32)
    neigh[rng.random((d, k)) < empty] = EMPTY_KEY
    return neigh


# ------------------------------------------------------ K4 over bfloat16
@pytest.mark.parametrize("impl", ["loop", "tiled", "chunk3"])
@pytest.mark.parametrize("form", ["sum", "mean", "gcn", "pinsage",
                                  "prefix_mean"])
def test_k4_bf16_forward_matches_jax(impl, form):
    """K4's plain forward over a bfloat16 table (float32 sums) against
    JAX's ``fanout_reduce`` in ``impl`` over the same table: the sum or
    mean and ``denom`` within 1e-5 (equal to the loop's ``denom``); the
    prefix form's dst rows are the table's first rows bit for bit."""
    from xgnn_tpu.models.gnn import fanout_reduce as jreduce
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.ops.fanout import (
        fanout_reduce,
        masked_mean,
        prefix_masked_mean,
    )

    rng = np.random.default_rng(len(form) * 7 + len(impl))
    n, f, d, k = 300, 24, 120, 5
    jtab, ptab = _bf16_tables(rng, n, f)
    neigh = _picks(rng, d, k, n)
    weights = None
    if form == "gcn":  # K7's weights, rsqrt of a count
        weights = (1.0 / np.sqrt(rng.integers(1, 5, (d, k)))).astype(
            np.float32)
    elif form == "pinsage":  # the walk's visit counts
        weights = rng.integers(0, 4, (d, k)).astype(np.float32)
    jblk = JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(d),
                  num_src=jnp.int32(n),
                  weights=None if weights is None else jnp.asarray(weights))
    s, den = jreduce(jtab, jblk, None if weights is None
                     else jnp.asarray(weights), impl=impl)
    assert s.dtype == jnp.float32
    mean = form in ("mean", "pinsage", "prefix_mean")
    want = np.asarray(s / jnp.maximum(den, 1e-9) if mean else s)
    w = None if weights is None else _t(weights)
    if form == "prefix_mean":
        h_dst, got, pden = prefix_masked_mean(ptab, _t(neigh), w)
        np.testing.assert_array_equal(_bits(h_dst), _bits(jtab[:d]))
    elif mean:
        got, pden = masked_mean(ptab, _t(neigh), w)
    else:
        got, pden = fanout_reduce(ptab, _t(neigh), w)
    assert got.dtype == torch.float32 and pden.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL_AGG)
    if impl == "loop":  # the same sum in the same order
        np.testing.assert_array_equal(pden.numpy(), np.asarray(den))
    else:
        np.testing.assert_allclose(pden.numpy(), np.asarray(den), **TOL_AGG)


def test_k4_refuses_a_bf16_source_that_needs_a_gradient():
    from xgnn_tpu_torch.ops.fanout import masked_mean

    tab = torch.zeros((10, 4), dtype=torch.bfloat16, requires_grad=True)
    neigh = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        masked_mean(tab, neigh)
    with torch.no_grad():
        out, _ = masked_mean(tab, neigh)
    assert out.dtype == torch.float32


@pytest.mark.parametrize("width", [1, 47, 128, 256])
def test_k1_bf16_plain_is_the_jax_take(width):
    """K1's plain version over a bfloat16 table: JAX's fill-mode take,
    bit for bit, zero rows for EMPTY, negative and past-the-table ids."""
    from xgnn_tpu_torch.ops.gather import gather_rows

    rng = np.random.default_rng(width)
    jtab, ptab = _bf16_tables(rng, 200, width)
    ids = rng.integers(-3, 205, 333).astype(np.int32)
    ids[::4] = EMPTY_KEY
    out = gather_rows(ptab, _t(ids))
    assert out.dtype == torch.bfloat16
    valid = (ids >= 0) & (ids < 200)
    want = jnp.take(jtab, jnp.asarray(np.where(valid, ids, EMPTY_KEY)),
                    axis=0, mode="fill", fill_value=0)
    np.testing.assert_array_equal(_bits(out), _bits(want))


# ----------------------------------------------------------- agg_impl
def _local_blocks(rng, weighted):
    """Two local-id blocks (outermost first), as tests/test_models.py
    makes them: 20 of 32 dst rows over 60 of 64 src rows, fanout 5, then 8
    of 16 over 20 of 32, fanout 3."""
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.types import Block

    jblocks, blocks = [], []
    for nd, ns, k, dcap in ((20, 60, 5, 32), (8, 20, 3, 16)):
        neigh = np.full((dcap, k), EMPTY_KEY, np.int32)
        w = np.zeros((dcap, k), np.float32)
        for i in range(nd):
            c = rng.integers(0, k + 1)
            neigh[i, :c] = rng.integers(0, ns, c)
            w[i, :c] = rng.random(c).astype(np.float32) + 0.5
        jblocks.append(JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(nd),
                              num_src=jnp.int32(ns),
                              weights=jnp.asarray(w) if weighted else None))
        blocks.append(Block(neigh=_t(neigh), num_dst=_t(np.int32(nd)),
                            num_src=_t(np.int32(ns)),
                            weights=_t(w) if weighted else None))
    return jblocks, blocks


@pytest.mark.parametrize("impl", ["loop", "tiled", "chunk3"])
@pytest.mark.parametrize("conv", ["graphsage", "gcn", "pinsage"])
def test_agg_impl_matches_jax(conv, impl):
    """Two layers at dropout 0 under ``agg_impl``: the port's logits and
    every parameter's gradient against flax's ``GNN(agg_impl=impl)``
    within 1e-5 (K4 computes every formulation, so the port's model is
    the one model whatever the formulation)."""
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models.gnn import GNN

    rng = np.random.default_rng(len(conv) + len(impl))
    jblocks, blocks = _local_blocks(rng, conv == "pinsage")
    x = rng.standard_normal((64, 12)).astype(np.float32)
    jmodel = JGNN(conv=conv, hidden_dim=16, out_dim=5, num_layers=2,
                  dropout=0.0, agg_impl=impl)
    params = jmodel.init({"params": jax.random.key(0)}, jblocks,
                         jnp.asarray(x), False)["params"]
    g = rng.standard_normal((16, 5)).astype(np.float32)

    def jloss(p):
        out = jmodel.apply({"params": p}, jblocks, jnp.asarray(x), False)
        return jnp.sum(out * g), out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = GNN(12, 16, 5, 2, dropout=0.0, conv=conv)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    out = model(blocks, _t(x), train=True)
    torch.sum(out * _t(g)).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **TOL_AGG)
    want = params_from_flax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   **TOL_AGG, err_msg=name)


def test_agg_impl_values_are_checked():
    """``RunConfig`` checks ``agg_impl``; every value builds the same model
    with the same weights."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.models import build_model

    loop = build_model(RunConfig(), 12, 5).state_dict()
    for impl in ("loop", "tiled", "chunk", "chunk3", "chunk16"):
        assert RunConfig(agg_impl=impl).agg_impl == impl
        got = build_model(RunConfig(agg_impl=impl), 12, 5).state_dict()
        assert got.keys() == loop.keys()
        assert all(torch.equal(got[k], loop[k]) for k in loop)
    for impl in ("chunk0", "tile", "scan"):
        with pytest.raises(ValueError, match="agg_impl"):
            RunConfig(agg_impl=impl)
    with pytest.raises(ValueError, match="feat_dtype"):
        RunConfig(feat_dtype="float16")


# --------------------------------------------------------------- AdamW
def test_adamw_matches_optax_with_a_skipped_step():
    """``Adam(weight_decay=...)`` against ``optax.adamw`` over five steps of
    the same gradients, within 1e-6: every parameter decays, biases too,
    and a skipped step (the train step's ``jnp.where`` over params and
    optimizer state) keeps params, moments and count."""
    from xgnn_tpu_torch.train import Adam

    rng = np.random.default_rng(4)
    shapes = [(7, 5), (5,), (3, 7)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    lr, wd = 0.003, 5e-4
    tx = optax.adamw(lr, weight_decay=wd)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    pp = [torch.from_numpy(p.copy()) for p in params]
    opt = Adam(pp, lr, weight_decay=wd)
    for step in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        skip = step == 2
        upd, new_state = tx.update([jnp.asarray(g) for g in grads], jstate,
                                   jp)
        new_p = optax.apply_updates(jp, upd)
        if skip:
            new_p, new_state = jp, jstate
        jp, jstate = new_p, new_state
        opt.step([torch.from_numpy(g) for g in grads], torch.tensor(skip))
        for a, b in zip(pp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_ADAMW)
        adam = jstate[0]
        assert int(opt.count) == int(adam.count) == step + (step < 2)
        for mine, theirs in ((opt.mu, adam.mu), (opt.nu, adam.nu)):
            for a, b in zip(mine, theirs):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **TOL_ADAMW)


def test_adamw_checkpoint_needs_no_new_state(learn_ds, tmp_path):
    """Under AdamW the checkpoint holds Adam's state (mu, nu, count) and
    nothing else, and a resume equals an uninterrupted run bit for bit."""
    from xgnn_tpu_torch import Engine, RunConfig

    ds = Dataset.from_arrays(learn_ds)
    common = dict(batch_size=300, fanout=(4, 3), num_layer=2, num_hidden=16,
                  calibration_batches=0, pipeline=False, weight_decay=5e-4)
    whole = Engine(ds, RunConfig(**common, num_epoch=2), device="cpu")
    whole.run()
    ckpt = str(tmp_path / "ckpt")
    Engine(ds, RunConfig(**common, num_epoch=1, checkpoint_dir=ckpt),
           device="cpu").run()
    payload = torch.load(Path(ckpt) / "ckpt_0.pt", weights_only=True)
    assert set(payload) == {"model", "mu", "nu", "count", "epoch"}
    resumed = Engine(ds, RunConfig(**common, num_epoch=2,
                                   checkpoint_dir=ckpt), device="cpu")
    resumed.run()
    for a, b in zip(list(whole.model.parameters()) + whole.opt.mu
                    + whole.opt.nu + [whole.opt.count],
                    list(resumed.model.parameters()) + resumed.opt.mu
                    + resumed.opt.nu + [resumed.opt.count]):
        assert torch.equal(a, b)


# --------------------------------------------------- engine trajectories
def _trajectory(ds, common, steps=6):
    """``steps`` steps of the JAX Engine (pipeline off) against the port's
    sampler (the same uniforms), feature source in the config's dtype,
    converted initial weights, loss and optimizer: blocks equal every
    step, the extracted rows (or the table) equal bit for bit, and the
    per-step losses returned as ``(jax, port)``."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.engine import Engine as JEngine
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.store import (
        HBMFeatureSource,
        LabelSource,
        TieredFeatureSource,
    )
    from xgnn_tpu_torch.store.ranking import build_ranking
    from xgnn_tpu_torch.train import Adam, train_step
    from xgnn_tpu_torch.types import Graph

    engine = JEngine(ds, JConfig(**common, num_epoch=1)).init()
    params_np = jax.tree.map(np.asarray, engine.state.params)
    cfg = RunConfig(**common, frontier_capacities=engine.sampler.capacities)
    dtype = torch.bfloat16 if cfg.feat_dtype == "bfloat16" else None
    direct = engine._direct
    sampler = Sampler(Graph.from_dataset(ds, "cpu"), cfg,
                      direct_extract=direct)
    tiered = 0 < cfg.cache_percentage < 1
    if tiered:
        store = TieredFeatureSource(ds.feat, build_ranking(ds, cfg, None),
                                    cfg.cache_percentage, "cpu", dtype)
        assert store.cache_feat.dtype == (dtype or torch.float32)
        assert store.feat_host.dtype == torch.float32
    else:
        store = HBMFeatureSource(ds.feat, "cpu", dtype)
        np.testing.assert_array_equal(
            _bits(store.feat) if dtype else store.feat.numpy(),
            _bits(engine.feature_source.feat) if dtype
            else np.asarray(engine.feature_source.feat))
    labels_src = LabelSource(ds.label, "cpu")
    model = build_model(cfg, ds.feat_dim, ds.num_class)
    model.load_state_dict(params_from_flax(params_np))
    opt = Adam(list(model.parameters()), cfg.lr,
               weight_decay=cfg.weight_decay)

    walk = ((cfg.num_random_walk, cfg.random_walk_length)
            if cfg.model == "pinsage" else None)
    shuffler = JShuffler(ds.train_set, cfg.batch_size, seed=cfg.seed + 1)
    sample_base = jax.random.fold_in(engine._sample_key, 0)
    drop_base = jax.random.fold_in(engine._dropout_key, 0)
    state = engine.state
    jax_losses, port_losses = [], []
    for step, (seeds, n) in enumerate(shuffler.epoch_batches(0)):
        if step >= steps:
            break
        key = jax.random.fold_in(sample_base, step)
        batch, x, labels, _, _ = engine._produce(((seeds, n), key, (0, step)))
        state, metrics = engine._train_step(
            state, batch.blocks, x, labels, batch.num_output,
            jax.random.fold_in(drop_base, step), batch.overflow)
        jax_losses.append(float(metrics["loss"]))

        us = _layer_uniforms(key, [len(seeds)] + sampler.capacities[1:-1],
                             sampler.fanouts, walk)
        pbatch = sampler.sample(_t(seeds), n, u=us)
        _assert_same_batch(pbatch, batch)
        if direct:
            px = store.feat
        else:
            px, _ = store.extract(pbatch.input_nodes, pbatch.num_input)
            num = int(pbatch.num_input)
            assert px.dtype == (dtype or torch.float32)
            np.testing.assert_array_equal(
                _bits(px[:num]) if dtype else px[:num].numpy(),
                _bits(x[:num]) if dtype else np.asarray(x)[:num])
        plabels = labels_src.extract(pbatch.output_nodes, pbatch.num_output)
        m = train_step(model, opt, pbatch.blocks, px, plabels,
                       pbatch.num_output, None, pbatch.overflow)
        port_losses.append(float(m["loss"]))
    return np.asarray(jax_losses), np.asarray(port_losses)


_BASE = dict(fanout=(5, 4), num_layer=2, num_hidden=16, dropout=0.0,
             lr=0.01, pipeline=False, sample_type="khop3",
             cache_percentage=0.0)


@pytest.mark.parametrize("case", [
    # test_bfloat16_compute's options: bf16 compute over a bf16 table
    dict(model="graphsage", feat_dtype="bfloat16", compute_dtype="bfloat16"),
    # non-direct extract: the extracted float32 rows cast
    dict(model="graphsage", compute_dtype="bfloat16", gpu_extract=False),
    dict(model="gcn", feat_dtype="bfloat16"),
    dict(model="pinsage", feat_dtype="bfloat16", sample_type="random_walk"),
    # test_bf16_feature_storage_learns: bf16 cache, K14, the tiered store
    dict(model="graphsage", feat_dtype="bfloat16", agg_impl="tiled",
         cache_percentage=0.2, cache_policy="degree"),
    # AdamW and remat on the same path
    dict(model="graphsage", weight_decay=5e-4, remat=True),
], ids=["sage-bf16-both", "sage-bf16-nondirect",
        "gcn-bf16-feat", "pinsage-bf16-feat", "sage-bf16-tiered-tiled",
        "sage-adamw-remat"])
def test_option_trajectory_matches_jax_engine(learn_ds, case):
    """Six steps per case, the JAX Engine against the port at dropout 0
    with flax's initial weights: per-step losses within 1e-4."""
    common = dict(_BASE, batch_size=len(learn_ds.train_set) // 21, **case)
    jl, pl = _trajectory(learn_ds, common)
    assert len(pl) == 6 and np.isfinite(jl).all()
    np.testing.assert_allclose(pl, jl, **TOL_STEPS)


def test_bf16_compute_over_the_f32_table_equals_the_bf16_table(learn_ds):
    """``compute_dtype="bfloat16"`` over the float32 table (the whole table
    cast each step, as JAX casts it) gives the per-step losses of the
    bfloat16 table (``feat_dtype``), bit for bit: both round the same
    float32 rows to nearest, and the trajectory test holds the latter to
    JAX."""
    from xgnn_tpu_torch import Engine, RunConfig

    ds = Dataset.from_arrays(learn_ds)
    hist = []
    for kw in (dict(feat_dtype="bfloat16"), dict(compute_dtype="bfloat16")):
        cfg = RunConfig(batch_size=128, fanout=(5, 4), num_layer=2,
                        num_hidden=16, lr=0.01, dropout=0.5,
                        calibration_batches=1, pipeline=False, **kw)
        eng = Engine(ds, cfg, device="cpu").init()
        eng.train_epoch(0)
        hist.append(eng.history[0]["loss"])
    assert np.isfinite(hist[0]).all()
    np.testing.assert_array_equal(hist[1], hist[0])


@pytest.mark.parametrize("impl", ["tiled", "chunk3"])
def test_agg_impl_losses_equal_the_loop_runs(learn_ds, impl):
    """An engine under ``agg_impl="tiled"`` or ``"chunk3"`` gives the
    per-step losses of ``"loop"`` bit for bit, at dropout 0.5: K4 runs
    every formulation, so the model and its kernels are the same."""
    from xgnn_tpu_torch import Engine, RunConfig

    ds = Dataset.from_arrays(learn_ds)
    hist = []
    for agg in ("loop", impl):
        cfg = RunConfig(batch_size=256, fanout=(5, 5), num_layer=2,
                        num_hidden=16, lr=0.01, dropout=0.5,
                        calibration_batches=1, pipeline=False, agg_impl=agg)
        eng = Engine(ds, cfg, device="cpu").init()
        eng.train_epoch(0)
        hist.append(eng.history[0]["loss"])
    assert np.isfinite(hist[0]).all()
    np.testing.assert_array_equal(hist[1], hist[0])


def test_remat_losses_equal_the_plain_runs(learn_ds):
    """The port's per-step losses with and without remat are equal (the
    same kernels in the same order, dropout 0.5 drawn outside the
    recomputed convolutions), as JAX's test_remat_matches_plain holds its
    own; against JAX's remat run see the trajectory test's remat case."""
    from xgnn_tpu_torch import Engine, RunConfig

    ds = Dataset.from_arrays(learn_ds)
    hist = []
    for remat in (False, True):
        cfg = RunConfig(batch_size=256, fanout=(5, 5), num_layer=2,
                        num_hidden=16, model="gcn", lr=0.01, dropout=0.5,
                        calibration_batches=1, pipeline=False, remat=remat)
        eng = Engine(ds, cfg, device="cpu").init()
        eng.train_epoch(0)
        hist.append(eng.history[0]["loss"])
        assert eng.model.remat == remat
    assert np.isfinite(hist[0]).all()
    np.testing.assert_array_equal(hist[1], hist[0])


def test_feat_dtype_sets_the_stores(learn_ds):
    """``Engine.feature_source.feat`` is bfloat16 under feat_dtype, and
    ``Engine(feat_dtype=...)`` may only repeat the config's; the
    tiered store's cache is bfloat16 and its host table float32, its miss
    bytes counted at the host's 4 bytes; the dynamic refresh writes
    bfloat16 rows equal to the host rows rounded."""
    from xgnn_tpu_torch import Engine, RunConfig

    ds = Dataset.from_arrays(learn_ds)
    common = dict(batch_size=64, fanout=(4, 3), num_layer=2, num_hidden=8,
                  calibration_batches=1, pipeline=False,
                  feat_dtype="bfloat16")
    eng = Engine(ds, RunConfig(**common), device="cpu").init()
    assert eng.feature_source.feat.dtype == torch.bfloat16
    assert np.isfinite(eng.train_epoch(0)["loss"])
    eng = Engine(ds, RunConfig(**common), device="cpu",
                 feat_dtype=torch.bfloat16).init()
    assert eng.feature_source.feat.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="feat_dtype"):
        Engine(ds, RunConfig(**common), device="cpu",
               feat_dtype=torch.float32)
    with pytest.raises(ValueError, match="feat_dtype"):
        Engine(ds, RunConfig(model="gat"), device="cpu",
               feat_dtype=torch.bfloat16)
    for policy in ("degree", "dynamic_cache"):
        eng = Engine(ds, RunConfig(**common, cache_percentage=0.2,
                                   cache_policy=policy), device="cpu").init()
        src = eng.feature_source
        assert src.cache_feat.dtype == torch.bfloat16
        assert src.feat_host.dtype == torch.float32
        eng.train_epoch(0)
        hist = eng.history[0]
        assert hist["miss"].sum() > 0
        ids = torch.nonzero(src.posmap != EMPTY_KEY)[:, 0]
        rows = src.cache_feat[src.posmap[ids].long()]
        assert torch.equal(rows, src.feat_host[ids].to(torch.bfloat16))
        ids = torch.arange(src.posmap.shape[0], dtype=torch.int32)
        out, info = src.extract(ids, ids.shape[0])
        assert torch.equal(out, src.feat_host.to(torch.bfloat16))
        assert int(info["miss_bytes"]) == int(info["num_miss"]) * 4 * \
            src.feat_dim


def test_the_training_cli_takes_the_option_flags(capsys):
    """``--feat-dtype``, ``--compute-dtype``, ``--remat`` and
    ``--agg-impl``, refused before, reach the config and train."""
    from xgnn_tpu_torch.examples import train

    engine = train.main(["--cpu", "--synthetic", "--synthetic-nodes", "3000",
                         "--batch-size", "100", "--fanout", "4", "3",
                         "--num-hidden", "16", "--num-epoch", "1",
                         "--feat-dtype", "bfloat16", "--compute-dtype",
                         "bfloat16", "--remat", "--agg-impl", "tiled"])
    out = capsys.readouterr().out
    for line in ("config:feat_dtype=bfloat16", "config:compute_dtype=bfloat16",
                 "config:remat=True", "config:agg_impl=tiled",
                 "config:weight_decay=0.0"):
        assert line in out, line
    assert re.search(r"^test_result:final_train_acc=[0-9.]+$", out, re.M)
    assert engine.feature_source.feat.dtype == torch.bfloat16
    assert engine.model.remat
