"""The port's tiered feature store and cache rankings against the JAX
package, on the CPU.

K11's plain version (the port's ``TieredFeatureSource.extract`` on CPU
tensors) against the JAX store's split, host gather and combine in both of
its miss modes; K12's plain version against ``_accumulate``; the exact
static closure (K12b's plain version) against ``static_exact_ranking``;
every host ranking policy against ``build_ranking``; the dynamic refresh;
and a cached GraphSAGE trajectory against the JAX ``Engine``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402
from xgnn_tpu_torch.dataset import Dataset  # noqa: E402

from test_torch_port_slice import (  # noqa: E402
    _assert_same_batch,
    _layer_uniforms,
    _t,
)


def _ids(rng, num_node, n, num_input, empty_frac=0.2):
    """``n`` ids, the first ``num_input`` distinct draws from the graph
    with some EMPTY, the rest EMPTY and valid ids past ``num_input``."""
    ids = np.full(n, EMPTY_KEY, np.int32)
    ids[:num_input] = rng.choice(num_node, num_input, replace=False)
    ids[:num_input][rng.random(num_input) < empty_frac] = EMPTY_KEY
    # ids past num_input must be ignored, whatever they are
    ids[num_input:] = rng.integers(0, num_node, n - num_input)
    return ids


@pytest.mark.parametrize("miss_mode", ["fixed", "dynamic"])
@pytest.mark.parametrize("pct,num_input", [(0.2, 700), (0.5, 1000),
                                           (0.05, 0)])
def test_tiered_extract_plain_matches_jax(small_ds, miss_mode, pct,
                                          num_input):
    """Rows < num_input bit-equal to the JAX store's, the rest zero; the hit
    and miss counts equal (the fixed bucket's device counts, or the dynamic
    mode's hit rate and miss bytes)."""
    from xgnn_tpu.store.feature_store import TieredFeatureSource as JTiered
    from xgnn_tpu_torch.store import TieredFeatureSource

    rng = np.random.default_rng(int(pct * 100) + num_input)
    feat = np.asarray(small_ds.feat)
    ranking = rng.permutation(small_ds.num_node).astype(np.int32)
    n = 1024
    ids = _ids(rng, small_ds.num_node, n, num_input)
    jsrc = JTiered(feat, ranking, pct,
                   miss_cap=n if miss_mode == "fixed" else None)
    jout, jinfo = jsrc.extract(jnp.asarray(ids), num_input)
    src = TieredFeatureSource(feat, ranking, pct, "cpu")
    out, info = src.extract(torch.from_numpy(ids), num_input)
    np.testing.assert_array_equal(out.numpy()[:num_input],
                                  np.asarray(jout)[:num_input])
    assert not out[num_input:].any()
    nh, nm = int(info["num_hit"]), int(info["num_miss"])
    assert int(info["miss_bytes"]) == nm * feat.shape[1] * 4
    if miss_mode == "fixed":
        assert not bool(jinfo["overflow"])
        assert (nh, nm) == (int(jinfo["num_hit"]), int(jinfo["num_miss"]))
    else:
        assert jinfo["miss_bytes"] == nm * feat.shape[1] * 4
        assert jinfo["hit_rate"] == nh / max(nh + nm, 1)
    live = ids[:num_input][ids[:num_input] != EMPTY_KEY]
    assert nh + nm == len(live)
    assert nh == int(np.isin(live, ranking[: int(small_ds.num_node * pct)])
                     .sum())


def test_tiered_extract_all_miss_form_builds_the_cache(small_ds):
    """With no posmap every valid id is read from the host table: the
    cache rows are the ranking's prefix rows."""
    from xgnn_tpu_torch.ops.tiered import MappedHostTable, tiered_extract

    feat = np.asarray(small_ds.feat)
    host = MappedHostTable(feat, "cpu")
    ids = np.array([5, EMPTY_KEY, 0, 1999, 7, -3, 2000], np.int32)
    out, counts = tiered_extract(torch.from_numpy(ids), 5, None, None, host)
    want = np.zeros((7, feat.shape[1]), np.float32)
    want[[0, 2, 3, 4]] = feat[[5, 0, 1999, 7]]
    np.testing.assert_array_equal(out.numpy(), want)
    assert counts.tolist() == [0, 4]
    # the table is the source's own copy, not the caller's memory
    assert host.tensor.data_ptr() != torch.as_tensor(feat).data_ptr()


@pytest.mark.parametrize("num_input", [0, 300, 777, 1000])
def test_accumulate_plain_matches_jax(num_input):
    from xgnn_tpu.store.presample import _accumulate
    from xgnn_tpu_torch.ops.presample import accumulate_freq

    rng = np.random.default_rng(num_input)
    num_node, n = 500, 1000
    ids = rng.integers(0, num_node, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = EMPTY_KEY
    freq0 = rng.integers(0, 5, num_node).astype(np.int32)
    want = np.asarray(_accumulate(jnp.asarray(freq0), jnp.asarray(ids),
                                  num_input))
    freq = torch.from_numpy(freq0.copy())
    got = accumulate_freq(freq, torch.from_numpy(ids),
                          torch.tensor(num_input, dtype=torch.int32))
    assert got is freq  # in place
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fanout,epochs", [((5, 4, 3), 1), ((4, 3), 2)])
def test_static_exact_ranking_matches_jax(small_ds, fanout, epochs):
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.store.presample import static_exact_ranking as jstatic
    from xgnn_tpu.types import Graph as JGraph
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.store.presample import static_exact_ranking
    from xgnn_tpu_torch.types import Graph

    common = dict(batch_size=150, fanout=fanout, presample_epoch=epochs,
                  cache_percentage=0.2, cache_policy="presample_static")
    want = jstatic(JGraph.from_dataset(small_ds), small_ds.train_set,
                   JConfig(**common), small_ds.num_node)
    got = static_exact_ranking(Graph.from_dataset(small_ds, "cpu"),
                               small_ds.train_set, RunConfig(**common),
                               small_ds.num_node, "cpu")
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0


def _closure_graph(case):
    """``(indptr, indices, train_set)`` of the exact closure's edge cases."""
    rng = np.random.default_rng(len(case))
    if case == "star":  # a hub of 3,000 neighbours, leaves back and on
        n = 4000
        rows = [list(range(1, 3001))] + [[0, (v * 7) % n] for v in
                                         range(1, n)]
        train = np.array([5, 0, 3999, 17], np.int32)
    elif case == "chain":  # each layer marks one new row
        n = 40
        rows = [[v + 1] for v in range(n - 1)] + [[]]
        train = np.array([0], np.int32)
    elif case == "hubs":  # power-law rows, EMPTY and repeated targets
        n = 3000
        deg = np.minimum((2.0 / rng.random(n) ** 1.2).astype(int), 2500)
        rows = [list(rng.integers(0, n, d)) for d in deg]
        for r in rows[::9]:
            r += [EMPTY_KEY, r[0] if r else 0]
        train = rng.choice(n, 300, replace=False).astype(np.int32)
    elif case == "loops and isolated":
        rows = [[0], [], [1, 1], [], [4, 0], [], [6]] + [[]] * 50
        n = len(rows)
        train = np.array([0, 2, 4, 6, 3, 2, 2], np.int32)
    else:
        raise ValueError(case)
    indptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    indices = np.concatenate([np.asarray(r, np.int64) for r in rows])
    return indptr.astype(np.int32), indices.astype(np.int32), train


@pytest.mark.parametrize("case", ["star", "chain", "hubs",
                                  "loops and isolated"])
@pytest.mark.parametrize("num_layer", [1, 2, 3, 4])
def test_static_closure_edge_cases_match_jax(case, num_layer):
    """K12b's plain version, through static_exact_ranking, against JAX's on
    a hub past the kernel's chunk size, a chain, power-law rows with EMPTY
    and repeated targets, self-loops and isolated nodes, and repeated
    seeds: exact, over two epochs of batches of 3."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.store.presample import static_exact_ranking as jstatic
    from xgnn_tpu.types import Graph as JGraph
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.store.presample import static_exact_ranking
    from xgnn_tpu_torch.types import Graph

    indptr, indices, train = _closure_graph(case)
    n = len(indptr) - 1
    common = dict(batch_size=3, fanout=(5,) * num_layer, presample_epoch=2,
                  cache_percentage=0.2, cache_policy="presample_static")
    want = jstatic(JGraph(indptr=jnp.asarray(indptr),
                          indices=jnp.asarray(indices)),
                   train, JConfig(**common), n)
    got = static_exact_ranking(
        Graph(indptr=torch.from_numpy(indptr),
              indices=torch.from_numpy(indices)),
        train, RunConfig(**common), n, "cpu")
    np.testing.assert_array_equal(got, want)
    if case == "chain":  # one seed a batch: each batch a run of L + 1
        assert int(got.sum()) == 2 * (num_layer + 1)


def test_static_presample_config_matches_jax():
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.store.presample import static_presample_config as jcfg_of
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.store.presample import static_presample_config

    common = dict(fanout=(15, 10, 5), presample_static_fanout=24,
                  frontier_capacities=(8000, 1, 2, 3))
    want = jcfg_of(JConfig(**common))
    got = static_presample_config(RunConfig(**common))
    assert got.sample_type.value == want.sample_type.value == "khop0"
    assert got.fanout == tuple(want.fanout) == (24, 24, 24)
    assert got.frontier_capacities is want.frontier_capacities is None


@pytest.mark.parametrize("policy", ["degree", "heuristic", "degree_hop",
                                    "random", "pre_sample", "fake_optimal",
                                    "presample_static", "dynamic_cache"])
@pytest.mark.parametrize("on_device", [False, True])
def test_build_ranking_matches_jax(small_ds, policy, on_device):
    """Equal arrays for the same dataset and the same access counts (small
    integers, so that the stable sorts break many ties); ``on_device``
    gives the port the CSR as tensors, as a dataset made on the device
    holds it."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.store.ranking import build_ranking as jbuild
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.store.ranking import build_ranking

    freq = np.random.default_rng(3).integers(0, 6, small_ds.num_node)
    want = jbuild(small_ds, JConfig(cache_policy=policy), freq)
    ds = Dataset.from_arrays(small_ds)
    if on_device:
        ds = dataclasses.replace(ds, indptr=torch.from_numpy(ds.indptr),
                                 indices=torch.from_numpy(ds.indices))
    got = build_ranking(ds, RunConfig(cache_policy=policy), freq)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_build_ranking_takes_the_dataset_file_and_needs_counts(small_ds):
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.store.ranking import build_ranking

    ds = Dataset.from_arrays(small_ds)
    ds.cache_rankings = {"degree": np.arange(ds.num_node)[::-1]}
    np.testing.assert_array_equal(
        build_ranking(ds, RunConfig(cache_policy="degree")),
        np.arange(ds.num_node)[::-1])
    with pytest.raises(ValueError, match="access frequencies"):
        build_ranking(ds, RunConfig(cache_policy="pre_sample"))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_dynamic_refresh_keeps_extraction_exact(small_ds, as_tensor):
    from xgnn_tpu_torch.store import DynamicTieredFeatureSource

    feat = np.asarray(small_ds.feat)
    n = small_ds.num_node
    src = DynamicTieredFeatureSource(feat, np.arange(n, dtype=np.int32), 0.2,
                                     "cpu")
    before = src.posmap.clone()
    ranking = np.arange(n, dtype=np.int32)[::-1].copy()
    src.refresh(torch.from_numpy(ranking) if as_tensor else ranking)
    assert not torch.equal(src.posmap, before)
    cached = ranking[: src.num_cache]
    assert torch.equal(src.posmap[torch.from_numpy(cached).long()],
                       torch.arange(src.num_cache, dtype=torch.int32))
    np.testing.assert_array_equal(src.cache_feat.numpy(), feat[cached])
    ids = np.full(128, EMPTY_KEY, np.int32)
    ids[:96] = np.arange(0, n, n // 96)[:96]
    out, info = src.extract(torch.from_numpy(ids), 96)
    np.testing.assert_array_equal(out.numpy()[:96], feat[ids[:96]])
    assert int(info["num_hit"]) == int((ids[:96] >= n - src.num_cache).sum())


def test_cached_training_trajectory_matches_jax_engine(learn_ds):
    """>= 20 steps of the JAX Engine with the tiered store (cache 0.2,
    pre_sample, non-direct extract, pipeline off) against the port's
    sampler (same uniforms), TieredFeatureSource (its ranking from the
    port's own presample), converted weights, loss and Adam: blocks and
    the extracted x equal every step (x does not depend on which rows are
    cached), losses within rtol/atol 2e-3 as in the slice's trajectories."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.engine import Engine as JEngine
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler
    from xgnn_tpu.store.feature_store import TieredFeatureSource as JTiered
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.store import LabelSource, TieredFeatureSource
    from xgnn_tpu_torch.store.presample import presample_ranking
    from xgnn_tpu_torch.store.ranking import build_ranking
    from xgnn_tpu_torch.train import Adam, train_step
    from xgnn_tpu_torch.types import Graph

    ds = learn_ds
    common = dict(batch_size=len(ds.train_set) // 21, fanout=(5, 4, 3),
                  num_layer=3, num_hidden=16, model="graphsage",
                  sample_type="khop3", dropout=0.0, lr=0.01, pipeline=False,
                  gpu_extract=True, cache_percentage=0.2,
                  cache_policy="pre_sample", presample_epoch=1)
    engine = JEngine(ds, JConfig(**common, num_epoch=1)).init()
    assert isinstance(engine.feature_source, JTiered)
    assert not engine._direct
    params_np = jax.tree.map(np.asarray, engine.state.params)

    cfg = RunConfig(**common, frontier_capacities=engine.sampler.capacities)
    sampler = Sampler(Graph.from_dataset(ds, "cpu"), cfg,
                      direct_extract=False)
    freq = presample_ranking(sampler, ds.train_set, cfg, ds.num_node, "cpu")
    store = TieredFeatureSource(ds.feat, build_ranking(ds, cfg, freq), 0.2,
                                "cpu")
    labels_src = LabelSource(ds.label, "cpu")
    model = build_model(cfg, ds.feat_dim, ds.num_class)
    model.load_state_dict(params_from_flax(params_np))
    opt = Adam(list(model.parameters()), cfg.lr)

    shuffler = JShuffler(ds.train_set, cfg.batch_size, seed=cfg.seed + 1)
    sample_base = jax.random.fold_in(engine._sample_key, 0)
    drop_base = jax.random.fold_in(engine._dropout_key, 0)
    state = engine.state
    jax_losses, port_losses, hits, misses = [], [], 0, 0
    for step, (seeds, n) in enumerate(shuffler.epoch_batches(0)):
        key = jax.random.fold_in(sample_base, step)
        batch, x, labels, info, _ = engine._produce(
            ((seeds, n), key, (0, step)))
        assert not bool(info["overflow"])  # the bucket holds every miss
        state, metrics = engine._train_step(
            state, batch.blocks, x, labels, batch.num_output,
            jax.random.fold_in(drop_base, step), batch.overflow,
        )
        jax_losses.append(metrics["loss"])

        us = _layer_uniforms(key, [len(seeds)] + sampler.capacities[1:-1],
                             sampler.fanouts)
        pbatch = sampler.sample(_t(seeds), n, u=us)
        _assert_same_batch(pbatch, batch)
        px, pinfo = store.extract(pbatch.input_nodes, pbatch.num_input)
        num_input = int(pbatch.num_input)
        np.testing.assert_array_equal(px.numpy()[:num_input],
                                      np.asarray(x)[:num_input])
        hits += int(pinfo["num_hit"])
        misses += int(pinfo["num_miss"])
        plabels = labels_src.extract(pbatch.output_nodes, pbatch.num_output)
        m = train_step(model, opt, pbatch.blocks, px, plabels,
                       pbatch.num_output, None, pbatch.overflow)
        port_losses.append(float(m["loss"]))
    jax_losses = np.asarray(jnp.stack(jax_losses))
    assert len(port_losses) >= 20
    assert np.isfinite(jax_losses).all()
    assert jax_losses[-1] < jax_losses[0] * 0.9  # it really learns
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-3, atol=2e-3)
    assert 0 < hits / (hits + misses) < 1


@pytest.mark.parametrize("policy", ["pre_sample", "presample_static",
                                    "degree", "dynamic_cache", "heuristic",
                                    "degree_hop", "random", "fake_optimal"])
def test_port_engine_learns_with_the_tiered_store(learn_ds, policy):
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.store import (
        DynamicTieredFeatureSource,
        TieredFeatureSource,
    )

    cfg = RunConfig(batch_size=64, fanout=(5, 4, 3), num_hidden=16, lr=0.01,
                    calibration_batches=2, cache_percentage=0.2,
                    cache_policy=policy)
    engine = Engine(Dataset.from_arrays(learn_ds), cfg, device="cpu").init()
    assert not engine._direct
    want = (DynamicTieredFeatureSource if policy == "dynamic_cache"
            else TieredFeatureSource)
    assert type(engine.feature_source) is want
    posmap = engine.feature_source.posmap.clone()
    results = [engine.train_epoch(e) for e in range(2)]
    losses = [r["loss"] for r in results]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for e, r in enumerate(results):
        assert 0 < r["hit_rate"] <= 1
        hist = engine.history[e]
        assert r["hit_rate"] == pytest.approx(
            hist["hit"].sum() / (hist["hit"].sum() + hist["miss"].sum()))
    refreshed = not torch.equal(engine.feature_source.posmap, posmap)
    assert refreshed == (policy == "dynamic_cache")
    if policy == "dynamic_cache":
        # the refresh took the hottest rows by the engine's running counts
        top = set(torch.topk(engine._dyn_freq, engine.feature_source.num_cache)
                  .indices.tolist())
        cached = set((engine.feature_source.posmap != EMPTY_KEY).nonzero()
                     .flatten().tolist())
        assert cached == top
        ids = torch.arange(64, dtype=torch.int32)
        out, _ = engine.feature_source.extract(ids, 64)
        np.testing.assert_array_equal(out.numpy(), learn_ds.feat[:64])


@pytest.mark.parametrize("barriered_epoch,refreshes", [(-1, [True, True]),
                                                       (1, [False, True])])
def test_dynamic_refresh_follows_barriered_epoch(learn_ds, barriered_epoch,
                                                 refreshes):
    from xgnn_tpu_torch import Engine, RunConfig

    cfg = RunConfig(batch_size=128, fanout=(4, 3), num_layer=2, num_hidden=8,
                    calibration_batches=1, cache_percentage=0.2,
                    cache_policy="dynamic_cache", pipeline=False,
                    barriered_epoch=barriered_epoch)
    engine = Engine(Dataset.from_arrays(learn_ds), cfg, device="cpu").init()
    seen = []
    for e in range(2):
        before = engine.feature_source.cache_feat
        engine.train_epoch(e)
        seen.append(engine.feature_source.cache_feat is not before)
    assert seen == refreshes
