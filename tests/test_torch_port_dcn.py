"""DCN groups in the collocated multi-card port, the multi-card placement
solve and K10's ``unique_ordered``, against the JAX package.

DCN groups (``num_dcn_groups``, JAX's ``make_mesh_2d``): the stores are
partitioned over a group's cards and repeated in every group, the
exchanges stay in the group and the gradients are reduced over every card.
One spawn of four gloo ranks (``tests/torch_dcn_ranks.py``, under its own
time limit) holds the port at 2 x 2 against JAX over 4 of the 8 CPU
devices with ``make_mesh_2d(2, devices[:4])``: the rank-to-(group, part)
map at (2, 2) and (4, 1), the exact presample_static counts of
``MultiChipEngine(num_dcn_groups=2)`` on both topologies (bit-equal to
JAX's and to the port's flat mesh of four), one collocated step's
seed-weighted gradient (JAX's weighted reduction of ``jax.grad`` over each
rank's batch), the engine in both execution shapes on each topology (the
two-phase GGMS with the host cold tier as JAX's
``test_hierarchical_two_phase_ggms``, an overflow replay), and
``auto_placement`` for a group of two (each rank's solved fields equal
JAX's ``resolve_auto_placement``).  ``unique_ordered`` is held to JAX's in
this process.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.config import RunConfig as JRunConfig  # noqa: E402
from xgnn_tpu.constants import EMPTY_KEY as EMPTY  # noqa: E402

import torch_dcn_ranks as ranks  # noqa: E402
from xgnn_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SPAWN_S = 150  # the spawn's time limit
WORLD = 4
PCT = 0.6  # the share of the edges in the hot prefix (JAX's test's)


@pytest.fixture(scope="module")
def graph():
    return jsyn.make_synthetic_dataset(num_node=600, avg_degree=6,
                                       feat_dim=12, num_class=5, seed=4,
                                       planted_signal=2.0, train_frac=0.4)


def _ds_arrays(ds):
    return {k: getattr(ds, k) for k in (
        "name", "num_node", "num_edge", "feat_dim", "num_class", "indptr",
        "indices", "feat", "label", "train_set", "valid_set", "test_set")}


def _config(groups, **kw):
    """A 2-layer GraphSAGE over four ranks in ``groups`` DCN groups; keys
    both packages' RunConfig take."""
    cfg = dict(model="graphsage", sample_type="khop3", batch_size=32,
               fanout=(4, 3), num_layer=2, num_hidden=16, lr=0.03,
               dropout=0.0, num_worker=WORLD, num_dcn_groups=groups,
               part_cache=True, calibration_batches=2, seed=11,
               root_path="/tmp")
    cfg.update(kw)
    return cfg


EXACT = dict(use_dist_graph=True, cache_percentage=0.2,
             cache_policy="presample_static", presample_epoch=1,
             calibration_batches=0)
ENGINES = {
    # JAX's test_hierarchical_two_phase_ggms: the hot prefix, the host
    # cold tier, a partial partitioned cache, three epochs
    "ggms_tier": (dict(use_dist_graph=True, dist_graph_percentage=PCT,
                       cache_percentage=0.25, cache_policy="pre_sample",
                       presample_epoch=1), 3),
    "fused_replicated": (dict(), 2),
    "fused_partitioned_device_loop": (dict(use_dist_graph=True,
                                           device_loop=True), 2),
    "fused_tier": (dict(use_dist_graph=True, dist_graph_percentage=PCT), 2),
    "sgnn_replicated": (dict(part_cache=False, cache_percentage=0.3,
                             cache_policy="degree"), 2),
    "static": (dict(use_dist_graph=True, cache_percentage=0.3,
                    cache_policy="presample_static"), 2),
    # tiny capacities: every rank skips the overflowed steps and replays
    "tiny": (dict(use_dist_graph=True, frontier_capacities=[32, 64, 128],
                  exchange_headroom=0.05, calibration_batches=0), 1),
}
# the same runs on the flat mesh of four, where the batches are the same
FLAT = ("fused_replicated", "sgnn_replicated")


def _auto_budget(ds):
    """JAX's test_auto_placement_multi_chip's budget: a partial cache."""
    return 0.35 * (ds.num_node * ds.feat.shape[1] * 4
                   + ds.num_edge * 4) / (1 << 30)


def _flax_params(ds, hidden):
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu.types import Block as JBlock

    model = JGNN(conv="graphsage", hidden_dim=hidden, out_dim=ds.num_class,
                 num_layers=2, dropout=0.0)
    blocks = [JBlock(neigh=jnp.zeros((8, 4), jnp.int32),
                     num_dst=jnp.int32(8), num_src=jnp.int32(8)),
              JBlock(neigh=jnp.zeros((4, 3), jnp.int32),
                     num_dst=jnp.int32(4), num_src=jnp.int32(8))]
    params = model.init({"params": jax.random.key(3)}, blocks,
                        jnp.zeros((8, ds.feat_dim)), False)["params"]
    return model, params


@pytest.fixture(scope="module")
def suite(graph):
    """The port's results on each of the four ranks, in one spawn."""
    ds = graph
    arrays = _ds_arrays(ds)
    rng = np.random.default_rng(27)
    train = np.asarray(ds.train_set, np.int32)
    seeds = np.full((WORLD, 64), EMPTY, np.int32)
    nums = []
    for r in range(WORLD):
        # the last rank's shard is exhausted: it weighs nothing
        k = 0 if r == WORLD - 1 else 64 - 9 * r
        seeds[r, :k] = rng.choice(train, k, replace=False)
        nums.append(k)
    model, params = _flax_params(ds, 8)
    step = {"config": dict(model="graphsage", batch_size=64, fanout=(4, 3),
                           num_layer=2, num_hidden=8, dropout=0.0, lr=0.01,
                           num_worker=WORLD, num_dcn_groups=2,
                           use_dist_graph=True, part_cache=True),
            "seeds": seeds, "num_seed": np.asarray(nums),
            "caps": [64, 320, 600], "seg_cap": 600, "groups": 2,
            "num_class": ds.num_class,
            "params": jax.tree.map(np.asarray, params)}
    engines = {}
    for name, (kw, epochs) in ENGINES.items():
        engines[name] = (_config(2, **kw), epochs)
        if name in FLAT:
            engines[f"{name}_flat"] = (_config(1, **kw), epochs)
    engines["auto_placement"] = (_config(
        2, auto_placement=True, hbm_budget_gb=_auto_budget(ds)), 1)
    engines["groups_of_one"] = (_config(4, use_dist_graph=True), 1)
    data = {"groups": (2, 4), "ds": arrays,
            "feat": np.asarray(ds.feat, np.float32),
            "label": np.asarray(ds.label, np.int32),
            "csr": {"indptr": ds.indptr, "indices": ds.indices},
            "exact": {f"{top}_{groups}": _config(
                groups, **dict(EXACT, use_dist_graph=top == "partitioned"))
                for top in ("partitioned", "replicated")
                for groups in (1, 2)},
            "step": step, "engines": engines}
    outs = pmesh.spawn(ranks.suite, WORLD, data, device="cpu",
                       timeout=SPAWN_S)
    return data, outs, (model, params)


def _jax_steps(ds, batch_size, seed):
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler

    return max(JShuffler(np.asarray(ds.train_set), batch_size,
                         num_worker=WORLD, worker_id=w,
                         seed=seed + 1).num_local_step for w in range(WORLD))


# ----------------------------------------------------------------- mesh
@pytest.mark.parametrize("groups", [2, 4], ids=["2x2", "4x1"])
def test_mesh_2d_rank_map_matches_jax(suite, groups):
    """World rank r is at JAX's device r's (group, part) of
    ``make_mesh_2d(groups, devices[:4])``; a group's all_reduce sums its
    own ranks, the world's every rank."""
    from xgnn_tpu.parallel.mesh import make_mesh_2d

    _, outs, _ = suite
    jmesh = make_mesh_2d(groups, jax.devices()[:WORLD])
    g = WORLD // groups
    assert jmesh.devices.shape == (groups, g)
    where = {d.id: (int(i), int(j)) for (i, j), d in
             np.ndenumerate(jmesh.devices)}
    for r in range(WORLD):
        group, part, size, inside, every = outs[r]["map"][groups]
        assert (group, part) == where[jax.devices()[r].id]
        assert size == g
        assert inside == sum(range(group * g, (group + 1) * g))
        assert every == sum(range(WORLD))


# ------------------------------------------------------ exact presample
@pytest.mark.parametrize("topology", ["partitioned", "replicated"])
def test_exact_presample_counts_match_jax_and_the_flat_mesh(suite, graph,
                                                            topology):
    """MultiChipEngine(num_dcn_groups=2)'s presample_static counts (a
    closure within each group, then the sum over the groups) equal JAX's
    engine's bit for bit, and the port's flat mesh of four ranks'."""
    from xgnn_tpu.engine.multi_engine import MultiChipEngine as JEngine

    data, outs, _ = suite
    hier = data["exact"][f"{topology}_2"]
    jeng = JEngine(graph, JRunConfig(**hier),
                   devices=jax.devices()[:WORLD]).init()
    assert jeng.num_groups == 2 and jeng.num_parts == 2
    want = np.asarray(jeng._presample_and_calibrate())
    assert want.sum() > 0
    for r in range(WORLD):
        got = outs[r]["exact"][f"{topology}_2"]
        flat = outs[r]["exact"][f"{topology}_1"]
        np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        np.testing.assert_array_equal(flat, want, err_msg=f"rank {r}")


# ------------------------------------------------------ collocated step
def test_collocated_step_matches_jax_weighted_reduction(suite, graph):
    """At 2 x 2 the exchanges stay in the group and the reduction spans
    the four ranks: the gradients equal JAX's ``sum_r(w_r g_r) /
    sum_r(w_r)`` over the four ranks' batches (``g_r`` jax.grad of the flax
    model, ``w_r`` the seed count; rank 3 has none) within 1e-5, the loss
    likewise, every rank holds the same update, and the fused step equals
    its pieces."""
    from xgnn_tpu.train import loss_fn
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.convert import params_from_flax

    ds = graph
    data, outs, (model, params) = suite
    feat = np.asarray(ds.feat, np.float32)
    label = np.asarray(ds.label, np.int32)
    total, wsum, loss_sum = None, 0.0, 0.0
    for r in range(WORLD):
        b = outs[r]["step"][0]
        ids = b["input_nodes"]
        x = np.where((ids != EMPTY)[:, None],
                     feat[np.where(ids == EMPTY, 0, ids)], 0.0)
        blocks = []
        for i, neigh in enumerate(b["neigh"]):
            num_dst = (b["num_src"][i + 1] if i + 1 < len(b["neigh"])
                       else b["num_output"])
            blocks.append(JBlock(neigh=jnp.asarray(neigh),
                                 num_dst=jnp.int32(num_dst),
                                 num_src=jnp.int32(b["num_src"][i])))
        seeds = data["step"]["seeds"][r]
        lab = label[np.where(seeds == EMPTY, 0, seeds)]
        n = int(b["num_output"])
        assert n == data["step"]["num_seed"][r]
        np.testing.assert_array_equal(b["labels"][:n], lab[:n])

        def jloss(prm):
            logits = model.apply({"params": prm}, blocks, jnp.asarray(x),
                                 False)
            return loss_fn(logits, jnp.asarray(b["labels"]),
                           jnp.int32(b["num_output"]))[0]

        loss_r, g = jax.value_and_grad(jloss)(params)
        w = float(n)
        total = jax.tree.map(lambda a: a * w, g) if total is None else \
            jax.tree.map(lambda t, a: t + a * w, total, g)
        wsum += w
        loss_sum += float(loss_r) * w
    want = params_from_flax(jax.tree.map(
        np.asarray, jax.tree.map(lambda t: t / max(wsum, 1.0), total)))
    for r in range(WORLD):
        b, fused = outs[r]["step"]
        assert not b["skip"] and not fused["overflow"]
        np.testing.assert_allclose(b["loss"], loss_sum / wsum, rtol=1e-5)
        np.testing.assert_allclose(fused["loss"], b["loss"], rtol=1e-6)
        for name, g in b["grads"].items():
            np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        for name, v in b["params"].items():
            np.testing.assert_array_equal(v, outs[0]["step"][0]["params"][
                name])
            np.testing.assert_allclose(fused["params"][name], v, rtol=1e-6,
                                       atol=1e-7, err_msg=name)


# -------------------------------------------------------------- engines
def test_two_phase_ggms_with_cold_tier_learns(suite, graph):
    """JAX's test_hierarchical_two_phase_ggms at 2 x 2: the hot prefix
    partitioned over each group with the host cold tier, a partial cache
    partitioned over each group; JAX's step count over four lanes, finite
    losses falling over three epochs, a hit rate inside (0, 1), equal
    parameters on every rank."""
    _, outs, _ = suite
    steps = _jax_steps(graph, 32, 11)
    for o in outs:
        e = o["engines"]["ggms_tier"]
        rs = e["epochs"]
        assert e["two_phase"] and e["num_parts"] == 2
        assert e["ncn"] is not None and 0 < e["ncn"] < graph.num_node
        assert [r["steps"] for r in rs] == [steps] * 3
        assert all(np.isfinite(r["loss"]) for r in rs)
        assert rs[-1]["loss"] < rs[0]["loss"] * 0.9, rs
        assert 0.05 < rs[-1]["hit_rate"] < 0.999
        assert np.isfinite(e["acc"]) and e["acc"] > 0.0
    for k, v in outs[0]["engines"]["ggms_tier"]["params"].items():
        for o in outs[1:]:
            np.testing.assert_array_equal(v, o["engines"]["ggms_tier"][
                "params"][k])


@pytest.mark.parametrize("name", [n for n in ENGINES
                                  if n not in ("ggms_tier", "tiny")]
                         + ["groups_of_one"])
def test_engine_trains_in_both_shapes_on_each_topology(suite, graph, name):
    """The fused store (replicated, partitioned under device_loop, with the
    cold tier; four groups of one) and the two-phase store (SGNN's cache on
    the replicated topology, presample_static) at 2 x 2: finite losses that
    fall, every rank's part and parameters, a valid accuracy."""
    _, outs, _ = suite
    steps = _jax_steps(graph, 32, 11)
    groups = 4 if name == "groups_of_one" else 2
    parts = set()
    for o in outs:
        e = o["engines"][name]
        rs = e["epochs"]
        assert e["num_parts"] == WORLD // groups
        parts.add(e["part"])
        assert all(r["steps"] == steps for r in rs)
        assert all(np.all(np.isfinite(l)) for l in e["losses"])
        if len(rs) > 1:
            assert rs[-1]["loss"] < rs[0]["loss"], rs
        assert 0.0 <= e["acc"] <= 1.0
        assert (e["ncn"] is not None) == (name == "fused_tier")
        for k, v in e["params"].items():
            np.testing.assert_array_equal(v, outs[0]["engines"][name][
                "params"][k])
    assert parts == set(range(WORLD // groups))


@pytest.mark.parametrize("name", FLAT)
def test_replicated_topology_equals_the_flat_mesh(suite, name):
    """Over the replicated topology a rank samples its own batch, so the
    groups change only which ranks an exchange spans: the per-step losses
    at 2 x 2 equal the flat mesh of four's."""
    _, outs, _ = suite
    for o in outs:
        for a, b in zip(o["engines"][name]["losses"],
                        o["engines"][f"{name}_flat"]["losses"]):
            np.testing.assert_allclose(a, b, rtol=1e-6)


def test_overflow_replays_on_every_rank(suite, graph):
    """Tiny capacities overflow at 2 x 2: every rank skips the same steps,
    grows the same capacities and replays them, so no step is lost."""
    _, outs, _ = suite
    steps = _jax_steps(graph, 32, 11)
    caps = outs[0]["engines"]["tiny"]["caps"]
    assert caps[-1] > 128
    for o in outs:
        e = o["engines"]["tiny"]
        r = e["epochs"][0]
        assert r["contributed_steps"] == r["steps"] == steps, r
        assert np.isfinite(r["loss"])
        assert e["caps"] == caps and e["seg_cap"] == outs[0]["engines"][
            "tiny"]["seg_cap"]


def test_auto_placement_matches_jax(suite, graph):
    """auto_placement through MultiChipEngine solves for a group of two
    cards: every rank's solved fields equal JAX's ``resolve_auto_placement
    (config, ds, group_size=2)`` at JAX's test's budget, and an epoch
    trains."""
    from xgnn_tpu.parallel.placement import resolve_auto_placement

    data, outs, _ = suite
    cfg, _ = data["engines"]["auto_placement"]
    jcfg, _ = resolve_auto_placement(JRunConfig(**cfg), graph, group_size=2)
    want = (jcfg.use_dist_graph, jcfg.dist_graph_percentage,
            jcfg.cache_percentage)
    assert 0.0 < want[2] < 1.0  # the budget leaves a partial cache
    for o in outs:
        e = o["engines"]["auto_placement"]
        assert e["plan"] and tuple(e["placement"]) == want
        assert e["two_phase"]
        assert np.isfinite(e["epochs"][0]["loss"])


def test_num_worker_not_a_multiple_of_the_groups_raises(graph):
    """As JAX asserts, before any process group is made."""
    import torch.distributed as dist

    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    with pytest.raises(ValueError, match="num_dcn_groups=2"):
        MultiChipEngine(Dataset(**_ds_arrays(graph)),
                        RunConfig(**_config(2, num_worker=1)), device="cpu")
    assert not dist.is_initialized()


# ------------------------------------------------------------------ K10
@pytest.mark.parametrize("n,vocab,empty_frac,cap", [
    (64, 16, 0.0, 24), (256, 50, 0.3, 58), (1000, 999, 0.1, 1007),
    (300, 300, 0.2, 40), (7, 5, 1.0, 4), (1, 3, 0.0, 1)],
    ids=["dense", "empties", "wide", "over_cap", "all_empty", "one"])
def test_unique_ordered_matches_jax(n, vocab, empty_frac, cap):
    """Unique ids in first-occurrence order, their count (past ``cap``
    where it overflows) and every input's local id, equal to JAX's."""
    from xgnn_tpu.ops.unique import unique_ordered as jax_unique
    from xgnn_tpu_torch.ops import unique_ordered

    for seed in range(3):
        rng = np.random.default_rng(seed)
        ids = rng.integers(0, vocab, n).astype(np.int32)
        ids[rng.random(n) < empty_frac] = EMPTY
        want = [np.asarray(a) for a in jax_unique(jnp.asarray(ids), cap)]
        got = [a.numpy() for a in unique_ordered(torch.from_numpy(ids),
                                                 cap)]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        if n > cap and vocab > cap and empty_frac < 1.0:
            assert int(got[1]) > cap  # overflow is reported
