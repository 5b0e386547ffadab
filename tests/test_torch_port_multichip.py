"""The collocated multi-card port (XGNN's arch6) against the JAX package.

K13-plan's plain version against JAX's ``plan_exchange``; the host-side
partitioning; the exchange, the partitioned sampling layer of every sample
type and the partitioned walk at P = 2 and 4 over gloo ranks (each a
process of its own, ``tests/torch_multichip_ranks.py``) against JAX's
functions inside ``shard_map`` over P of the 8 CPU devices or against the
unpartitioned samplers with the same uniforms; the collocated step against
JAX's weighted reduction of ``jax.grad`` over each rank's batch; and
``MultiChipEngine`` and the command line at P = 1 and 2.  Every spawn of
ranks joins them under its own time limit and fails if one hangs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.constants import EMPTY_KEY as EMPTY  # noqa: E402
from xgnn_tpu.ops import sampling as jsampling  # noqa: E402
from xgnn_tpu.ops.tiled import pad_tile  # noqa: E402
from xgnn_tpu.parallel import dist_topology as jdt  # noqa: E402
from xgnn_tpu.parallel import exchange as jex  # noqa: E402
from xgnn_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402

import torch_multichip_ranks as ranks  # noqa: E402
from xgnn_tpu_torch.parallel import dist_topology, exchange  # noqa: E402
from xgnn_tpu_torch.parallel import mesh as pmesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 150  # each spawn's time limit
K = 4
TYPES = ("uniform_wr", "khop0", "khop1", "khop2", "khop3", "weighted_khop",
         "weighted_khop_prefix", "weighted_khop_hash_dedup")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _uniforms(rng, shape):
    """float32 uniforms with both ends of [0, 1) among them."""
    u = rng.random(shape, dtype=np.float32)
    u.flat[::13] = 0.0
    u.flat[5::11] = np.float32(1.0) - np.float32(2.0 ** -24)
    return u


def _frontier(rng, n, num_node):
    f = rng.integers(0, num_node, n).astype(np.int32)
    f[::9] = EMPTY
    f[-5:] = EMPTY
    return f


@pytest.fixture(scope="module")
def graph():
    ds = jsyn.make_synthetic_dataset(num_node=600, avg_degree=6,
                                     feat_dim=12, num_class=5, seed=4,
                                     planted_signal=2.0, train_frac=0.4)
    jsyn.build_alias_tables(ds, seed=4)
    return ds


# ------------------------------------------------------------- K13-plan
@pytest.mark.parametrize("num_parts", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("seg_cap", [9, 700])
def test_plan_exchange_plain_matches_jax(num_parts, seg_cap):
    """send, owner, rank and overflow exactly; pick is JAX's linear slot
    where the request is valid and in its segment, EMPTY elsewhere."""
    rng = np.random.default_rng(num_parts * 31 + seg_cap)
    ids = _frontier(rng, 600, 5000)
    js, jo, jr, jof = jex.plan_exchange(jnp.asarray(ids), num_parts, seg_cap)
    plan = exchange.plan_exchange_plain(_t(ids), num_parts, seg_cap,
                                       ranks=True)
    np.testing.assert_array_equal(plan.send.numpy(), np.asarray(js))
    np.testing.assert_array_equal(plan.owner.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(plan.rank.numpy(), np.asarray(jr))
    assert bool(plan.overflow) == bool(jof)
    jo, jr = np.asarray(jo), np.asarray(jr)
    ok = (jo < num_parts) & (jr < seg_cap)
    np.testing.assert_array_equal(
        plan.pick.numpy(), np.where(ok, jo * seg_cap + jr, EMPTY))
    if seg_cap == 9:
        assert bool(jof)


@pytest.mark.parametrize("num_parts", [1, 3, 4])
def test_shard_interleaved_matches_jax(num_parts):
    x = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    want = jex.shard_interleaved(x, num_parts)
    np.testing.assert_array_equal(exchange.shard_interleaved(x, num_parts),
                                  want)
    for p in range(num_parts):
        np.testing.assert_array_equal(
            exchange.interleaved_part(x, num_parts, p), want[p])
        np.testing.assert_array_equal(
            exchange.interleaved_part(_t(x), num_parts, p).numpy(), want[p])


@pytest.mark.parametrize("num_parts", [1, 2, 4])
@pytest.mark.parametrize("num_cache_node", [None, 437])
def test_partition_csr_host_matches_jax(graph, num_parts, num_cache_node):
    """Offsets, neighbour ids, the three weighted tables and the coarse
    CDF, part for part; JAX's arrays carry tile padding past the port's
    (the repeated last offset, zeros)."""
    ds = graph
    tables = dict(prob=ds.prob_table, alias=ds.alias_table,
                  prefix=ds.prob_prefix_table)
    want = jdt.partition_csr_host(ds.indptr, ds.indices, num_parts,
                                  num_cache_node=num_cache_node, **tables)
    got = dist_topology.partition_csr_host(ds.indptr, ds.indices, num_parts,
                                           num_cache_node, **tables)
    rows = got.indptr.shape[1]
    np.testing.assert_array_equal(got.indptr, want.indptr[:, :rows])
    assert (want.indptr[:, rows:] == want.indptr[:, rows - 1:rows]).all()
    width = got.indices.shape[1]
    for name in ("indices", "prob", "alias", "prefix"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g, w[:, :width])
        assert not w[:, width:].any()
    np.testing.assert_array_equal(got.coarse, want.coarse)


# ------------------------------------------------------- owner sampling
def _jax_part(ds, num_parts, part):
    lt = jdt.partition_csr_host(ds.indptr, ds.indices, num_parts,
                                prob=ds.prob_table, alias=ds.alias_table,
                                prefix=ds.prob_prefix_table)
    return {k: None if v is None else jnp.asarray(v[part])
            for k, v in lt._asdict().items()}


def _draws(st, rng, n):
    """(u, coin) in the shapes the samplers take."""
    if st == "weighted_khop_hash_dedup":
        w = jsampling.HASH_DEDUP_ROUNDS * K
        return _uniforms(rng, (n, w)), _uniforms(rng, (n, w))
    if st == "weighted_khop":
        return _uniforms(rng, (n, K)), _uniforms(rng, (n, K))
    return _uniforms(rng, (n, K)), None


def _jax_sample(st, g, frontier, u, coin, max_deg):
    """JAX's sampler of ``st`` over the CSR ``g`` with ``u`` (and
    ``coin``)."""
    f = jnp.asarray(frontier)
    u = jnp.asarray(u)
    if st == "uniform_wr":
        return jsampling.sample_uniform_wr(g["indptr"], g["indices"], f, K,
                                           u=u)
    if st in ("khop0", "khop1", "khop2", "khop3"):
        fn = getattr(jsampling, f"sample_{st}")
        return fn(g["indptr"], g["indices"], f, K, u=u)
    if st == "weighted_khop_prefix":
        return jsampling.sample_weighted_khop_prefix(
            g["indptr"], g["indices"], g["prefix"], f, K, max_deg=max_deg,
            coarse_cdf=g["coarse"], u=u)
    fn = (jsampling.sample_weighted_khop if st == "weighted_khop"
          else jsampling.sample_weighted_khop_hash_dedup)
    return fn(g["indptr"], g["indices"], g["prob"], g["alias"], f, K, u=u,
              coin=jnp.asarray(coin))


@pytest.mark.parametrize("st", TYPES)
def test_owner_sample_matches_jax_sampler_on_local_csr(graph, st):
    """An owner's picks (part 1 of 2) equal JAX's sampler over that
    owner's local CSR with the same uniforms."""
    ds = graph
    part = dist_topology.partition_part(
        _t(ds.indptr).long(), _t(ds.indices), 2, 1, prob=_t(ds.prob_table),
        alias=_t(ds.alias_table), prefix=_t(ds.prob_prefix_table))
    rng = np.random.default_rng(len(st))
    req = _frontier(rng, 300, ds.num_node)
    req = np.where(req == EMPTY, EMPTY, req - req % 2 + 1).astype(np.int32)
    req[req >= ds.num_node] = EMPTY
    u, coin = _draws(st, rng, req.shape[0])
    kind = st if st == "uniform_wr" else dist_topology.SampleType(st)
    got = dist_topology.owner_sample(part, _t(req), K, kind, u=_t(u),
                                     coin=None if coin is None else _t(coin))
    local = np.where(req == EMPTY, EMPTY, req // 2).astype(np.int32)
    want = _jax_sample(st, _jax_part(ds, 2, 1), local, u, coin,
                       part.max_deg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_owner_sample_duplicate_requests_independent(graph):
    """Duplicate requests draw independently (as JAX's slot term makes
    them), so walkers parked at one node do not move as one."""
    ds = graph
    part = dist_topology.partition_part(_t(ds.indptr).long(),
                                        _t(ds.indices), 1, 0)
    nodes = np.where(np.diff(ds.indptr) >= 8)[0][:64].astype(np.int32)
    out = dist_topology.owner_sample(
        part, _t(np.concatenate([nodes, nodes])), 4,
        dist_topology.SampleType.KHOP2,
        torch.Generator().manual_seed(0)).numpy().reshape(2, -1, 4)
    assert np.mean(np.any(out[0] != out[1], axis=1)) > 0.5


# ------------------------------------------------- the ranks' suite
def _suite_data(ds, num_parts):
    rng = np.random.default_rng(num_parts)
    n = 160
    data = {"feat": ds.feat.astype(np.float32),
            "label": np.asarray(ds.label, np.int32),
            "gather_ids": np.stack([_frontier(rng, n, ds.num_node)
                                    for _ in range(num_parts)]),
            "gather_segs": {"wide": 10_000, "overflow": 5},
            "fanout": K,
            "csr": {"indptr": ds.indptr, "indices": ds.indices,
                    "prob": ds.prob_table, "alias": ds.alias_table,
                    "prefix": ds.prob_prefix_table}}
    layers = {}
    for st in TYPES:
        fronts = [_frontier(rng, n, ds.num_node) for _ in range(num_parts)]
        req = [_draws(st, rng, n) for _ in range(num_parts)]
        # each request's uniforms in request order: the port sends them to
        # the owner with the request
        case = {"frontier": np.stack(fronts), "seg_cap": n,
                "u": [d[0] for d in req]}
        if req[0][1] is not None:
            case["coin"] = [d[1] for d in req]
        layers[st] = case
    data["layers"] = layers
    data["walk"] = {"frontier": np.stack([_frontier(rng, 40, ds.num_node)
                                          for _ in range(num_parts)]),
                    "fanout": 5, "w": 4, "l": 3, "seg_cap": 40}
    seeds = np.full((num_parts, 64), EMPTY, np.int32)
    nums = []
    train = np.asarray(ds.train_set, np.int32)
    for r in range(num_parts):
        # at P = 2 the second rank's shard is exhausted: it weighs nothing
        k = 0 if (num_parts == 2 and r == 1) else 64 - 9 * r
        seeds[r, :k] = train[r * 64:r * 64 + k]
        nums.append(k)
    data["step"] = {"config": dict(model="graphsage", batch_size=64,
                                   fanout=(4, 3), num_layer=2, num_hidden=8,
                                   dropout=0.0, lr=0.01, num_worker=num_parts,
                                   use_dist_graph=True, part_cache=True),
                    "seeds": seeds, "num_seed": np.asarray(nums),
                    "caps": [64, 320, 600], "seg_cap": 600,
                    "num_class": ds.num_class, "params": None}
    return data


def _flax_params(ds, cfg):
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu.types import Block as JBlock

    model = JGNN(conv="graphsage", hidden_dim=cfg["num_hidden"],
                 out_dim=ds.num_class, num_layers=2, dropout=0.0)
    blocks = [JBlock(neigh=jnp.zeros((8, 4), jnp.int32),
                     num_dst=jnp.int32(8), num_src=jnp.int32(8)),
              JBlock(neigh=jnp.zeros((4, 3), jnp.int32),
                     num_dst=jnp.int32(4), num_src=jnp.int32(8))]
    params = model.init({"params": jax.random.key(3)}, blocks,
                        jnp.zeros((8, ds.feat_dim)), False)["params"]
    return model, params


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def suite(request, graph):
    p = request.param
    data = _suite_data(graph, p)
    model, params = _flax_params(graph, data["step"]["config"])
    data["step"]["params"] = jax.tree.map(np.asarray, params)
    outs = pmesh.spawn(ranks.suite, p, data, device="cpu", timeout=SPAWN_S)
    return p, data, outs, (model, params)


def test_partitioned_gather_matches_jax(graph, suite):
    """Rows bit-equal and overflow flags equal to JAX's exchange inside
    shard_map over P CPU devices, wide and overflowing segments; the
    indirect form's picks address the same rows."""
    p, data, outs, _ = suite
    mesh = jax_mesh(p)
    parts = jex.shard_interleaved(data["feat"], p)
    for name, seg in data["gather_segs"].items():
        def fn(parts, ids):
            local = parts.reshape(parts.shape[1:])
            out, over = jex.partitioned_gather(local, ids.reshape(-1),
                                               "data", seg)
            buf, pick, _ = jex.partitioned_gather_indirect(
                local, ids.reshape(-1), "data", seg)
            return out[None], over[None], buf[None], pick[None]

        jout, jover, jbuf, jpick = (np.asarray(a) for a in jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(PS("data"), PS("data")),
            out_specs=(PS("data"),) * 4))(jnp.asarray(parts),
                                          jnp.asarray(data["gather_ids"])))
        assert bool(jover.any()) == (name == "overflow")
        for r in range(p):
            rows, of, buf, pick, of2 = outs[r][f"gather_{name}"]
            np.testing.assert_array_equal(rows, jout[r])
            assert bool(of) == bool(of2) == bool(jover[r])
            live = jpick[r] < jbuf.shape[1]
            np.testing.assert_array_equal(pick[live], jpick[r][live])
            assert (pick[~live] == EMPTY).all()
            np.testing.assert_array_equal(buf[pick[live]],
                                          jbuf[r][jpick[r][live]])


def test_partitioned_layer_matches_unpartitioned(graph, suite):
    """Every sample type: each rank's partitioned layer equals JAX's
    sampler over the whole CSR with the same uniforms for each request."""
    ds = graph
    p, data, outs, _ = suite
    whole = dict(indptr=jnp.asarray(pad_tile(ds.indptr,
                                             fill=int(ds.indptr[-1]))),
                 indices=jnp.asarray(pad_tile(ds.indices)),
                 prob=jnp.asarray(pad_tile(ds.prob_table)),
                 alias=jnp.asarray(pad_tile(ds.alias_table)),
                 prefix=jnp.asarray(pad_tile(ds.prob_prefix_table)))
    whole["coarse"] = jsampling.build_coarse_cdf(
        whole["indptr"], whole["prefix"], ds.num_node)
    max_deg = int(np.max(np.diff(ds.indptr)))
    for st in TYPES:
        case = data["layers"][st]
        for r in range(p):
            neigh, of = outs[r][f"layer_{st}"]
            assert not of
            want = _jax_sample(st, whole, case["frontier"][r],
                               case["u"][r],
                               case["coin"][r] if "coin" in case
                               else None, max_deg)
            np.testing.assert_array_equal(neigh, np.asarray(want),
                                          err_msg=f"{st} rank {r}")


def test_partitioned_walk_visits_true_walks(graph, suite):
    """At P > 1 each seed's top visits are distinct nodes within L hops of
    it (never the seed), with counts that sum to at most W * L."""
    ds = graph
    p, data, outs, _ = suite
    walk = data["walk"]
    adj = [set(ds.indices[ds.indptr[v]:ds.indptr[v + 1]].tolist())
           for v in range(ds.num_node)]
    for r in range(p):
        neigh, weights, of = outs[r]["walk"]
        assert not of
        for i, s in enumerate(walk["frontier"][r]):
            got = neigh[i][neigh[i] != EMPTY]
            if s == EMPTY:
                assert len(got) == 0
                continue
            reach, ring = set(), {int(s)}
            for _ in range(walk["l"]):
                ring = set().union(*(adj[v] for v in ring)) | {int(s)}
                reach |= ring
            assert set(got.tolist()) <= reach - {int(s)}
            assert len(set(got.tolist())) == len(got)
            assert weights[i].sum() <= walk["w"] * walk["l"]
            assert (weights[i][:len(got)] > 0).all()


def test_collocated_step_matches_jax_weighted_reduction(graph, suite):
    """The reduced gradients equal JAX's ``sum_r(w_r g_r) / sum_r(w_r)``
    (``g_r`` jax.grad of the flax model on rank r's batch, ``w_r`` its seed
    count; at P = 2 one rank has none) within 1e-5, the loss likewise;
    the Adam update matches optax's on that gradient; the fused step
    equals its pieces."""
    import optax

    from xgnn_tpu.train import loss_fn
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.convert import params_from_flax

    ds = graph
    p, data, outs, (model, params) = suite
    feat = np.asarray(ds.feat, np.float32)
    label = np.asarray(ds.label, np.int32)
    total, wsum, loss_sum = None, 0.0, 0.0
    for r in range(p):
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
        lab = np.where(seeds == EMPTY, 0, label[np.where(seeds == EMPTY, 0,
                                                         seeds)])
        np.testing.assert_array_equal(b["labels"][:b["num_output"]],
                                      lab[:b["num_output"]])

        def jloss(prm):
            logits = model.apply({"params": prm}, blocks, jnp.asarray(x),
                                 False)
            return loss_fn(logits, jnp.asarray(b["labels"]),
                           jnp.int32(b["num_output"]))[0]

        loss_r, g = jax.value_and_grad(jloss)(params)
        w = float(b["num_output"])
        total = jax.tree.map(lambda a: a * w, g) if total is None else \
            jax.tree.map(lambda t, a: t + a * w, total, g)
        wsum += w
        loss_sum += float(loss_r) * w
    grads = jax.tree.map(lambda t: t / max(wsum, 1.0), total)
    want = params_from_flax(jax.tree.map(np.asarray, grads))
    for r in range(p):
        b, fused = outs[r]["step"]
        assert not b["skip"] and not fused["overflow"]
        np.testing.assert_allclose(b["loss"], loss_sum / wsum, rtol=1e-5)
        np.testing.assert_allclose(fused["loss"], b["loss"], rtol=1e-6)
        for name, g in b["grads"].items():
            np.testing.assert_allclose(g, want[name].numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    tx = optax.adam(data["step"]["config"]["lr"])
    upd, _ = tx.update(grads, tx.init(params), params)
    new = params_from_flax(jax.tree.map(np.asarray,
                                        optax.apply_updates(params, upd)))
    for r in range(p):
        b, fused = outs[r]["step"]
        for name, v in b["params"].items():
            g = np.abs(want[name].numpy())
            firm = g > 1e-3  # Adam's first step is sign(g) where g ~ eps
            np.testing.assert_allclose(v[firm], new[name].numpy()[firm],
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            np.testing.assert_allclose(fused["params"][name], v, rtol=1e-6,
                                       atol=1e-7, err_msg=name)
        # every rank holds the same parameters
        for name, v in b["params"].items():
            np.testing.assert_array_equal(v, outs[0]["step"][0]["params"][
                name])


# ------------------------------------------------------- P = 1 in-process
@pytest.fixture()
def world_of_one():
    m = pmesh.make_mesh("cpu")
    yield m
    m.close()


def test_partitioned_walk_matches_sample_random_walk(graph, world_of_one):
    """At P = 1, fed the single-store walk's uniforms in request order,
    the partitioned walk equals the single-store walk (the port's, held to
    JAX's in tests/test_torch_port_walk.py)."""
    from xgnn_tpu_torch.ops.random_walk import sample_random_walk

    ds = graph
    rng = np.random.default_rng(5)
    b, w, l, fan = 50, 4, 3, 5
    frontier = rng.integers(0, ds.num_node, b).astype(np.int32)
    frontier[-6:] = EMPTY
    u_step = _uniforms(rng, (l, b, w))
    u_restart = _uniforms(rng, (l, b, w))
    topo = dist_topology.partition_part(_t(ds.indptr).long(),
                                        _t(ds.indices), 1, 0)
    steps = [_t(u_step[0])] + [_t(u_step[s].reshape(-1, 1))
                               for s in range(1, l)]
    got = dist_topology.sample_random_walk_partitioned(
        topo, _t(frontier), fan, world_of_one, b, num_random_walk=w,
        random_walk_length=l, restart_prob=0.5,
        u=(steps, _t(u_restart)))
    want = sample_random_walk(_t(ds.indptr.astype(np.int32)),
                              _t(ds.indices), _t(frontier), fan,
                              num_random_walk=w, random_walk_length=l,
                              restart_prob=0.5,
                              u=(_t(u_step), _t(u_restart)))
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert not got[2]


def _jax_steps(train_set, batch_size, num_parts, seed):
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler

    return max(JShuffler(np.asarray(train_set), batch_size,
                         num_worker=num_parts, worker_id=w,
                         seed=seed + 1).num_local_step
               for w in range(num_parts))


def _engine_config(num_worker, **kw):
    cfg = dict(model="graphsage", batch_size=96, fanout=(4, 3),
               num_layer=2, num_hidden=16, lr=0.01, num_worker=num_worker,
               arch="arch6", use_dist_graph=True, part_cache=True,
               calibration_batches=2, dropout=0.0)
    cfg.update(kw)
    return cfg


def _ds_arrays(ds):
    return {k: getattr(ds, k) for k in (
        "name", "num_node", "num_edge", "feat_dim", "num_class", "indptr",
        "indices", "feat", "label", "train_set", "valid_set", "test_set")}


@pytest.mark.parametrize("use_dist_graph", [True, False])
def test_multichip_engine_p1_learns(graph, use_dist_graph):
    """MultiChipEngine in a world of one in this process: JAX's step count,
    a falling loss and an accuracy over every valid node."""
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch import RunConfig

    ds = Dataset(**_ds_arrays(graph))
    cfg = RunConfig(**_engine_config(1, use_dist_graph=use_dist_graph))
    eng = MultiChipEngine(ds, cfg, device="cpu").init()
    try:
        rs = [eng.train_epoch(e) for e in range(4)]
        assert rs[0]["steps"] == _jax_steps(ds.train_set, 96, 1, cfg.seed)
        assert rs[-1]["loss"] < rs[0]["loss"] * 0.8, rs
        acc = eng.evaluate("valid")
        assert 0.0 <= acc <= 1.0
    finally:
        eng.close()


def test_multichip_engine_p2_learns_and_replays(graph):
    """At P = 2 over gloo ranks: JAX's step count, a falling loss, equal
    parameters on both ranks; tiny capacities overflow, grow and replay
    with no step lost, and the accuracy counts every valid node."""
    arrays = _ds_arrays(graph)
    cfg = _engine_config(2, seed=11)
    outs = pmesh.spawn(ranks.engine_run, 2, arrays, cfg, 3, device="cpu",
                       timeout=SPAWN_S)
    steps = _jax_steps(graph.train_set, 96, 2, 11)
    for o in outs:
        rs = o["epochs"]
        assert [r["steps"] for r in rs] == [steps] * 3
        assert rs[-1]["loss"] < rs[0]["loss"] * 0.8, rs
        assert all(r["contributed_steps"] == steps for r in rs)
        assert 0.0 <= o["acc"] <= 1.0
    for name, v in outs[0]["params"].items():
        np.testing.assert_array_equal(v, outs[1]["params"][name])
    tiny = _engine_config(2, frontier_capacities=[96, 128, 256],
                          exchange_headroom=0.05, calibration_batches=0)
    outs = pmesh.spawn(ranks.engine_run, 2, arrays, tiny, 1, device="cpu",
                       timeout=SPAWN_S)
    for o in outs:
        r = o["epochs"][0]
        assert r["contributed_steps"] == r["steps"] == steps, r
        assert np.isfinite(r["loss"])
        assert o["caps"][-1] > 256
        assert 0.0 <= o["acc"] <= 1.0


# ------------------------------------------------------- the command line
def test_cli_arch6_two_ranks_prints_results():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "xgnn_tpu_torch.examples.train", "--cpu",
         "--synthetic", "--synthetic-nodes", "2000", "--arch", "arch6",
         "--num-worker", "2", "--part-cache", "--use-dist-graph",
         "--num-epoch", "2", "--batch-size", "200", "--fanout", "5", "3",
         "--num-hidden", "16", "--report-acc", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=SPAWN_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "config:arch=collocated" in lines
    assert "config:num_worker=2" in lines
    results = dict(l.split("=", 1) for l in lines
                   if l.startswith("test_result:"))
    for key in ("test_result:epoch_time:train_total",
                "test_result:final_train_acc", "test_result:test_acc"):
        assert np.isfinite(float(results[key])), key


@pytest.mark.parametrize("flags", [
    ["--num-worker", "2", "--cache-percentage", "0.3", "--cache-policy",
     "presample_static"],
    ["--num-worker", "2", "--use-dist-graph", "--dist-graph-percentage",
     "0.85"],
    ["--arch", "arch5"],
    ["--num-sample-worker", "1", "--num-train-worker", "2"],
    # on the CPU the placement solve needs the budget it plans for
    ["--arch", "arch6", "--auto-placement", "--hbm-budget-gb", "0.0005"],
    ["--num-worker", "2", "--auto-placement", "--hbm-budget-gb", "1"],
    ["--num-dcn-groups", "2", "--num-worker", "2"]],
    ids=["presample_static", "cold_tier", "arch5", "num_sample_worker",
         "auto_placement_arch6", "auto_placement_p2", "dcn_groups"])
def test_cli_trains_once_refused_multicard_paths(flags):
    """presample_static with a partial cache and the host cold tier under
    the partitioned topology, once refused, train over two gloo ranks at
    toy size and print the test_result: lines
    (tests/test_torch_port_dist_cold.py holds them to JAX); so does the
    disaggregated engine (arch5), its roles on the CPU
    (tests/test_torch_disagg.py holds its step to JAX), and so do the
    collocated engine's placement solve and DCN groups, once refused
    (tests/test_torch_port_dcn.py holds them to JAX)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "xgnn_tpu_torch.examples.train", "--cpu",
         "--synthetic", "--synthetic-nodes", "1500", "--num-epoch", "2",
         "--batch-size", "200", "--fanout", "4", "3", "--num-hidden", "16",
         "--report-acc", "1"] + flags,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=SPAWN_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    arch5 = "arch5" in flags or "--num-sample-worker" in flags
    assert (f"config:arch={'disaggregated' if arch5 else 'collocated'}"
            in lines)
    if "--num-train-worker" in flags:
        assert "config:num_train_worker=2" in lines
    results = dict(l.split("=", 1) for l in lines
                   if l.startswith("test_result:"))
    for key in ("test_result:epoch_time:train_total",
                "test_result:final_train_acc", "test_result:test_acc"):
        assert np.isfinite(float(results[key])), key


@pytest.mark.parametrize("kwargs", [
    dict(cache_percentage=0.3, cache_policy="presample_static"),
    dict(dist_graph_percentage=0.5), dict(device_loop=True),
    dict(arch="arch5"), dict(auto_placement=True),
    dict(num_worker=2, num_dcn_groups=2)],
    ids=["presample_static", "cold_tier", "device_loop", "arch5",
         "auto_placement", "dcn_groups"])
def test_engine_runs_once_refused_configs(graph, kwargs, capsys):
    """The RunConfigs, once refused, run: run() trains and prints the
    test_result: lines (device_loop through its fused epoch, arch5 through
    the disaggregated engine, one sampler and one trainer on the CPU, the
    placement solve through its solved store at P = 1, and two DCN groups
    of one rank over two gloo ranks)."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.engine.disagg_engine import DisaggregatedEngine
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    kw = {k: v for k, v in kwargs.items() if k != "num_worker"}
    p = kwargs.get("num_worker", 1)
    if "auto_placement" in kw:
        # JAX's test_auto_placement_multi_chip's budget: 0.35 of the
        # graph's bytes, a partial cache
        kw["hbm_budget_gb"] = 0.35 * (graph.num_node * graph.feat_dim
                                      + graph.num_edge) * 4 / (1 << 30)
    if p > 1:
        outs = pmesh.spawn(ranks.run_printed, p, _ds_arrays(graph),
                           _engine_config(p, num_epoch=2, **kw),
                           device="cpu", timeout=SPAWN_S)
        got = outs[0]
        assert all(o["epochs"] == got["epochs"] for o in outs)
    else:
        cfg = RunConfig(**_engine_config(1, num_epoch=2, **kw))
        cls = DisaggregatedEngine if "arch" in kwargs else MultiChipEngine
        eng = cls(graph, cfg, device="cpu")
        try:
            out = eng.run()
        finally:
            eng.close()
        got = {"epochs": [r["loss"] for r in out["epochs"]],
               "printed": capsys.readouterr().out,
               "tier": getattr(eng, "tier", None) is not None,
               "fused": getattr(eng, "_fused", None) is not None,
               "config": eng.config,
               "plan": getattr(eng, "placement_plan", None) is not None}
    assert len(got["epochs"]) == 2
    assert all(np.isfinite(loss) for loss in got["epochs"])
    assert "test_result:final_train_acc=" in got["printed"]
    solved = got["config"]
    assert got["tier"] == (solved.use_dist_graph
                           and solved.dist_graph_percentage < 1.0)
    if "auto_placement" not in kwargs:
        assert got["tier"] == ("dist_graph_percentage" in kwargs)
    else:
        assert 0.0 < solved.cache_percentage < 1.0
    assert got["fused"] == ("device_loop" in kwargs)
    assert got["plan"] == ("auto_placement" in kwargs)


def test_engine_refuses_a_mesh_of_another_size(graph):
    """num_worker that the mesh does not have raises before any process
    group is made, so the next world of one starts clean and closes."""
    import torch.distributed as dist

    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    with pytest.raises(ValueError, match="num_worker=2"):
        MultiChipEngine(graph, RunConfig(**_engine_config(2)), device="cpu")
    assert not dist.is_initialized()
    m = pmesh.make_mesh("cpu")
    assert m.size == 1 and m._store_dir is not None
    m.close()
    assert not dist.is_initialized()


def test_no_silent_fallback_without_cuda(graph):
    """Without a card and without device="cpu" the entry points raise."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiChipEngine(graph, RunConfig(**_engine_config(1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmesh.spawn(ranks.engine_run, 2, {}, {}, 1)


@pytest.mark.parametrize("fn", ["raise_on_rank1", "hang_on_rank1"])
def test_spawn_fails_on_a_raising_or_hanging_rank(fn):
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank"):
        pmesh.spawn(getattr(ranks, fn), 2, device="cpu", timeout=30)
    assert time.monotonic() - t0 < 60
