"""The partitioned topology's host cold tier and the exact presample_static
over the cards, against the JAX package.

JAX's ``sample_layer_partitioned`` (and its walk) with a host sampler send
a layer's hot ids to their owners, whose uniforms are keyed by (the owner's
key, id, slot), and draw the cold ids on the host (``HostColdSampler``,
``_hash_u01`` draws keyed by the requesting chip's key).  Here those
uniforms are computed again from the same keys and fed to the port in
request order (``u``: the hot rows' go to their owners with the
requests, the cold rows' are used where they are), and the picks must be
equal: at P = 1 in this process (a world of one), at P = 2 and 4 over
gloo ranks, one spawn a P (``tests/torch_dist_cold_ranks.py``), against
JAX inside ``shard_map`` over P of the 8 CPU devices.  The exact
presample's counts are held to ``make_presample_static_exact_step`` on
both topologies (and at P = 1 to the single store's
``static_exact_ranking``); the engine learns and replays at P = 1 and 2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from xgnn_tpu import constants as JC  # noqa: E402
from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.config import RunConfig as JRunConfig  # noqa: E402
from xgnn_tpu.config import SampleType as JST  # noqa: E402
from xgnn_tpu.constants import EMPTY_KEY as EMPTY  # noqa: E402
from xgnn_tpu.parallel import dist_topology as jdt  # noqa: E402
from xgnn_tpu.parallel import ggms  # noqa: E402
from xgnn_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402

import torch_dist_cold_ranks as ranks  # noqa: E402
from test_big_offsets import big_ds  # noqa: E402,F401
from xgnn_tpu_torch.parallel import exchange  # noqa: E402
from xgnn_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SPAWN_S = 150  # each spawn's time limit
K = 4
PCT = 0.5  # the share of the edges in the hot prefix
LAYER_TYPES = ("khop3", "khop1", "weighted_khop", "weighted_khop_prefix")
WALK = dict(fanout=5, w=4, l=3, p=0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def graph():
    ds = jsyn.make_synthetic_dataset(num_node=600, avg_degree=6,
                                     feat_dim=12, num_class=5, seed=4,
                                     planted_signal=2.0, train_frac=0.4)
    jsyn.build_alias_tables(ds, seed=4)
    return ds


def _ncn(ds, num_parts):
    return ggms.clamp_num_cache_node_int32(
        ds.indptr, ggms.compute_num_cache_node(ds.indptr, PCT), num_parts)


def _frontier(rng, n, num_node):
    f = rng.integers(0, num_node, n).astype(np.int32)
    f[::9] = EMPTY
    f[-5:] = EMPTY
    return f


class Recorder(ggms.HostColdSampler):
    """JAX's host sampler, returning the ``_hash_u01`` draws of a call."""

    def draws(self, ids, keydata, fanout):
        got = []
        orig = ggms._hash_u01

        def record(x, salt):
            out = orig(x, salt)
            got.append(out)
            return out

        ggms._hash_u01 = record
        try:
            self(ids, keydata, fanout)
        finally:
            ggms._hash_u01 = orig
        return got


def _tables(ds):
    return dict(prob_table=ds.prob_table, alias_table=ds.alias_table,
                prob_prefix_table=ds.prob_prefix_table)


def _owner_uniforms(kd, req, fanout, n_draw):
    """``_owner_sample``'s uniforms at an owner: ``(P * seg, n_draw,
    fanout)`` from its key data ``kd`` and its received ids ``req``."""
    flat = jnp.asarray(req)
    slot = jnp.arange(flat.shape[0], dtype=jnp.uint32) * jnp.uint32(
        0x85EBCA6B)
    mixed = jnp.asarray(kd, jnp.uint32)[None, :] ^ (
        jnp.where(flat != EMPTY, flat, 0).astype(jnp.uint32)
        * jnp.uint32(0x9E3779B9) ^ slot)[:, None]
    draw = jax.vmap(lambda k: jax.random.uniform(
        jax.random.wrap_key_data(k), (n_draw, fanout)))
    return np.asarray(draw(mixed))


def _request_uniforms(fronts, kds, fanout, seg, ncn, n_draw, hs, cold_cap):
    """Each rank's uniforms in request order for JAX's layer over
    ``fronts`` (a frontier a rank) with the chips' key data ``kds``: a hot
    request's are its owner's at its slot, a cold row's the host sampler's
    draws for the rank's compacted cold ids.  ``(u, coin)`` a rank."""
    p = len(fronts)
    plans = [exchange.plan_exchange_plain(_t(f), p, seg, hot_limit=ncn)
             for f in fronts]
    sends = [pl.send.numpy() for pl in plans]
    owner_u = [_owner_uniforms(kds[o], np.concatenate(
        [sends[q][o] for q in range(p)]), fanout, n_draw) for o in range(p)]
    out = []
    for r, f in enumerate(fronts):
        n = f.shape[0]
        u = np.zeros((n, n_draw, fanout), np.float32)
        pick = plans[r].pick.numpy()
        for i in np.nonzero(pick != EMPTY)[0]:
            o, k = divmod(int(pick[i]), seg)
            u[i] = owner_u[o][r * seg + k]
        cold = (f != EMPTY) & (f >= ncn)
        ids = np.full(min(cold_cap, n), EMPTY, np.int32)
        ids[:cold.sum()] = f[cold]
        d = hs.draws(ids, kds[r], fanout)
        if cold.any():
            u[cold, 0] = d[0].astype(np.float32)
            if n_draw == 2:
                u[cold, 1] = d[1].astype(np.float32)
        out.append((u[:, 0], u[:, 1] if n_draw == 2 else None))
    return out


def _jax_topo(ds, p, ncn):
    lt = jdt.partition_csr_host(ds.indptr, ds.indices, p, num_cache_node=ncn,
                                prob=ds.prob_table, alias=ds.alias_table,
                                prefix=ds.prob_prefix_table)
    return {k: np.asarray(v) for k, v in lt._asdict().items()}


def _local(topo):
    return jdt.LocalTopo(**{k: v.reshape(v.shape[1:])
                            for k, v in topo.items()})


def _jax_layers(ds, p, ncn, fronts, kds, seg, max_deg):
    """JAX's tiered partitioned layer of each type inside shard_map."""
    samplers = {st: ggms.HostColdSampler(ds.indptr, ds.indices, JST(st),
                                         **_tables(ds))
                for st in LAYER_TYPES}
    n = fronts.shape[1]

    def fn(topo, f, kd):
        local, key = _local(topo), jax.random.wrap_key_data(kd.reshape(2))
        out = []
        for st in LAYER_TYPES:
            neigh, of = jdt.sample_layer_partitioned(
                local, f.reshape(-1), K, key, "data", seg, JST(st),
                num_cache_node=ncn, host_sampler=samplers[st], cold_cap=n,
                max_deg=max_deg)
            out += [neigh[None], of[None]]
        return tuple(out)

    topo = _jax_topo(ds, p, ncn)
    res = jax.jit(shard_map(
        fn, mesh=jax_mesh(p), in_specs=(PS("data"),) * 3,
        out_specs=(PS("data"),) * (2 * len(LAYER_TYPES))))(
            topo, jnp.asarray(fronts), jnp.asarray(kds))
    return {st: (np.asarray(res[2 * i]), np.asarray(res[2 * i + 1]))
            for i, st in enumerate(LAYER_TYPES)}


def _jax_walk(ds, p, ncn, fronts, kds, seg):
    """JAX's tiered partitioned walk inside shard_map, with its loop again
    beside it for each step's frontier, restart draws and step key."""
    hs = ggms.HostColdSampler(ds.indptr, ds.indices, JC.UNIFORM_WR)
    b = fronts.shape[1]
    w, l, pr = WALK["w"], WALK["l"], WALK["p"]
    tier = dict(num_cache_node=ncn, host_sampler=hs, cold_cap=b)

    def fn(topo, f, kd):
        local, key = _local(topo), jax.random.wrap_key_data(kd.reshape(2))
        f = f.reshape(-1)
        neigh, weights, of = jdt.sample_random_walk_partitioned(
            local, f, WALK["fanout"], key, "data", seg, num_random_walk=w,
            random_walk_length=l, restart_prob=pr, **tier)
        seed2d = jnp.broadcast_to(f[:, None], (b, w))
        cur, k, steps = seed2d, key, []
        for s in range(l):
            k, k_step, k_restart = jax.random.split(k, 3)
            if s == 0:
                front, r = f, jnp.zeros((b, w))
                nxt, _ = jdt.sample_layer_partitioned(
                    local, f, w, k_step, "data", seg, JC.UNIFORM_WR, **tier)
            else:
                r = jax.random.uniform(k_restart, (b, w))
                cur = jnp.where(r < pr, seed2d, cur)
                front = cur.reshape(-1)
                nxt = jdt._walk_step_partitioned(
                    local, front, k_step, "data", seg * w, ncn, hs,
                    b * w)[0].reshape(b, w)
            steps.append((front, r, jax.random.key_data(k_step)))
            cur = jnp.where(nxt == EMPTY, seed2d, nxt)
        flat = [x[None] for st in steps for x in st]
        return (neigh[None], weights[None], of[None], *flat)

    topo = _jax_topo(ds, p, ncn)
    res = jax.jit(shard_map(
        fn, mesh=jax_mesh(p), in_specs=(PS("data"),) * 3,
        out_specs=(PS("data"),) * (3 + 3 * l)))(
            topo, jnp.asarray(fronts), jnp.asarray(kds))
    res = [np.asarray(x) for x in res]
    steps = [tuple(res[3 + 3 * s + i] for i in range(3)) for s in range(l)]
    return res[0], res[1], res[2], steps


def _walk_uniforms(ds, p, ncn, steps, seg):
    """Each rank's ``(steps, restart)`` in request order for the port's
    walk, from JAX's step frontiers and keys."""
    hs = Recorder(ds.indptr, ds.indices, JC.UNIFORM_WR)
    b = steps[0][0].shape[1]
    w, l = WALK["w"], WALK["l"]
    per = [[None] * l for _ in range(p)]
    for s, (front, _, kd) in enumerate(steps):
        fan = w if s == 0 else 1
        reqs = _request_uniforms(list(front), list(kd), fan,
                                 seg if s == 0 else seg * w, ncn, 1, hs,
                                 b if s == 0 else b * w)
        for r in range(p):
            per[r][s] = reqs[r][0]
    restart = [np.stack([steps[s][1][r] for s in range(l)]).astype(
        np.float32) for r in range(p)]
    return per, restart


def _jax_exact(ds, p, seeds, nums, use_dist_graph, cfg):
    """``make_presample_static_exact_step``'s counts over the batches:
    every node's, ``full[w::P] = freq[w]``."""
    from xgnn_tpu.ops.tiled import pad_tile
    from xgnn_tpu.parallel.collocated import (
        make_presample_static_exact_step,
        put_replicated,
    )
    from xgnn_tpu.types import Graph as JGraph

    mesh = jax_mesh(p)
    rows = -(-ds.num_node // p)
    if use_dist_graph:
        topo = jdt.LocalTopo(**_jax_topo(ds, p, None))
    else:
        topo = put_replicated(JGraph(
            indptr=jnp.asarray(pad_tile(ds.indptr, fill=int(ds.indptr[-1]))),
            indices=jnp.asarray(pad_tile(ds.indices)), n_node=ds.num_node,
            n_edge=int(ds.indptr[-1])), mesh)
    fn = make_presample_static_exact_step(cfg, mesh, ds.num_node,
                                          seeds.shape[2],
                                          use_dist_graph=use_dist_graph)
    freq = jnp.zeros((p, rows), jnp.int32)
    for s, n in zip(seeds, nums):
        freq, _ = fn(freq, topo, jnp.asarray(s), jnp.asarray(n),
                     jnp.zeros((p, 2), jnp.uint32))
    return np.asarray(freq)


def _ds_arrays(ds):
    return {k: getattr(ds, k) for k in (
        "name", "num_node", "num_edge", "feat_dim", "num_class", "indptr",
        "indices", "feat", "label", "train_set", "valid_set", "test_set")}


def _engine_config(p, **kw):
    cfg = dict(model="graphsage", batch_size=96, fanout=(4, 3),
               num_layer=2, num_hidden=16, lr=0.01, num_worker=p,
               arch="arch6", use_dist_graph=True, part_cache=True,
               calibration_batches=2, dropout=0.0, seed=11)
    cfg.update(kw)
    return cfg


ENGINES = {
    "tiered": dict(dist_graph_percentage=PCT),
    # tiny capacities: the steps overflow, grow and replay
    "tiered_tiny": dict(dist_graph_percentage=PCT,
                        frontier_capacities=[96, 128, 256],
                        exchange_headroom=0.05, calibration_batches=0),
    "static": dict(cache_percentage=0.3, cache_policy="presample_static"),
    "static_tiered": dict(cache_percentage=0.3,
                          cache_policy="presample_static",
                          dist_graph_percentage=PCT),
}


_SUITES = {}


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda p: f"P{p}")
def suite(request, graph):
    return _suite(graph, request.param)


@pytest.fixture(scope="module")
def suite_p2(graph):
    return _suite(graph, 2)


def _suite(ds, p):
    """JAX's layers, walk and exact counts at P, and the port's on the same
    uniforms: in this process at P = 1, over gloo ranks otherwise (one
    spawn a P; the placement check and the engines at P = 2)."""
    if p in _SUITES:
        return _SUITES[p]
    ncn = _ncn(ds, p)
    rng = np.random.default_rng(p)
    n, seg = 160, 160
    max_deg = int(np.max(np.diff(ds.indptr)))
    kds = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(p), p)))
    fronts = np.stack([_frontier(rng, n, ds.num_node) for _ in range(p)])
    jlayers = _jax_layers(ds, p, ncn, fronts, kds, seg, max_deg)
    csr = {"indptr": ds.indptr, "indices": ds.indices,
           "prob": ds.prob_table, "alias": ds.alias_table,
           "prefix": ds.prob_prefix_table}
    data = {"csr": csr, "ncn": ncn, "layers": {}}
    for st in LAYER_TYPES:
        hs = Recorder(ds.indptr, ds.indices, JST(st), **_tables(ds))
        draws = _request_uniforms(list(fronts), list(kds), K, seg, ncn,
                                  2 if st == "weighted_khop" else 1, hs, n)
        case = {"frontier": fronts, "fanout": K, "seg_cap": seg,
                "u": [d[0] for d in draws]}
        if st == "weighted_khop":
            case["coin"] = [d[1] for d in draws]
        data["layers"][st] = case
    b = 40
    wfronts = np.stack([_frontier(rng, b, ds.num_node) for _ in range(p)])
    wkds = np.asarray(jax.random.key_data(jax.random.split(
        jax.random.key(50 + p), p)))
    jwalk = _jax_walk(ds, p, ncn, wfronts, wkds, b)
    steps, restart = _walk_uniforms(ds, p, ncn, jwalk[3], b)
    data["walk"] = dict(WALK, frontier=wfronts, seg_cap=b, steps=steps,
                        restart=restart)
    train = np.asarray(ds.train_set, np.int32)
    seed_cap, nb = 48, 3
    seeds = np.full((nb, p, seed_cap), EMPTY, np.int32)
    nums = np.zeros((nb, p), np.int32)
    for i in range(nb):
        for r in range(p):
            k = 0 if (p == 2 and r == 1 and i == 0) else seed_cap - 7 * r
            seeds[i, r, :k] = rng.choice(train, k, replace=False)
            nums[i, r] = k
    fanout = (4, 3)
    data["exact"] = {"config": dict(fanout=fanout, num_layer=2),
                     "seed_cap": seed_cap, "seeds": seeds, "nums": nums}
    jcfg = JRunConfig(fanout=fanout, num_layer=2)
    jexact = {name: _jax_exact(ds, p, seeds, nums, dg, jcfg)
              for name, dg in (("partitioned", True), ("replicated", False))}
    if p == 2:
        pseeds = np.stack([train[r * 64:(r + 1) * 64] for r in range(p)])
        pseeds[1, 57:] = EMPTY
        data["placement"] = {
            "types": ["khop3", "khop1", "weighted_khop",
                      "weighted_khop_hash_dedup", "weighted_khop_prefix"],
            "seeds": pseeds, "nums": [64, 57], "fanouts": [4, 3],
            "caps": [64, 320, 600], "seg_cap": 600}
        data["ds"] = _ds_arrays(ds)
        data["engines"] = {name: _engine_config(p, **kw)
                           for name, kw in ENGINES.items()}
    if p == 1:
        m = pmesh.make_mesh("cpu")
        try:
            outs = [pmesh._host(ranks.suite(m, data))]
        finally:
            m.close()
    else:
        outs = pmesh.spawn(ranks.suite, p, data, device="cpu",
                           timeout=SPAWN_S)
    _SUITES[p] = (p, ncn, data, outs, {"layers": jlayers, "walk": jwalk,
                                       "exact": jexact})
    return _SUITES[p]


# ------------------------------------------------------ size and clamp
@pytest.mark.parametrize("pct", [1.0, 0.85, 0.5, 0.1])
def test_cold_tier_size_and_clamp_match_jax(graph, pct):
    """The hot prefix and its int32 clamp at P parts, as JAX's; the
    port's parts of it equal JAX's ``partition_csr_host`` with it."""
    from xgnn_tpu_torch.parallel import dist_topology
    from xgnn_tpu_torch.store import topology

    ds = graph
    ncn = topology.compute_num_cache_node(ds.indptr, pct)
    assert ncn == ggms.compute_num_cache_node(ds.indptr, pct)
    for parts in (1, 2, 4):
        got = topology.clamp_num_cache_node_int32(ds.indptr, ncn, parts)
        assert got == ggms.clamp_num_cache_node_int32(ds.indptr, ncn, parts)
        want = jdt.partition_csr_host(ds.indptr, ds.indices, parts,
                                      num_cache_node=got)
        for r in range(parts):
            part = dist_topology.partition_part(
                _t(ds.indptr).long(), _t(ds.indices), parts, r, got)
            rows = part.indptr.shape[0]
            np.testing.assert_array_equal(part.indptr.numpy(),
                                          np.asarray(want.indptr)[r, :rows])
            e = part.indices.shape[0]
            np.testing.assert_array_equal(part.indices.numpy(),
                                          np.asarray(want.indices)[r, :e])


@pytest.mark.parametrize("num_parts", [1, 2, 4])
def test_plan_hot_limit_is_jax_hot_mask(graph, num_parts):
    """K13-plan's ``hot_limit`` plans what JAX plans after its hot mask
    (``frontier < num_cache_node``, the rest EMPTY)."""
    ds = graph
    ncn = _ncn(ds, num_parts)
    rng = np.random.default_rng(num_parts)
    f = _frontier(rng, 700, ds.num_node)
    hot = np.where((f != EMPTY) & (f < ncn), f, EMPTY).astype(np.int32)
    from xgnn_tpu.parallel import exchange as jex

    js, jo, jr, jof = jex.plan_exchange(jnp.asarray(hot), num_parts, 90)
    plan = exchange.plan_exchange_plain(_t(f), num_parts, 90, True, ncn)
    np.testing.assert_array_equal(plan.send.numpy(), np.asarray(js))
    jo, jr = np.asarray(jo), np.asarray(jr)
    ok = (jo < num_parts) & (jr < 90)
    np.testing.assert_array_equal(plan.pick.numpy(),
                                  np.where(ok, jo * 90 + jr, EMPTY))
    assert bool(plan.overflow) == bool(jof)


@pytest.mark.parametrize("form", ["khop", "uniform_wr", "khop1", "alias",
                                  "alias_dedup", "prefix"])
def test_cold_form_is_the_tiered_calls_cold_half(graph, form):
    """The cold form gives each cold row the tiered call's picks over the
    single store's hot prefix, EMPTY elsewhere, reading no device CSR."""
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.ops import sampling as ps
    from xgnn_tpu_torch.sampler import make_tiered_topology

    ds = graph
    hot, tier, n = make_tiered_topology(ds.indptr, ds.indices, PCT,
                                        SampleType.WEIGHTED_KHOP,
                                        device="cpu", **_tables(ds))
    hot_p, tier_p, _ = make_tiered_topology(
        ds.indptr, ds.indices, PCT, SampleType.WEIGHTED_KHOP_PREFIX,
        device="cpu", **_tables(ds))
    rng = np.random.default_rng(3)
    f = _t(_frontier(rng, 300, n))
    width = ps.HASH_DEDUP_ROUNDS * K if form == "alias_dedup" else K
    u = torch.rand((300, width), generator=torch.Generator().manual_seed(1))
    coin = torch.rand((300, width),
                      generator=torch.Generator().manual_seed(2))
    alias = form in ("alias", "alias_dedup")
    calls = {
        "khop": lambda: ps.sample_khop0(hot.indptr, hot.indices, f, K, u=u,
                                        tier=tier),
        "uniform_wr": lambda: ps.sample_uniform_wr(hot.indptr, hot.indices,
                                                   f, K, u=u, tier=tier),
        "khop1": lambda: ps.sample_khop1(hot.indptr, hot.indices, f, K, u=u,
                                         tier=tier),
        "alias": lambda: ps.sample_weighted_khop(
            hot.indptr, hot.indices, hot.prob_table, hot.alias_table, f, K,
            u=u, coin=coin, tier=tier),
        "alias_dedup": lambda: ps.sample_weighted_khop_hash_dedup(
            hot.indptr, hot.indices, hot.prob_table, hot.alias_table, f, K,
            u=u, coin=coin, tier=tier),
        "prefix": lambda: ps.sample_weighted_khop_prefix(
            hot_p.indptr, hot_p.indices, hot_p.prob_prefix_table, f, K,
            max_deg=hot_p.n_max_deg, coarse_cdf=hot_p.coarse_cdf, u=u,
            tier=tier_p)}
    whole = calls[form]()
    got = ps.sample_cold(form, tier_p if form == "prefix" else tier, f, K,
                         u=u, coin=coin if alias else None)
    cold = (f != EMPTY) & (f >= tier.num_cache_node)
    assert int(cold.sum()) > 50
    np.testing.assert_array_equal(got[cold].numpy(), whole[cold].numpy())
    assert (got[~cold] == EMPTY).all()


# ------------------------------------------------------------ the suite
def test_tiered_layer_matches_jax(suite):
    """Every rank's tiered partitioned layer (khop3, khop1, weighted_khop,
    the prefix form) equals JAX's exactly, on JAX's owner and host draws;
    cold rows are served and no exchange overflows."""
    p, ncn, data, outs, ref = suite
    for st in LAYER_TYPES:
        jneigh, jof = ref["layers"][st]
        f = data["layers"][st]["frontier"]
        for r in range(p):
            neigh, of = outs[r][f"layer_{st}"]
            np.testing.assert_array_equal(neigh, jneigh[r],
                                          err_msg=f"{st} rank {r}")
            assert not of and not jof[r]
            cold = (f[r] != EMPTY) & (f[r] >= ncn)
            assert cold.sum() > 20 and (neigh[cold] != EMPTY).any()


def test_tiered_walk_matches_jax(suite):
    """The partitioned walk with cold steps: each rank's top visits and
    their counts equal JAX's ``sample_random_walk_partitioned``'s."""
    p, ncn, data, outs, ref = suite
    jneigh, jweights, jof, steps = ref["walk"]
    cold_steps = 0
    for r in range(p):
        neigh, weights, of = outs[r]["walk"]
        np.testing.assert_array_equal(neigh, jneigh[r])
        np.testing.assert_array_equal(weights, jweights[r])
        assert not of and not jof[r]
        cold_steps += sum(int(((s[0][r] != EMPTY) & (s[0][r] >= ncn)).sum())
                          for s in steps)
    assert cold_steps > 20 * p


def test_exact_presample_matches_jax(suite, graph):
    """The exact presample_static counts equal
    ``make_presample_static_exact_step``'s on both topologies; at P = 1
    they are the single store's ``static_exact_ranking`` over the same
    batches."""
    p, _, data, outs, ref = suite
    for name in ("partitioned", "replicated"):
        for r in range(p):
            freq, sizes = outs[r]["exact"][name]
            np.testing.assert_array_equal(freq, ref["exact"][name][r],
                                          err_msg=f"{name} rank {r}")
            assert not sizes.any()
    if p == 1:
        from xgnn_tpu_torch.store.presample import static_exact_ranking
        from xgnn_tpu_torch.types import Graph

        case = data["exact"]
        g = Graph(indptr=_t(graph.indptr.astype(np.int32)),
                  indices=_t(graph.indices))

        class Batches:
            """The suite's batches as ``static_exact_ranking`` draws
            them."""

            def __init__(self, *a, **kw):
                pass

            def epoch_batches(self, epoch):
                return ((s[0], int(n[0])) for s, n in zip(case["seeds"],
                                                          case["nums"]))

        import xgnn_tpu_torch.store.presample as spre

        orig = spre.Shuffler
        spre.Shuffler = Batches
        try:
            from xgnn_tpu_torch import RunConfig

            want = static_exact_ranking(
                g, graph.train_set, RunConfig(fanout=(4, 3), num_layer=2,
                                              presample_epoch=1),
                graph.num_node, "cpu")
        finally:
            spre.Shuffler = orig
        for name in ("partitioned", "replicated"):
            np.testing.assert_array_equal(outs[0]["exact"][name][0], want)
        assert want.sum() > 0


def _jax_closure_layer(mask, indptr, indices, rows, p):
    """One layer of JAX's partitioned closure on a chip, as
    ``make_presample_static_exact_step`` writes it: the lanes' masks
    gathered along each local edge's row and scatter-maxed into the global
    destinations, owner-major ``(P owners, P lanes, rows)``."""
    iptr = jnp.asarray(indptr)
    dst = jnp.asarray(indices)
    marks = jnp.zeros(dst.shape[0], jnp.int32).at[iptr[1:rows]].add(
        1, mode="drop")
    rowid = jnp.cumsum(marks)
    evalid = jnp.arange(dst.shape[0]) < iptr[rows]
    hit = jnp.take(jnp.asarray(mask), rowid, axis=1) * evalid.astype(jnp.int8)
    add = jnp.zeros((mask.shape[0], rows * p), jnp.int8).at[:, dst].max(hit)
    return np.asarray(add.reshape(mask.shape[0], rows, p).transpose(2, 0, 1))


@pytest.mark.parametrize("num_parts", [1, 2, 4])
def test_closure_parts_plain_is_jax_layer(graph, num_parts):
    """K12b's partitioned form's plain version, every rank in turn, against
    JAX's edge-parallel layer on random seeds over 4 layers: each rank's
    marks equal JAX's wherever the owner's level is 0 (elsewhere it sends
    no more than JAX: a mark the rank knows of is not sent again), the
    levels' marks equal JAX's masks after every layer, and the counts
    JAX's."""
    from xgnn_tpu_torch.ops.presample import (
        closure_known,
        closure_parts_plain,
    )
    from xgnn_tpu_torch.parallel import dist_topology

    ds, p, layers = graph, num_parts, 4
    rng = np.random.default_rng(p)
    parts = [dist_topology.partition_part(_t(ds.indptr).long(),
                                          _t(ds.indices), p, r)
             for r in range(p)]
    rows = parts[0].indptr.shape[0] - 1
    seeds = rng.integers(0, ds.num_node, (p, 12))
    recv = [np.zeros((p, rows), np.uint8) for _ in range(p)]
    for lane in range(p):
        for v in seeds[lane]:
            recv[v % p][lane, v // p] = 1
    mask = [r.astype(np.int8) for r in recv]  # JAX's, after the seeds
    recv = [_t(r) for r in recv]
    level = [torch.zeros((p, rows), dtype=torch.uint8) for _ in range(p)]
    known = [closure_known(rows, p, "cpu") for _ in range(p)]
    sent = 0
    for tag in range(1, layers + 1):
        outs = [closure_parts_plain(parts[r].indptr, parts[r].indices,
                                    level[r], recv[r], tag, ds.num_node, r,
                                    known[r]) for r in range(p)]
        adds = [_jax_closure_layer(mask[r], parts[r].indptr.numpy(),
                                   parts[r].indices.numpy(), rows, p)
                for r in range(p)]
        for r in range(p):
            np.testing.assert_array_equal(level[r].numpy() != 0,
                                          mask[r] != 0)
            got = outs[r].numpy()
            assert (got <= adds[r]).all()
            for o in range(p):
                open_ = level[o].numpy() == 0
                np.testing.assert_array_equal(got[o][open_],
                                              adds[r][o][open_])
            sent += int(got.sum())
        recv = [_t((sum(out[o].numpy().astype(np.int32) for out in outs)
                    > 0).astype(np.uint8)) for o in range(p)]
        jrecv = [sum(a[o].astype(np.int32) for a in adds) for o in range(p)]
        mask = [np.maximum(mask[o], (jrecv[o] > 0).astype(np.int8))
                for o in range(p)]
    for r in range(p):
        counts = torch.zeros(rows, dtype=torch.int32)
        closure_parts_plain(parts[r].indptr, parts[r].indices, level[r],
                            recv[r], layers + 1, ds.num_node, r, known[r],
                            counts=counts)
        np.testing.assert_array_equal(counts.numpy(), mask[r].sum(0))
    assert sent > 0


# (P, edges by global node, the seeds a lane, what each layer's recv adds
# to part 0's, and the marks part 0 must send at each layer as (owner,
# lane, row))
_KNOWN_CASES = {
    # node 5's mark, sent by row 0 at layer 1, is not sent again by row 1
    "sent at an earlier layer": (2, {0: [5], 2: [5]}, [[0], []],
                                 [[], [(0, 1)]], [[(1, 0, 2)], []]),
    # node 4 is part 0's own and marked: row 0 does not send it
    "owned and already marked": (2, {0: [4, 3], 4: []}, [[0, 4], []],
                                 [[], []], [[(1, 0, 1)], []]),
    # nodes 3 and 7, each reached twice in one layer, marked once; lane 1
    # reaches 3 too
    "marked twice in one layer": (2, {0: [3, 7], 2: [3, 7, 3], 6: [3]},
                                  [[0, 2], [6]], [[], []],
                                  [[(1, 0, 1), (1, 0, 3), (1, 1, 1)], []]),
}


@pytest.mark.parametrize("case", list(_KNOWN_CASES))
def test_closure_parts_known_set(case):
    """The known set's edge cases at part 0 of 2: the marks sent at each
    layer, and the known set holding every mark sent or owned."""
    from xgnn_tpu_torch.ops.presample import (
        closure_known,
        closure_parts_plain,
    )

    p, edges, seeds, arrivals, want = _KNOWN_CASES[case]
    num_node = 8
    rows = num_node // p
    adj = [edges.get(r * p, []) for r in range(rows)]
    indptr = _t(np.concatenate([[0], np.cumsum([len(a) for a in adj])])
                .astype(np.int32))
    indices = _t(np.array(sum(adj, []), np.int32))
    recv = torch.zeros((p, rows), dtype=torch.uint8)
    for lane, vs in enumerate(seeds):
        for v in vs:
            if v % p == 0:
                recv[lane, v // p] = 1
    level = torch.zeros((p, rows), dtype=torch.uint8)
    known = closure_known(rows, p, "cpu")
    for tag, (arrive, marks) in enumerate(zip(arrivals, want), 1):
        for lane, r in arrive:
            recv[lane, r] = 1
        out = closure_parts_plain(indptr, indices, level, recv, tag,
                                  num_node, 0, known)
        got = sorted(tuple(int(x) for x in t) for t in out.nonzero())
        assert got == sorted(marks), (tag, got)
        recv = torch.zeros_like(recv)
    q = 2  # two lanes a node
    bits = [(int(known[b // 32]) >> (b % 32)) & 1
            for b in range(num_node * q)]
    held = {(v, lane) for v in range(num_node) for lane in range(p)
            if bits[v * q + lane]}
    for o, lane, r in sum(want, []):
        assert (r * p + o, lane) in held
    for lane in range(p):
        for r in range(rows):
            assert bool(level[lane, r]) == ((r * p, lane) in held)


def test_tier_is_only_a_placement(suite_p2):
    """At P = 2 the minibatch with a cold tier picks, on the same
    request-order uniforms, what the untiered partitioned call picks,
    layer for layer, for every owner-drawn sample type."""
    p, _, data, outs, _ = suite_p2
    for st in data["placement"]["types"]:
        for r in range(p):
            whole, tiered = outs[r]["placement"][st]
            for a, b in zip(whole["neigh"], tiered["neigh"]):
                np.testing.assert_array_equal(a, b, err_msg=st)
            for key in ("num_src", "input_nodes", "num_input", "overflow"):
                np.testing.assert_array_equal(np.asarray(whole[key]),
                                              np.asarray(tiered[key]))
            assert not whole["overflow"]


def test_engine_learns_and_replays_with_the_cold_tier(suite_p2):
    """At P = 2: the tiered engine and presample_static (exact, and the
    wide-khop approximation under the tier) learn, with equal parameters
    on both ranks; tiny capacities overflow, grow and replay every step."""
    p, ncn, data, outs, _ = suite_p2
    for name in ENGINES:
        for o in outs:
            e = o["engines"][name]
            rs = e["epochs"]
            assert all(np.isfinite(x["loss"]) for x in rs), name
            assert all(x["contributed_steps"] == x["steps"] for x in rs)
            assert 0.0 <= e["acc"] <= 1.0
            assert (e["ncn"] is not None) == ("tiered" in name)
            if name != "tiered_tiny":
                assert rs[-1]["loss"] < rs[0]["loss"] * 0.8, (name, rs)
        second = outs[1]["engines"][name]["params"]
        for k, v in outs[0]["engines"][name]["params"].items():
            np.testing.assert_array_equal(v, second[k])
    assert outs[0]["engines"]["tiered"]["ncn"] == ncn
    assert outs[0]["engines"]["tiered_tiny"]["caps"][-1] > 256


@pytest.mark.parametrize("kw", list(ENGINES.values())[:1] +
                         list(ENGINES.values())[2:], ids=["tiered", "static",
                                                          "static_tiered"])
def test_engine_p1_learns(graph, kw):
    """At P = 1 in this process (a world of one): the tiered engine and
    presample_static learn; the exact ranking's cache equals the single
    store's."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    cfg = RunConfig(**_engine_config(1, **kw))
    eng = MultiChipEngine(Dataset(**_ds_arrays(graph)), cfg,
                          device="cpu").init()
    try:
        rs = [eng.train_epoch(e) for e in range(3)]
        assert rs[-1]["loss"] < rs[0]["loss"] * 0.8, rs
        assert 0.0 <= eng.evaluate("valid") <= 1.0
        assert (eng.tier is not None) == ("dist_graph_percentage" in kw)
        if "cache_percentage" in kw:
            assert eng.num_cache == int(graph.num_node * 0.3)
    finally:
        eng.close()


def test_big_offsets_clamped_per_part_cold_rows_read_past_2_31(big_ds):
    """On ``test_big_offsets``' sparse 2.4B-edge CSR the hot prefix is
    clamped so that every part's rebased offsets fit int32 (as JAX's clamp
    at P = 1, 2, 4), each part is cut from the memory map, and at P = 1 the
    rows past 2^31 edges come through the cold form from the host CSR,
    every pick a true neighbour."""
    import warnings

    from test_big_offsets import GIANT_ROW, _oracle_sets
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.parallel import dist_topology
    from xgnn_tpu_torch.store import topology

    indptr = big_ds.indptr.astype(np.int64)
    num_node = len(indptr) - 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # a read-only map
        indices = torch.from_numpy(big_ds.indices.view(np.int32))
    for p in (1, 2, 4):
        ncn = topology.clamp_num_cache_node_int32(indptr, num_node, p)
        assert ncn == ggms.clamp_num_cache_node_int32(indptr, num_node, p)
        assert ncn == GIANT_ROW
        for r in range(p):
            part = dist_topology.partition_part(_t(indptr), indices, p, r,
                                                ncn)
            own = np.arange(r, ncn, p)
            want = np.concatenate([[0], np.cumsum(np.diff(indptr)[own])])
            np.testing.assert_array_equal(part.indptr.numpy()[:len(want)],
                                          want)
            assert part.indices.shape[0] == want[-1]
    topo = dist_topology.partition_part(_t(indptr), indices, 1, 0, GIANT_ROW)
    topo.tier = topology.Tier(GIANT_ROW, topology.MappedHostCSR(
        indptr, big_ds.indices.view(np.int32)))
    frontier = np.array([v for v in range(num_node) if v != GIANT_ROW]
                        + [EMPTY], np.int32)
    m = pmesh.make_mesh("cpu")
    try:
        neigh, of = dist_topology.sample_layer_partitioned(
            topo, _t(frontier), 4, m, 64, SampleType.KHOP3,
            torch.Generator().manual_seed(0))
    finally:
        m.close()
    assert not of
    for v, row in zip(frontier, neigh.numpy()):
        got = set(row.tolist()) - {EMPTY}
        if v == EMPTY:
            assert not got
        else:
            assert len(got) == 4 and got <= _oracle_sets(int(v))
