"""The port's tiered topology against the JAX package, on the CPU.

The hot node-id prefix of the CSR sits on the device and every other row
is read from the whole graph's CSR in host memory.  JAX draws the cold rows
on the host (``HostColdSampler`` through a callback) from ``_hash_u01``
uniforms; the port's kernels read them in place with the hot rows' own
uniform tensor.  So each test feeds the port, for each cold row, the
uniforms ``HostColdSampler`` computed for it (recorded from JAX's own
``_hash_u01``), and for each hot row the uniforms JAX's device sampler
took, and compares picks exactly.  On the CPU the kernel wrappers take
their plain PyTorch versions; ``chip_smoke.py`` and
``tests/test_torch_port_cuda.py`` hold the CUDA kernels to those versions
on the card.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu import constants as JC  # noqa: E402
from xgnn_tpu import synthetic  # noqa: E402
from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402
from xgnn_tpu.ops.sampling import HASH_DEDUP_ROUNDS  # noqa: E402
from xgnn_tpu.parallel import ggms  # noqa: E402

from test_big_offsets import GIANT_ROW, _oracle_sets, big_ds  # noqa: E402,F401
from test_torch_port_slice import _walk_uniforms as walk_uniforms  # noqa: E402,E501

from xgnn_tpu_torch.dataset import Dataset  # noqa: E402

EMPTY = EMPTY_KEY


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def learnable_ds():
    """``tests/test_engine_e2e.py``'s planted-signal graph, with the
    weighted samplers' tables."""
    ds = synthetic.make_synthetic_dataset(
        num_node=3000, avg_degree=8, feat_dim=32, num_class=5, seed=7,
        planted_signal=2.0, train_frac=0.3)
    synthetic.build_alias_tables(ds, seed=7)
    return ds


class RecordingColdSampler(ggms.HostColdSampler):
    """JAX's host sampler, keeping each call's ids and the ``_hash_u01``
    draws it made for them, in order."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.calls = []

    def __call__(self, ids, keydata, fanout):
        draws = []
        orig = ggms._hash_u01

        def record(x, salt):
            out = orig(x, salt)
            draws.append(out)
            return out

        ggms._hash_u01 = record
        try:
            out = super().__call__(ids, keydata, fanout)
        finally:
            ggms._hash_u01 = orig
        self.calls.append((np.array(ids), draws))
        return out


# --------------------------------------------------------- the hot prefix
@pytest.mark.parametrize("pct", [0.3, 0.5, 1.0])
@pytest.mark.parametrize("sample_type", ["khop3", "weighted_khop",
                                         "weighted_khop_prefix"])
def test_make_tiered_topology_matches_jax(learnable_ds, pct, sample_type):
    from xgnn_tpu.config import SampleType as JST
    from xgnn_tpu.sampler import make_tiered_topology as jmake
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import make_tiered_topology

    ds = learnable_ds
    tables = dict(prob_table=ds.prob_table, alias_table=ds.alias_table,
                  prob_prefix_table=ds.prob_prefix_table)
    jhot, jtier, jn = jmake(ds.indptr, ds.indices, pct, JST(sample_type),
                            **tables)
    hot, tier, n = make_tiered_topology(ds.indptr, ds.indices, pct,
                                        SampleType(sample_type),
                                        device="cpu", **tables)
    ncn = jtier[0]
    assert (tier.num_cache_node, n) == (ncn, jn) == (hot.num_node, n)
    assert (ncn < ds.num_node) == (pct < 1.0)
    e = int(ds.indptr[ncn])
    assert hot.indptr.dtype == torch.int32
    np.testing.assert_array_equal(hot.indptr.numpy(),
                                  np.asarray(jhot.indptr)[:ncn + 1])
    np.testing.assert_array_equal(hot.indices.numpy(),
                                  np.asarray(jhot.indices)[:e])
    assert hot.n_max_deg == jhot.n_max_deg
    weighted = sample_type != "khop3"
    for name in ("prob_table", "alias_table", "prob_prefix_table"):
        want = getattr(jhot, name)
        assert (getattr(hot, name) is None) == (want is None) == (
            not weighted)
        if weighted:
            np.testing.assert_array_equal(getattr(hot, name).numpy(),
                                          np.asarray(want)[:e])
            # the host CSR holds the whole table
            np.testing.assert_array_equal(tier.csr.host(name).numpy(),
                                          np.asarray(tables[name]))
    if weighted:
        np.testing.assert_array_equal(hot.coarse_cdf.numpy(),
                                      np.asarray(jhot.coarse_cdf)[:ncn])
    assert tier.csr.host("indptr").dtype == torch.int64
    np.testing.assert_array_equal(tier.csr.host("indptr").numpy(),
                                  ds.indptr)
    np.testing.assert_array_equal(tier.csr.host("indices").numpy(),
                                  ds.indices)


def test_int32_clamp_matches_jax_on_a_sparse_big_csr(big_ds):
    """On ``test_big_offsets``' sparse 2.4B-edge CSR the hot prefix stops
    before the row whose offsets pass 2^31, as JAX's does."""
    from xgnn_tpu.parallel.ggms import clamp_num_cache_node_int32 as jclamp
    from xgnn_tpu.parallel.ggms import compute_num_cache_node as jcompute
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import make_tiered_topology
    from xgnn_tpu_torch.store.topology import (
        INT32_EDGE_LIMIT,
        clamp_num_cache_node_int32,
        compute_num_cache_node,
    )

    indptr = big_ds.indptr
    assert INT32_EDGE_LIMIT == ggms.INT32_EDGE_LIMIT
    for pct in (1.0, 0.99, 0.5, 1e-9):
        ncn = compute_num_cache_node(indptr, pct)
        assert ncn == jcompute(indptr, pct)
        for parts in (1, 2, 3):
            assert (clamp_num_cache_node_int32(indptr, ncn, parts)
                    == jclamp(indptr, ncn, parts))
    hot, tier, n = make_tiered_topology(
        indptr, big_ds.indices.view(np.int32), 1.0, SampleType.KHOP3,
        device="cpu")
    assert tier.num_cache_node == GIANT_ROW == hot.num_node and n == 64
    assert hot.indptr.dtype == torch.int32
    assert int(tier.csr.host("indptr")[-1]) == int(indptr[-1]) > 2**31


# ------------------------------------------------------ picks against JAX
def _mixed_frontier(rng, num_node, ncn, b):
    """Hot ids, cold ids (the last node among them), EMPTY and a tail of
    EMPTY padding."""
    f = rng.integers(0, num_node, b).astype(np.int32)
    f[: b // 3] = rng.integers(ncn, num_node, b // 3)
    f[1] = num_node - 1
    f[2] = 0
    f[::9] = EMPTY
    f[-4:] = EMPTY
    rng.shuffle(f[:-4])
    return f


def _jax_hot(sample_type, jhot, frontier, k, u, coin):
    from xgnn_tpu.ops import sampling as js

    g = jhot
    f = jnp.asarray(frontier)
    if sample_type in ("khop0", "khop3"):
        return js.sample_khop0(g.indptr, g.indices, f, k, u=u)
    if sample_type == "khop1":
        return js.sample_khop1(g.indptr, g.indices, f, k, u=u)
    if sample_type == "uniform_wr":
        return js.sample_uniform_wr(g.indptr, g.indices, f, k, u=u)
    if sample_type == "weighted_khop":
        return js.sample_weighted_khop(g.indptr, g.indices, g.prob_table,
                                       g.alias_table, f, k, u=u, coin=coin)
    if sample_type == "weighted_khop_hash_dedup":
        return js.sample_weighted_khop_hash_dedup(
            g.indptr, g.indices, g.prob_table, g.alias_table, f, k, u=u,
            coin=coin)
    return js.sample_weighted_khop_prefix(
        g.indptr, g.indices, g.prob_prefix_table, f, k,
        max_deg=g.n_max_deg, coarse_cdf=g.coarse_cdf, u=u)


def _port_call(sample_type, hot, tier, frontier, k, u, coin):
    from xgnn_tpu_torch.ops import sampling as ps

    f = _t(frontier)
    if sample_type in ("khop0", "khop3"):
        return ps.sample_khop0(hot.indptr, hot.indices, f, k, u=u, tier=tier)
    if sample_type == "khop1":
        return ps.sample_khop1(hot.indptr, hot.indices, f, k, u=u, tier=tier)
    if sample_type == "uniform_wr":
        return ps.sample_uniform_wr(hot.indptr, hot.indices, f, k, u=u,
                                    tier=tier)
    if sample_type == "weighted_khop":
        return ps.sample_weighted_khop(hot.indptr, hot.indices,
                                       hot.prob_table, hot.alias_table, f, k,
                                       u=u, coin=coin, tier=tier)
    if sample_type == "weighted_khop_hash_dedup":
        return ps.sample_weighted_khop_hash_dedup(
            hot.indptr, hot.indices, hot.prob_table, hot.alias_table, f, k,
            u=u, coin=coin, tier=tier)
    return ps.sample_weighted_khop_prefix(
        hot.indptr, hot.indices, hot.prob_prefix_table, f, k,
        max_deg=hot.n_max_deg, coarse_cdf=hot.coarse_cdf, u=u, tier=tier)


@pytest.mark.parametrize("sample_type", [
    "khop0", "khop1", "khop3", "uniform_wr", "weighted_khop",
    "weighted_khop_hash_dedup", "weighted_khop_prefix"])
@pytest.mark.parametrize("k", [3, 5, 11])
def test_tiered_picks_match_jax(learnable_ds, sample_type, k):
    """JAX's picks are ``where(cold, HostColdSampler(...), the device
    sampler on the hot ids)`` (``xgnn_tpu/sampler.py:282-310``); the
    port's one call over hot and cold rows gives them exactly."""
    from xgnn_tpu.config import SampleType as JST
    from xgnn_tpu.sampler import make_tiered_topology as jmake
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import make_tiered_topology

    ds = learnable_ds
    st = "khop3" if sample_type == "uniform_wr" else sample_type
    tables = dict(prob_table=ds.prob_table, alias_table=ds.alias_table,
                  prob_prefix_table=ds.prob_prefix_table)
    jhot, jtier, n = jmake(ds.indptr, ds.indices, 0.5, JST(st), **tables)
    hot, tier, _ = make_tiered_topology(ds.indptr, ds.indices, 0.5,
                                        SampleType(st), device="cpu",
                                        **tables)
    ncn = jtier[0]
    rng = np.random.default_rng(k)
    b = 240
    frontier = _mixed_frontier(rng, n, ncn, b)
    cold = (frontier != EMPTY) & (frontier >= ncn)
    hot_ids = np.where(cold, EMPTY, frontier)
    dedup = sample_type == "weighted_khop_hash_dedup"
    width = HASH_DEDUP_ROUNDS * k if dedup else k
    u = jnp.asarray(rng.random((b, width), np.float32))
    coin = jnp.asarray(rng.random((b, width), np.float32))
    alias = sample_type in ("weighted_khop", "weighted_khop_hash_dedup")
    ref = np.array(_jax_hot(sample_type, jhot, hot_ids, k, u,
                            coin if alias else None))
    host_st = (JC.UNIFORM_WR if sample_type == "uniform_wr"
               else JST(sample_type))
    hs = RecordingColdSampler(ds.indptr, ds.indices, host_st, **tables)
    cold_ids = frontier[cold]
    ref[cold] = hs(cold_ids, np.array([3, 7], np.uint32), k)
    (_, draws), = hs.calls
    # the uniforms of the cold rows: HostColdSampler's u (and coin), the
    # hash-dedup form's from its own m-wide draws
    cu, cc = ((draws[1], draws[2]) if dedup else
              (draws[0], draws[1] if alias else None))
    u_np, coin_np = np.array(u), np.array(coin)
    u_np[cold] = cu.astype(np.float32)
    if alias:
        coin_np[cold] = cc.astype(np.float32)
    got = _port_call(sample_type, hot, tier, frontier, k, _t(u_np),
                     _t(coin_np) if alias else None)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert cold.sum() > b // 4
    assert np.all(got.numpy()[frontier == EMPTY] == EMPTY)
    # a cold row's picks are true neighbours of the whole graph
    for i in np.flatnonzero(cold)[:20]:
        v = int(frontier[i])
        row = set(ds.indices[ds.indptr[v]:ds.indptr[v + 1]].tolist())
        if alias:
            row |= set(ds.alias_table[ds.indptr[v]:ds.indptr[v + 1]].tolist())
        assert set(got.numpy()[i].tolist()) - {EMPTY} <= row


@pytest.mark.parametrize("sample_type", ["khop3", "weighted_khop_prefix",
                                         "weighted_khop"])
def test_tiered_call_equals_untiered_over_the_whole_csr(learnable_ds,
                                                        sample_type):
    """With one ``u`` for every row, a tiered call picks what the untiered
    call over the whole CSR picks: the cold rows take the hot rows'
    arithmetic."""
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import make_tiered_topology
    from xgnn_tpu_torch.types import Graph

    ds = learnable_ds
    tables = dict(prob_table=ds.prob_table, alias_table=ds.alias_table,
                  prob_prefix_table=ds.prob_prefix_table)
    hot, tier, n = make_tiered_topology(ds.indptr, ds.indices, 0.3,
                                        SampleType(sample_type),
                                        device="cpu", **tables)
    full = Graph.from_dataset(ds, "cpu", weighted=True)
    rng = np.random.default_rng(5)
    frontier = _mixed_frontier(rng, n, tier.num_cache_node, 300)
    for k in (4, 9):
        u = torch.rand((300, k), generator=torch.Generator().manual_seed(k))
        coin = torch.rand((300, k),
                          generator=torch.Generator().manual_seed(k + 1))
        coin = coin if sample_type == "weighted_khop" else None
        got = _port_call(sample_type, hot, tier, frontier, k, u, coin)
        want = _port_call(sample_type, full, None, frontier, k, u, coin)
        assert torch.equal(got, want)


def test_tiered_walk_matches_jax(learnable_ds):
    """K9's tiered walk against JAX's, whose walkers on cold nodes step
    through the host callback: the port is fed JAX's step uniforms for the
    walkers on hot nodes and the callback's for those on cold nodes, step
    by step (which walkers stand on cold nodes is followed here)."""
    from xgnn_tpu.ops.random_walk import sample_random_walk as jwalk
    from xgnn_tpu.config import SampleType as JST
    from xgnn_tpu.sampler import make_tiered_topology as jmake
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.ops.random_walk import sample_random_walk
    from xgnn_tpu_torch.sampler import make_tiered_topology

    ds = learnable_ds
    w, l, k, p = 4, 3, 5, 0.5
    jhot, jtier, n = jmake(ds.indptr, ds.indices, 0.5, JST.RANDOM_WALK)
    hot, tier, _ = make_tiered_topology(ds.indptr, ds.indices, 0.5,
                                        SampleType.RANDOM_WALK, device="cpu")
    ncn = jtier[0]
    rng = np.random.default_rng(1)
    b = 120
    frontier = _mixed_frontier(rng, n, ncn, b)
    hs = RecordingColdSampler(ds.indptr, ds.indices, JC.UNIFORM_WR)
    key = jax.random.key(9)
    ref_n, ref_w, over = jwalk(
        jhot.indptr, jhot.indices, jnp.asarray(frontier), k, key,
        num_random_walk=w, random_walk_length=l, restart_prob=p,
        tier=(ncn, hs, b * w))
    assert not bool(over) and len(hs.calls) == l
    u_step, u_restart = walk_uniforms(key, b, w, l)
    us = u_step.numpy().copy()
    seed2d = np.repeat(frontier[:, None], w, 1)
    cur = seed2d.copy()
    cold_steps = 0
    for s in range(l):
        if s:
            cur = np.where(u_restart[s].numpy() < np.float32(p), seed2d, cur)
        flat = cur.reshape(-1)
        cold = np.flatnonzero((flat != EMPTY) & (flat >= ncn))
        ids, draws = hs.calls[s]
        np.testing.assert_array_equal(ids[:len(cold)], flat[cold])
        if len(cold):
            us[s].reshape(-1)[cold] = draws[0][:, 0].astype(np.float32)
            cold_steps += len(cold)
        # the step over the whole CSR with these uniforms
        ok = (flat >= 0) & (flat < n)
        v = np.where(ok, flat, 0)
        start = ds.indptr[v].astype(np.int64)
        deg = np.where(ok, ds.indptr[v + 1] - start, 0)
        off = np.minimum(np.floor(us[s].reshape(-1) * deg.astype(np.float32)
                                  ).astype(np.int64),
                         np.maximum(deg - 1, 0))
        nxt = np.where(deg > 0, ds.indices[np.where(deg > 0, start + off,
                                                    0)], EMPTY)
        cur = np.where(nxt == EMPTY, seed2d.reshape(-1),
                       nxt).reshape(cur.shape)
    assert cold_steps > b
    neigh, weights = sample_random_walk(
        hot.indptr, hot.indices, _t(frontier), k, num_random_walk=w,
        random_walk_length=l, restart_prob=p, u=(_t(us), u_restart),
        tier=tier)
    np.testing.assert_array_equal(neigh.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(ref_w))


def test_plain_cold_branch_reads_past_2_31(big_ds):
    """The host CSR's int64 offsets: rows past 2^31 edges give JAX's host
    sampler's picks for its uniforms, every one a true neighbour."""
    from xgnn_tpu.config import SampleType as JST
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.ops.sampling import sample_khop0, sample_uniform_wr
    from xgnn_tpu_torch.sampler import make_tiered_topology

    hot, tier, _ = make_tiered_topology(
        big_ds.indptr, big_ds.indices.view(np.int32), 1.0, SampleType.KHOP3,
        device="cpu")
    ids = np.array([40, 63, EMPTY, 5, 33, 32], np.int32)
    for jst, fn in ((JST.KHOP3, sample_khop0),
                    (JC.UNIFORM_WR, sample_uniform_wr)):
        hs = RecordingColdSampler(big_ds.indptr, big_ds.indices, jst)
        cold = (ids != EMPTY) & (ids > GIANT_ROW)
        ref = np.full((len(ids), 4), EMPTY, np.int32)
        ref[cold] = hs(ids[cold], np.array([1, 2], np.uint32), 4)
        u = np.random.default_rng(0).random((len(ids), 4), np.float32)
        u[cold] = hs.calls[0][1][0].astype(np.float32)
        got = fn(hot.indptr, hot.indices, _t(ids), 4, u=_t(u), tier=tier)
        np.testing.assert_array_equal(got.numpy()[cold], ref[cold])
        for i, v in enumerate(ids):
            row = [x for x in got.numpy()[i] if x != EMPTY]
            if v == EMPTY:
                assert not row
            else:
                assert len(row) == 4 and set(row) <= _oracle_sets(int(v))


# ------------------------------------------------------------ the sampler
@pytest.mark.parametrize("sample_type", ["khop3", "khop1",
                                         "weighted_khop_prefix",
                                         "weighted_khop_hash_dedup",
                                         "random_walk"])
def test_tiered_sampler_picks_are_true_neighbours(learnable_ds, sample_type):
    """Every layer's picks, on both sides of the prefix, are neighbours in
    the whole graph (or, for the alias draws, alias entries of the row;
    for the walk, nodes it can reach); K3's id space is the whole graph's;
    ``grow`` keeps the tier."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import (
        Sampler,
        default_capacities,
        make_tiered_topology,
    )

    ds = learnable_ds
    tables = dict(prob_table=ds.prob_table, alias_table=ds.alias_table,
                  prob_prefix_table=ds.prob_prefix_table)
    hot, tier, n = make_tiered_topology(ds.indptr, ds.indices, 0.5,
                                        SampleType(sample_type),
                                        device="cpu", **tables)
    walk = sample_type == "random_walk"
    cfg = RunConfig(sample_type=sample_type, batch_size=64, fanout=(4, 3),
                    model="pinsage" if walk else "graphsage",
                    num_neighbor=3)
    sampler = Sampler(hot, cfg, direct_extract=True, tier=tier, num_node=n)
    # the capacities clamp to the whole graph's node count, not the hot
    # prefix's
    assert sampler.num_node == n
    assert sampler.capacities == default_capacities(
        64, sampler.fanouts, n) != default_capacities(64, sampler.fanouts,
                                                      hot.num_node)
    grown = sampler.grow()
    assert grown.tier is tier and grown.num_node == n
    seeds = np.full(64, EMPTY, np.int32)
    seeds[:60] = ds.train_set[:60]
    batch = sampler.sample(_t(seeds), 60,
                           torch.Generator().manual_seed(3))
    assert not bool(batch.overflow)
    top, inner = batch.blocks  # outermost (direct, global ids) first

    def neighbours(v, hops=1):
        reach = {v}
        for _ in range(hops):
            nxt = set()
            for x in reach:
                lo, hi = ds.indptr[x], ds.indptr[x + 1]
                nxt |= set(ds.indices[lo:hi].tolist())
                if sample_type == "weighted_khop_hash_dedup":
                    nxt |= set(ds.alias_table[lo:hi].tolist())
            reach = reach | nxt
        return reach

    hops = 3 if walk else 1
    checked = {False: 0, True: 0}
    dst = top.dst_ids.numpy()
    for i in range(int(top.num_dst)):
        v = int(dst[i])
        picks = set(top.neigh.numpy()[i].tolist()) - {EMPTY}
        assert picks <= neighbours(v, hops), (v, picks)
        checked[v >= tier.num_cache_node] += bool(picks)
    src = top.dst_ids.numpy()  # layer 0's unique ids
    for i in range(60):
        picks = {int(src[j]) for j in inner.neigh.numpy()[i] if j != EMPTY}
        assert picks <= neighbours(int(seeds[i]), hops)
    assert checked[False] > 0 and checked[True] > 0


# ------------------------------------------------------------- the engine
def _tiered_cfg(**kw):
    from xgnn_tpu_torch import RunConfig

    base = dict(batch_size=128, fanout=(4, 3), num_layer=2, num_hidden=16,
                model="graphsage", sample_type="khop3", use_dist_graph=True,
                dist_graph_percentage=0.5, pipeline=False,
                calibration_batches=1, lr=0.05, dropout=0.0)
    base.update(kw)
    return RunConfig(**base)


def test_tiered_engine_learns(learnable_ds):
    """``tests/test_engine_e2e.py``'s single-chip tiered topology on the
    port: only the hot prefix is on the device, the engine learns (8
    epochs, best accuracy above 0.6) and evaluates."""
    from xgnn_tpu_torch import Engine

    engine = Engine(Dataset.from_arrays(learnable_ds), _tiered_cfg(),
                    device="cpu").init()
    ncn = engine._tier.num_cache_node
    assert 0 < ncn < learnable_ds.num_node
    assert engine.graph.num_node == ncn
    assert engine.sampler.num_node == learnable_ds.num_node
    accs = [engine.train_epoch(e)["train_acc"] for e in range(8)]
    assert all(np.isfinite(a) for a in accs)
    assert max(accs) > 0.6, accs
    acc = engine.evaluate("valid")
    assert 0.4 < acc <= 1.0, acc


def test_tiered_pinsage_engine_learns(learnable_ds):
    """``tests/test_engine_e2e.py``'s tiered PinSAGE: walkers on cold
    nodes step in the host CSR; 6 epochs, best accuracy above 0.5."""
    from xgnn_tpu_torch import Engine

    cfg = _tiered_cfg(model="pinsage", sample_type="random_walk",
                      num_random_walk=4, random_walk_length=3,
                      random_walk_restart_prob=0.5, num_neighbor=4)
    engine = Engine(Dataset.from_arrays(learnable_ds), cfg,
                    device="cpu").init()
    assert engine.graph.num_node < learnable_ds.num_node
    accs = [engine.train_epoch(e)["train_acc"] for e in range(6)]
    assert all(np.isfinite(a) for a in accs)
    assert max(accs) > 0.5, accs


def test_tiered_weighted_prefix_engine_learns(learnable_ds):
    from xgnn_tpu_torch import Engine

    cfg = _tiered_cfg(sample_type="weighted_khop_prefix")
    engine = Engine(Dataset.from_arrays(learnable_ds), cfg,
                    device="cpu").init()
    assert engine.graph.coarse_cdf.shape[0] == engine._tier.num_cache_node
    accs = [engine.train_epoch(e)["train_acc"] for e in range(4)]
    assert max(accs) > 0.5, accs


def test_tiered_device_loop_losses_equal_host_loop(learnable_ds):
    """JAX's gate reads only the feature store, so ``device_loop`` runs on
    the tiered topology; its per-step losses equal the host loop's."""
    from xgnn_tpu_torch import Engine

    losses = []
    for device_loop in (False, True):
        cfg = _tiered_cfg(device_loop=device_loop, dropout=0.5,
                          pipeline=True)
        engine = Engine(Dataset.from_arrays(learnable_ds), cfg,
                        device="cpu").init()
        engine.train_epoch(0)
        assert (engine._fused is not None) == device_loop
        losses.append(engine.history[0]["loss"])
    assert np.all(np.isfinite(losses[1]))
    np.testing.assert_array_equal(losses[1], losses[0])


def test_tiered_pinsage_device_loop_losses_equal_host_loop(learnable_ds):
    """PinSAGE on the tiered topology under ``device_loop``: the walk's
    cold steps replay inside the captured step, and two epochs' per-step
    losses and accuracies equal the host loop's."""
    from xgnn_tpu_torch import Engine

    hist = []
    for device_loop in (False, True):
        cfg = _tiered_cfg(model="pinsage", sample_type="random_walk",
                          num_random_walk=4, random_walk_length=3,
                          random_walk_restart_prob=0.5, num_neighbor=4,
                          device_loop=device_loop, dropout=0.5,
                          pipeline=True)
        engine = Engine(Dataset.from_arrays(learnable_ds), cfg,
                        device="cpu").init()
        for epoch in (0, 1):
            engine.train_epoch(epoch)
        assert (engine._fused is not None) == device_loop
        hist.append([(engine.history[e]["loss"], engine.history[e]["acc"])
                     for e in (0, 1)])
    for (loss, acc), (ref_loss, ref_acc) in zip(hist[1], hist[0]):
        assert np.all(np.isfinite(loss))
        np.testing.assert_array_equal(loss, ref_loss)
        np.testing.assert_array_equal(acc, ref_acc)


@pytest.mark.parametrize("policy",["degree", "heuristic", "pre_sample",
                                    "degree_hop", "presample_static",
                                    "fake_optimal", "dynamic_cache",
                                    "random"])
def test_presample_on_a_tiered_topology(learnable_ds, policy, monkeypatch):
    """The tiered store over the tiered topology with each cache policy:
    the presample samples through the tiered sampler (``presample_static``
    through its wide khop0 of ``presample_static_fanout``) with the halves
    JAX counts, and the engine trains."""
    from xgnn_tpu_torch import Engine
    from xgnn_tpu_torch.engine import engine as engine_mod
    from xgnn_tpu_torch.store.ranking import FREQUENCY_POLICIES

    seen = []
    real = engine_mod.presample_ranking

    def spy(sampler, *a, **kw):
        seen.append((sampler.tier, sampler.config.sample_type.value,
                     sampler.config.fanout, kw.get("halves")))
        return real(sampler, *a, **kw)

    monkeypatch.setattr(engine_mod, "presample_ranking", spy)
    cfg = _tiered_cfg(cache_percentage=0.3, cache_policy=policy)
    engine = Engine(Dataset.from_arrays(learnable_ds), cfg,
                    device="cpu").init()
    if engine.config.cache_policy in FREQUENCY_POLICIES:
        (tier, st, fanout, halves), = seen
        assert tier is engine._tier and halves is True
        if policy == "presample_static":
            assert st == "khop0" and fanout == (32, 32)
        else:
            assert st == "khop3" and fanout == (4, 3)
        assert engine.init_times["presample"] > 0
    else:
        assert not seen
    r = engine.train_epoch(0)
    assert np.isfinite(r["loss"]) and 0 < r["hit_rate"] < 1


# ------------------------------------------------------- auto placement
def _plan_fields(plan):
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("scale", [0.1, 0.6, 2.2, 1e-3])
@pytest.mark.parametrize("weighted,group", [(False, 1), (True, 1),
                                            (False, 4)])
def test_solve_placement_matches_jax(learnable_ds, scale, weighted, group):
    from xgnn_tpu.parallel.placement import solve_placement as jsolve
    from xgnn_tpu_torch.store.placement import solve_placement

    ds = learnable_ds
    deg = np.diff(ds.indptr).astype(np.int64)
    total = ds.num_node * ds.feat.shape[1] * 4 + ds.num_edge * 4
    kw = dict(hbm_bytes=int(scale * total), group_size=group,
              weighted=weighted, degrees=deg)
    args = (ds.num_node, ds.num_edge, ds.feat.shape[1])
    assert _plan_fields(solve_placement(*args, **kw)) == _plan_fields(
        jsolve(*args, **kw))
    freq = np.random.default_rng(1).integers(0, 50, ds.num_node)
    assert _plan_fields(solve_placement(*args, node_freq=freq, **kw)) == \
        _plan_fields(jsolve(*args, node_freq=freq, **kw))


@pytest.mark.parametrize("budget_gb,explicit", [
    (2e-4, {}),  # starved: a tiered topology and a one-bucket cache
    (0.6 * (3000 * 32 * 4 + 24000 * 4) / (1 << 30) / 0.65, {}),
    (1.0, {}),  # roomy: everything resident
    (2e-4, {"cache_percentage": 0.5}),  # the caller's value wins
    (2e-4, {"dist_graph_percentage": 0.7, "use_dist_graph": True}),
])
def test_resolve_auto_placement_matches_jax(learnable_ds, budget_gb,
                                            explicit):
    from xgnn_tpu.config import RunConfig as JConfig
    from xgnn_tpu.parallel.placement import resolve_auto_placement as jres
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.store.placement import resolve_auto_placement

    kw = dict(batch_size=64, fanout=(4, 3), num_layer=2, num_hidden=16,
              auto_placement=True, hbm_budget_gb=budget_gb, **explicit)
    jcfg, jplan = jres(JConfig(root_path="/tmp", **kw), learnable_ds,
                       group_size=1)
    cfg, plan = resolve_auto_placement(RunConfig(**kw),
                                       Dataset.from_arrays(learnable_ds),
                                       group_size=1)
    assert _plan_fields(plan) == _plan_fields(jplan)
    for f in ("use_dist_graph", "dist_graph_percentage", "cache_percentage"):
        assert getattr(cfg, f) == getattr(jcfg, f), f


def test_auto_placement_engine_tiers_and_trains(learnable_ds):
    """JAX's ``test_auto_placement_engine`` on the port: a roomy budget
    keeps everything on the device, a tight one tiers the topology and the
    store, logs the solved split, estimates the cache's hit out of sample,
    and trains; on the CPU the budget must be given."""
    from xgnn_tpu_torch import Engine, RunConfig

    feat_total = learnable_ds.num_node * learnable_ds.feat.shape[1] * 4
    topo_total = learnable_ds.num_edge * 4
    kw = dict(batch_size=128, fanout=(4, 3), num_layer=2, num_hidden=16,
              auto_placement=True, pipeline=False, calibration_batches=1,
              lr=0.05)
    ds = Dataset.from_arrays(learnable_ds)
    roomy = Engine(ds, RunConfig(
        hbm_budget_gb=2.2 * (feat_total + topo_total) / (1 << 30) / 0.65,
        **kw), device="cpu").init()
    assert roomy.config.dist_graph_percentage == 1.0 and roomy._tier is None
    assert np.isfinite(roomy.train_epoch(0)["loss"])
    tight = Engine(ds, RunConfig(
        hbm_budget_gb=0.6 * (feat_total + topo_total) / (1 << 30) / 0.65,
        **kw), device="cpu").init()
    assert tight.config.dist_graph_percentage < 1.0
    assert tight._tier is not None and 0 < tight.config.cache_percentage < 1
    init = tight.profiler._init_items
    assert init["auto_dist_graph_percentage"] == \
        tight.config.dist_graph_percentage
    assert init["auto_cache_percentage"] == tight.config.cache_percentage
    assert 0.0 < tight.placement_plan.expected_feat_hit <= 1.0
    assert np.isfinite(tight.train_epoch(0)["loss"])
    with pytest.raises(ValueError, match="hbm_budget_gb"):
        Engine(ds, RunConfig(**kw), device="cpu").init()


# ------------------------------------------------------ config and the CLI
def test_run_config_fields_match_jax():
    from xgnn_tpu.config import RunConfig as JConfig
    from xgnn_tpu_torch import RunConfig

    j, p = JConfig(), RunConfig()
    for f in ("use_dist_graph", "dist_graph_percentage", "auto_placement",
              "hbm_budget_gb"):
        assert getattr(p, f) == getattr(j, f), f
        assert f in p.to_dict()
    cfg = RunConfig(use_dist_graph=True, dist_graph_percentage=0.85)
    assert cfg.to_dict()["dist_graph_percentage"] == 0.85


_TOY = ["--cpu", "--synthetic", "--synthetic-nodes", "3000", "--num-epoch",
        "1", "--batch-size", "200", "--fanout", "4", "3", "--num-hidden",
        "16"]


@pytest.mark.parametrize("flags", [
    ["--use-dist-graph", "--dist-graph-percentage", "0.5"],
    ["--model", "pinsage", "--use-dist-graph", "--dist-graph-percentage",
     "0.5"],
    ["--auto-placement", "--hbm-budget-gb", "0.0001"],
])
def test_cli_runs_the_tiered_topology(flags, capsys):
    from xgnn_tpu_torch.examples import train

    engine = train.main(_TOY + flags)
    out = capsys.readouterr().out
    assert engine._tier is not None
    assert engine.graph.num_node < engine.sampler.num_node
    assert re.search(r"^config:use_dist_graph=True$", out, re.M) or \
        "--auto-placement" in flags
    assert re.search(r"^test_result:final_train_acc=[0-9.]+$", out, re.M)


# more than one card runs the collocated engine now, over the whole CSR
# (tests/test_torch_port_multichip.py), a partial cache over the cards
# (tests/test_torch_port_ggms.py), its host cold tier and a partial cache
# ranked by presample_static (tests/test_torch_port_dist_cold.py), its
# placement solve and DCN groups (tests/test_torch_port_dcn.py), and the
# disaggregated engine (tests/test_torch_disagg.py)
@pytest.mark.parametrize("flags", [
    ["--num-worker", "2", "--dist-graph-percentage", "0.85"],
    ["--part-cache", "--num-worker", "2", "--cache-percentage", "0.5",
     "--cache-policy", "presample_static"],
    # on the CPU the placement solve needs the budget it plans for
    ["--arch", "arch6", "--auto-placement", "--hbm-budget-gb", "0.0005"],
    ["--num-dcn-groups", "2", "--num-worker", "2"]],
    ids=["cold_tier", "presample_static", "auto_placement", "dcn_groups"])
def test_cli_multi_card_flags_once_refused_train(flags):
    """The host cold tier over two ranks, presample_static over a partial
    cache, the collocated engine's placement solve and two DCN groups,
    once refused, train (over two gloo ranks where N > 1) and print the
    test_result: lines."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    out = subprocess.run(
        [sys.executable, "-m", "xgnn_tpu_torch.examples.train"] + _TOY
        + ["--use-dist-graph"] + flags,
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.search(r"^config:use_dist_graph=True$", out.stdout, re.M)
    assert re.search(r"^test_result:final_train_acc=[0-9.]+$", out.stdout,
                     re.M)
