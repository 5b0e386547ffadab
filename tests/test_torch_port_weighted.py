"""The port's weighted samplers (K8b) and their tables against the JAX
package, on the CPU.

The same CSR, tables and draws, made with numpy from a seed, go through the
JAX function (its arrays tile-padded as the JAX package pads them) and its
counterpart in ``xgnn_tpu_torch``; picks are compared exactly.  On the CPU
the kernel wrappers take their plain PyTorch versions; ``chip_smoke.py``
and ``tests/test_torch_port_cuda.py`` hold the CUDA kernels to those
versions on the card.
"""

import copy
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402
from xgnn_tpu.ops.tiled import pad_tile  # noqa: E402

from test_torch_port_slice import (  # noqa: E402
    _assert_same_batch,
    _layer_uniforms,
    _t,
)

HUB = 5000  # a row far past one coarse bucket of 128 entries


def _csr(seed, k, extra=()):
    """Rows of degree 0, 1, below, at and past ``k``, past 128, rows of the
    ``extra`` degrees, one hub of ``HUB`` entries, and a skewed row of
    ``4k + 3`` entries holding two ids (its ``4k`` draws hold fewer than
    ``k`` distinct values), with the JAX package's alias and prefix tables
    (float64 row sums)."""
    from xgnn_tpu import synthetic as jsyn

    rng = np.random.default_rng(seed)
    degrees = rng.choice([0, 1, max(k - 1, 0), k, k + 1, 37, 128, 129, 300],
                         size=150)
    degrees = np.concatenate([degrees, np.asarray(extra, degrees.dtype),
                              [0, HUB, 4 * k + 3]])
    n = len(degrees)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    s = int(indptr[-2])
    indices[s:] = 7
    indices[s + 1] = 8
    ds = types.SimpleNamespace(num_node=n, num_edge=int(indptr[-1]),
                               indptr=indptr, indices=indices)
    jsyn.build_alias_tables(ds, seed=seed)
    return ds


def _frontier(rng, ds, b):
    """Random rows, EMPTY entries, the row of degree 0, the hub and the
    skewed row."""
    n = ds.num_node
    frontier = rng.integers(0, n, b).astype(np.int32)
    frontier[::9] = EMPTY_KEY
    frontier[:3] = [n - 3, n - 2, n - 1]
    frontier[-4:] = EMPTY_KEY
    return frontier


def _jax_arrays(ds):
    return dict(
        indptr=jnp.asarray(pad_tile(ds.indptr, fill=int(ds.indptr[-1]))),
        indices=jnp.asarray(pad_tile(ds.indices)),
        prob=jnp.asarray(pad_tile(ds.prob_table)),
        alias=jnp.asarray(pad_tile(ds.alias_table)),
        prefix=jnp.asarray(pad_tile(ds.prob_prefix_table)),
    )


def _uniforms(rng, shape):
    """float32 uniforms with both ends of [0, 1) in them: 0, and the float
    below 1, where ``u * total`` can round up to ``total``."""
    u = rng.random(shape, dtype=np.float32)
    u.flat[::13] = 0.0
    u.flat[5::11] = np.float32(1.0) - np.float32(2.0 ** -24)
    return u


# ---------------------------------------------------------- K8b prefix
@pytest.mark.parametrize("k", [1, 5, 15, 64])
@pytest.mark.parametrize("coarse", [False, True])
@pytest.mark.parametrize("max_deg", [False, True])
def test_prefix_plain_matches_jax(k, coarse, max_deg):
    """Also on rows of 127, 128 and 129 entries, around the kernel's
    whole-row limit (its rows past 128 go through their coarse rows)."""
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops import sampling

    ds = _csr(k, k, extra=(127, 128, 129))
    rng = np.random.default_rng(100 + k)
    frontier = _frontier(rng, ds, 300)
    n = ds.num_node
    frontier[3:6] = [n - 6, n - 5, n - 4]
    assert list(np.diff(ds.indptr)[n - 6: n - 3]) == [127, 128, 129]
    u = _uniforms(rng, (300, k))
    j = _jax_arrays(ds)
    md = int(np.max(np.diff(ds.indptr))) if max_deg else None
    assert not max_deg or md == HUB
    jcoarse = (jsampling.build_coarse_cdf(j["indptr"], j["prefix"],
                                          ds.num_node) if coarse else None)
    ref = jsampling.sample_weighted_khop_prefix(
        j["indptr"], j["indices"], j["prefix"], jnp.asarray(frontier), k,
        max_deg=md, coarse_cdf=jcoarse, u=jnp.asarray(u))
    indptr = _t(ds.indptr)
    prefix = _t(ds.prob_prefix_table)
    pcoarse = (sampling.build_coarse_cdf(indptr, prefix, ds.num_node)
               if coarse else None)
    got = sampling.sample_weighted_khop_prefix(
        indptr, _t(ds.indices), prefix, _t(frontier), k, max_deg=md,
        coarse_cdf=pcoarse, u=_t(u))
    assert got.dtype == torch.int32 and got.shape == (300, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    deg = np.diff(ds.indptr)[np.minimum(frontier, ds.num_node - 1)]
    dead = (frontier == EMPTY_KEY) | (deg == 0)
    assert dead[0]  # the row of degree 0
    assert np.all(got.numpy()[dead] == EMPTY_KEY)
    assert np.all(got.numpy()[~dead] != EMPTY_KEY)


def test_prefix_picks_are_the_count_of_entries_below_the_target():
    """On nondecreasing rows the pick's offset is min(#{prefix <= u *
    total}, deg - 1), the kernel's count, also where ``u * total`` rounds
    up to ``total``."""
    from xgnn_tpu_torch.ops import sampling

    ds = _csr(3, 5)
    rng = np.random.default_rng(3)
    frontier = _frontier(rng, ds, 200)
    u = _uniforms(rng, (200, 5))
    got = sampling.sample_weighted_khop_prefix(
        _t(ds.indptr), _t(ds.indices), _t(ds.prob_prefix_table),
        _t(frontier), 5, u=_t(u)).numpy()
    for b, v in enumerate(frontier):
        if v == EMPTY_KEY or ds.indptr[v + 1] == ds.indptr[v]:
            continue
        s, e = ds.indptr[v], ds.indptr[v + 1]
        p = ds.prob_prefix_table[s:e]
        assert np.all(np.diff(p) >= 0)
        for k in range(5):
            x = np.float32(u[b, k]) * p[-1]
            off = min(int(np.sum(p <= x)), e - s - 1)
            assert got[b, k] == ds.indices[s + off]


def test_coarse_cdf_matches_jax():
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops import sampling

    ds = _csr(4, 5)
    j = _jax_arrays(ds)
    ref = jsampling.build_coarse_cdf(j["indptr"], j["prefix"], ds.num_node)
    got = sampling.build_coarse_cdf(_t(ds.indptr), _t(ds.prob_prefix_table),
                                    ds.num_node)
    assert got.dtype == torch.float32 and got.shape == (ds.num_node, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # built in steps of rows, the same table
    old = sampling._COARSE_CHUNK
    sampling._COARSE_CHUNK = 7
    try:
        again = sampling.build_coarse_cdf(_t(ds.indptr),
                                          _t(ds.prob_prefix_table),
                                          ds.num_node)
    finally:
        sampling._COARSE_CHUNK = old
    assert torch.equal(got, again)


# ----------------------------------------------------------- K8b alias
@pytest.mark.parametrize("k", [1, 5, 15, 64])
def test_alias_plain_matches_jax(k):
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops import sampling

    ds = _csr(10 + k, k)
    rng = np.random.default_rng(k)
    frontier = _frontier(rng, ds, 300)
    u, coin = _uniforms(rng, (300, k)), _uniforms(rng, (300, k))
    j = _jax_arrays(ds)
    ref = jsampling.sample_weighted_khop(
        j["indptr"], j["indices"], j["prob"], j["alias"],
        jnp.asarray(frontier), k, u=jnp.asarray(u), coin=jnp.asarray(coin))
    got = sampling.sample_weighted_khop(
        _t(ds.indptr), _t(ds.indices), _t(ds.prob_table),
        _t(ds.alias_table), _t(frontier), k, u=_t(u), coin=_t(coin))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # some picks come from the alias table, which holds global ids
    assert np.any(np.asarray(ds.prob_table) < 1)


@pytest.mark.parametrize("k", [1, 5, 15])
def test_hash_dedup_plain_matches_jax(k):
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops import sampling

    ds = _csr(20 + k, k)
    rng = np.random.default_rng(k)
    frontier = _frontier(rng, ds, 300)
    m = sampling.HASH_DEDUP_ROUNDS * k
    u, coin = _uniforms(rng, (300, m)), _uniforms(rng, (300, m))
    j = _jax_arrays(ds)
    ref = np.asarray(jsampling.sample_weighted_khop_hash_dedup(
        j["indptr"], j["indices"], j["prob"], j["alias"],
        jnp.asarray(frontier), k, u=jnp.asarray(u), coin=jnp.asarray(coin)))
    got = sampling.sample_weighted_khop_hash_dedup(
        _t(ds.indptr), _t(ds.indices), _t(ds.prob_table),
        _t(ds.alias_table), _t(frontier), k, u=_t(u), coin=_t(coin)).numpy()
    np.testing.assert_array_equal(got, ref)
    # the skewed row (two ids): fewer than k picks where k > 2, EMPTY after
    skewed = got[2]
    assert sorted(skewed[skewed != EMPTY_KEY].tolist()) == (
        [7] if k == 1 else [7, 8])
    # a row of degree <= k is the whole row in CSR order
    n_small = 0
    for b, v in enumerate(frontier):
        if v == EMPTY_KEY:
            continue
        s, e = ds.indptr[v], ds.indptr[v + 1]
        if e - s <= k:
            n_small += 1
            np.testing.assert_array_equal(got[b, :e - s], ds.indices[s:e])
            assert np.all(got[b, e - s:] == EMPTY_KEY)
    assert n_small > 3


def test_weighted_wrappers_refuse():
    from xgnn_tpu_torch.ops import sampling

    ds = _csr(1, 5)
    a = dict(indptr=_t(ds.indptr), indices=_t(ds.indices),
             prob_table=_t(ds.prob_table), alias_table=_t(ds.alias_table),
             frontier=_t(_frontier(np.random.default_rng(0), ds, 20)))
    with pytest.raises(ValueError, match="fanout"):
        sampling.sample_weighted_khop(**a, fanout=65)
    with pytest.raises(ValueError, match="draws"):
        sampling.sample_weighted_khop_hash_dedup(**a, fanout=64, rounds=5)
    with pytest.raises(ValueError, match="together"):
        sampling.sample_weighted_khop(**a, fanout=5,
                                      u=torch.rand((20, 5)))
    with pytest.raises(ValueError, match="u must be"):
        sampling.sample_weighted_khop_hash_dedup(
            **a, fanout=5, u=torch.rand((20, 5)), coin=torch.rand((20, 5)))
    with pytest.raises(ValueError, match="alias_table"):
        sampling.sample_weighted_khop(**dict(a, alias_table=None), fanout=5)
    prefix = _t(ds.prob_prefix_table)
    with pytest.raises(ValueError, match="coarse_cdf"):
        sampling.sample_weighted_khop_prefix(
            a["indptr"], a["indices"], prefix, a["frontier"], 5,
            coarse_cdf=torch.zeros((ds.num_node, 64)))
    with pytest.raises(ValueError, match="prob_prefix_table"):
        sampling.sample_weighted_khop_prefix(
            a["indptr"], a["indices"], prefix[:-1], a["frontier"], 5)


# -------------------------------------------------------------- tables
def test_prefix_table_matches_jax_scan():
    """The port's float64 row sums against JAX's float32 segmented scan on
    the weights JAX draws for its key: relative 1e-6, and every row of
    both nondecreasing (JAX's scan gives no decreasing pair here)."""
    from xgnn_tpu.synthetic_device import _prefix_table
    from xgnn_tpu_torch.synthetic_device import prefix_table

    ds = _csr(5, 5)
    key = jax.random.fold_in(jax.random.key(0), 7)
    ref = np.asarray(_prefix_table(jnp.asarray(ds.indptr),
                                   jnp.asarray(ds.indices), key))
    w = np.asarray(jax.random.uniform(key, (ds.num_edge,), jnp.float32, 0.1,
                                      1.0))
    got = prefix_table(_t(ds.indptr), _t(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)
    for table in (ref, got.numpy()):
        for v in range(ds.num_node):
            row = table[ds.indptr[v]:ds.indptr[v + 1]]
            assert np.all(np.diff(row) >= 0), v


@pytest.mark.parametrize("seed", [0, 3])
def test_alias_tables_equal_jax(seed):
    from xgnn_tpu import synthetic as jsyn
    from xgnn_tpu_torch.synthetic import build_alias_tables

    ds = _csr(seed, 5)
    ref = copy.copy(ds)
    jsyn.build_alias_tables(ref, seed=seed)
    got = types.SimpleNamespace(num_node=ds.num_node, num_edge=ds.num_edge,
                                indptr=_t(ds.indptr), indices=_t(ds.indices))
    build_alias_tables(got, seed=seed)
    for name in ("prob_table", "alias_table", "prob_prefix_table"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _id_probs(indptr, indices, prob, alias):
    """Each row's probability of each id under an alias table: slot ``s``
    gives ``prob[s] / deg`` to its own id and the rest to its alias."""
    rows = []
    for v in range(len(indptr) - 1):
        s, e = int(indptr[v]), int(indptr[v + 1])
        p = {}
        for i in range(s, e):
            for x, m in ((indices[i], prob[i]), (alias[i], 1.0 - prob[i])):
                p[int(x)] = p.get(int(x), 0.0) + float(m) / (e - s)
        rows.append(p)
    return rows


def _assert_same_probs(got, want, rtol):
    for v, (g, w) in enumerate(zip(got, want)):
        top = max(w.values(), default=0.0)
        for x in set(g) | set(w):
            assert abs(g.get(x, 0.0) - w.get(x, 0.0)) <= rtol * top, (v, x)


@pytest.mark.parametrize("weights", ["host", "equal", "skewed"])
def test_device_alias_tables_hold_the_weights(weights):
    """``synthetic_device.alias_tables``, the parallel build, gives each id
    of a row the probability its weights give it (multi-edges summed), at
    1e-6 of the row's largest, over rows of degree 0, 1, past 128, a hub
    and a row of two ids.  On the weights that JAX's ``build_alias_tables``
    draws for its seed ("host"), its tables give the same."""
    from xgnn_tpu_torch.synthetic_device import alias_tables

    ds = _csr(2, 5)
    e = ds.num_edge
    w = {"host": np.random.default_rng(2).random(e).astype(np.float32) + 0.1,
         "equal": np.full(e, 0.1, np.float32),
         "skewed": (np.random.default_rng(9).random(e) ** 8
                    + 1e-3).astype(np.float32)}[weights]
    prob, alias = alias_tables(_t(ds.indptr), _t(ds.indices), _t(w))
    assert prob.dtype == torch.float32 and alias.dtype == torch.int32
    assert bool(((prob >= 0) & (prob <= 1)).all())
    want = []
    for v in range(ds.num_node):
        s, t = int(ds.indptr[v]), int(ds.indptr[v + 1])
        row = w[s:t].astype(np.float64)
        p = {}
        for x, m in zip(ds.indices[s:t], row / row.sum()):
            p[int(x)] = p.get(int(x), 0.0) + m
        want.append(p)
    _assert_same_probs(_id_probs(ds.indptr, ds.indices, prob.numpy(),
                                 alias.numpy()), want, 1e-6)
    if weights == "host":
        _assert_same_probs(_id_probs(ds.indptr, ds.indices, ds.prob_table,
                                     ds.alias_table), want, 1e-6)
    empty = alias_tables(_t(ds.indptr[:1]), _t(ds.indices[:0]), _t(w[:0]))
    assert [t.numel() for t in empty] == [0, 0]


def test_weighted_device_dataset_keeps_the_graph():
    from xgnn_tpu_torch import make_device_dataset
    from xgnn_tpu_torch.ops.sampling import build_coarse_cdf

    args = (3000, 20000, 8, 5)
    plain = make_device_dataset(*args, seed=4, device="cpu", dedup=False)
    ds = make_device_dataset(*args, seed=4, device="cpu", weighted=True,
                             dedup=False)
    for name in ("indptr", "indices", "feat", "label"):
        assert torch.equal(getattr(ds, name), getattr(plain, name)), name
    for name in ("train_set", "valid_set", "test_set"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(plain, name))
    g = ds.graph
    assert plain.graph.prob_prefix_table is None
    assert g.n_max_deg == plain.graph.n_max_deg == int(
        (g.indptr[1:] - g.indptr[:-1]).max())
    assert g.prob_prefix_table is ds.prob_prefix_table
    assert torch.equal(g.coarse_cdf,
                       build_coarse_cdf(g.indptr, g.prob_prefix_table, 3000))
    p, ip = g.prob_prefix_table.numpy(), g.indptr.numpy()
    first = ip[:-1][ip[1:] > ip[:-1]]
    # each row starts at its first weight, in [0.1, 1.0), and never falls
    assert np.all((p[first] >= 0.1 - 1e-6) & (p[first] < 1.0))
    steps = np.diff(p)
    inner = np.ones(len(p), bool)
    inner[first] = False
    assert np.all(steps[inner[1:]] > 0.1 - 1e-4)
    assert np.all(steps[inner[1:]] < 1.0 + 1e-4)


# ------------------------------------------------------------- sampler
@pytest.mark.parametrize("sample_type", ["weighted_khop",
                                         "weighted_khop_prefix",
                                         "weighted_khop_hash_dedup"])
@pytest.mark.parametrize("direct", [True, False])
def test_sample_minibatch_matches_jax(small_ds, sample_type, direct):
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu import synthetic as jsyn
    from xgnn_tpu.sampler import Sampler as JSampler
    from xgnn_tpu.types import Graph as JGraph
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.ops.sampling import HASH_DEDUP_ROUNDS
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.types import Graph

    ds = copy.copy(small_ds)
    jsyn.build_alias_tables(ds, seed=5)
    fanout = (5, 4, 3)
    jsampler = JSampler(JGraph.from_dataset(ds, weighted=True),
                        JConfig(batch_size=48, fanout=fanout,
                                sample_type=sample_type),
                        direct_extract=direct)
    graph = Graph.from_dataset(ds, "cpu", weighted=True)
    assert graph.coarse_cdf is not None and graph.n_max_deg == int(
        np.max(np.diff(ds.indptr)))
    sampler = Sampler(graph, RunConfig(batch_size=48, fanout=fanout,
                                       sample_type=sample_type),
                      direct_extract=direct)
    assert sampler.capacities == jsampler.capacities
    seeds = np.full(48, np.iinfo(np.int32).max, np.int32)
    seeds[:40] = ds.train_set[:40]
    key = jax.random.key(12)
    ref = jsampler.sample(jnp.asarray(seeds), 40, key)
    lens = [48] + sampler.capacities[1:-1]
    if sample_type == "weighted_khop_prefix":
        us = _layer_uniforms(key, lens, fanout)
    else:
        rounds = HASH_DEDUP_ROUNDS if sample_type.endswith("dedup") else 1
        us = []
        for b, k in zip(lens, fanout):
            key, sub = jax.random.split(key)
            k_slot, k_coin = jax.random.split(sub)
            us.append((_t(jax.random.uniform(k_slot, (b, rounds * k))),
                       _t(jax.random.uniform(k_coin, (b, rounds * k)))))
    port = sampler.sample(_t(seeds), 40, u=us)
    _assert_same_batch(port, ref)
    assert int(port.num_input) > 40


def test_sampler_needs_the_tables(small_ds):
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.types import Graph

    graph = Graph.from_dataset(small_ds, "cpu")
    for st in ("weighted_khop", "weighted_khop_prefix"):
        with pytest.raises(ValueError, match="weighted=True"):
            Sampler(graph, RunConfig(sample_type=st))


@pytest.mark.parametrize("sample_type", ["weighted_khop",
                                         "weighted_khop_prefix",
                                         "weighted_khop_hash_dedup"])
def test_port_engine_learns_on_weighted_samplers(learn_ds, sample_type):
    """``Engine`` on the CPU over a host dataset with the port's tables:
    ``init`` builds the weighted graph itself."""
    from xgnn_tpu_torch import Dataset, Engine, RunConfig
    from xgnn_tpu_torch.synthetic import build_alias_tables

    ds = Dataset.from_arrays(learn_ds)
    build_alias_tables(ds, seed=1)
    cfg = RunConfig(batch_size=64, fanout=(5, 4, 3), num_hidden=16, lr=0.01,
                    sample_type=sample_type, calibration_batches=2)
    engine = Engine(ds, cfg, device="cpu").init()
    assert engine.graph.alias_table is not None
    losses = [engine.train_epoch(e)["loss"] for e in range(3)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
