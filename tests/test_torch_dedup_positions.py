"""The plain versions of K8b-alias's hash-dedup form and of K11's position
form against the JAX package, on the CPU, at the shapes their kernels
branch on.

The hash-dedup form at 20, 33, 60 and 256 draws a row, on rows of degree
0, 1, K and K + 1, a hub of 10,000 entries, a row whose weight sits on one
neighbour, EMPTY ids and an id past the graph (inside JAX's padded indptr,
where JAX reads degree 0).  The position form against JAX's
``cache_split`` (its replicated form, whose hit rows are gathered from a
one-column cache holding each position plus one): positions, counts and
the miss lists at the sizes around the kernel's tiles of 2,048 ids, with
tiles of no misses and of misses only.  ``tests/test_torch_port_cuda.py``
holds the kernels to these plain versions on the card.
"""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY as EMPTY  # noqa: E402
from xgnn_tpu.ops.tiled import TILE, pad_tile  # noqa: E402

HUB = 10_000
ONE = 5  # the id that the one-neighbour row's alias entries hold
KTILE = 2048  # ids a tile of the position form's kernel


def _edge_csr(k, seed):
    """Rows of degree 0, 1, k, k + 1 and 300 (some of each), a hub of HUB
    entries, and a row of 300 entries whose weight sits on one neighbour
    (prob 0 everywhere, every alias entry ONE), with the JAX package's
    alias tables.  Returns the dataset and the special rows' ids."""
    from xgnn_tpu import synthetic as jsyn

    rng = np.random.default_rng(seed)
    degrees = np.concatenate([np.repeat([0, 1, k, k + 1, 300], 6),
                              [HUB, 300]])
    n = len(degrees)
    assert (n + 1) % TILE != 0  # id n reads JAX's padding: degree 0
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    ds = types.SimpleNamespace(num_node=n, num_edge=int(indptr[-1]),
                               indptr=indptr, indices=indices)
    jsyn.build_alias_tables(ds, seed=seed)
    one = n - 1
    s, e = indptr[one], indptr[one + 1]
    ds.prob_table[s:e] = 0.0
    ds.alias_table[s:e] = ONE
    return ds, {"hub": n - 2, "one": one, "k": 12, "k1": 18}


@pytest.mark.parametrize("k,rounds", [(5, 4), (11, 3), (15, 4), (64, 4)])
def test_hash_dedup_plain_matches_jax_on_edge_rows(k, rounds):
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops import sampling

    ds, rows = _edge_csr(k, 30 + k)
    n = ds.num_node
    deg = np.diff(ds.indptr)
    assert deg[rows["k"]] == k and deg[rows["k1"]] == k + 1
    frontier = np.concatenate([np.arange(n), [EMPTY, n, rows["hub"],
                                              rows["one"], EMPTY]])
    frontier = frontier.astype(np.int32)
    b, m = frontier.shape[0], rounds * k
    rng = np.random.default_rng(k)
    u = rng.random((b, m), dtype=np.float32)
    u.flat[::13] = 0.0
    u.flat[5::11] = np.float32(1.0) - np.float32(2.0 ** -24)
    coin = rng.random((b, m), dtype=np.float32)
    jfn = jax.jit(functools.partial(
        jsampling.sample_weighted_khop_hash_dedup, fanout=k, rounds=rounds))
    ref = np.asarray(jfn(
        jnp.asarray(pad_tile(ds.indptr, fill=int(ds.indptr[-1]))),
        jnp.asarray(pad_tile(ds.indices)), jnp.asarray(pad_tile(ds.prob_table)),
        jnp.asarray(pad_tile(ds.alias_table)), jnp.asarray(frontier),
        u=jnp.asarray(u), coin=jnp.asarray(coin)))
    got = sampling.sample_weighted_khop_hash_dedup(
        torch.from_numpy(ds.indptr), torch.from_numpy(ds.indices),
        torch.from_numpy(ds.prob_table), torch.from_numpy(ds.alias_table),
        torch.from_numpy(frontier), k, u=torch.from_numpy(u),
        coin=torch.from_numpy(coin), rounds=rounds).numpy()
    np.testing.assert_array_equal(got, ref)
    at = {v: i for i, v in enumerate(frontier.tolist())}
    # the one-neighbour row: one distinct value, then EMPTY
    assert got[at[rows["one"]], 0] == ONE
    assert (got[at[rows["one"]], 1:] == EMPTY).all()
    # deg <= K: the whole row in CSR order; degree 0, EMPTY, past N: EMPTY
    s, e = ds.indptr[rows["k"]], ds.indptr[rows["k"] + 1]
    np.testing.assert_array_equal(got[rows["k"]], ds.indices[s:e])
    for v in (0, n):
        assert (got[at[v]] == EMPTY).all()
    assert (got[-1] == EMPTY).all()
    assert got[at[rows["hub"]], 0] != EMPTY


def _jax_positions(posmap, ids):
    """JAX's ``cache_split`` (replicated) over a cache whose row p holds
    p + 1: ``(pos, num_hit, num_miss, miss_pos, miss_ids)``, pos EMPTY
    where a row was not served."""
    from xgnn_tpu.parallel import ggms as jggms

    num_cache = int((posmap != EMPTY).sum())
    cache = (np.arange(num_cache, dtype=np.float32) + 1)[:, None]
    split = jax.jit(functools.partial(
        jggms.cache_split, axis_name="data", seg_cap=ids.shape[0],
        miss_cap=ids.shape[0], partitioned=False))
    hit_rows, miss_ids, miss_pos, num_miss, num_hit, of = split(
        jnp.asarray(posmap), jnp.asarray(cache), jnp.asarray(ids))
    assert not bool(of)
    h = np.asarray(hit_rows)[:, 0]
    pos = np.where(h > 0, h.astype(np.int64) - 1, EMPTY)
    return (pos, int(num_hit), int(num_miss), np.asarray(miss_pos),
            np.asarray(miss_ids))


@pytest.mark.parametrize("n", [1, KTILE - 1, KTILE, KTILE + 1,
                               3 * KTILE + 1])
@pytest.mark.parametrize("case", ["mixed", "no_miss", "all_miss"])
def test_split_positions_plain_matches_jax(n, case):
    """The position form's plain version (the kernel's reference) against
    JAX's ``cache_split``: each slot's cache position, the counts, the
    miss positions and ids in position order, padded as JAX pads them."""
    from xgnn_tpu_torch.ops.tiered import tiered_split_positions_plain

    rng = np.random.default_rng(n + len(case))
    num_node = 5000
    posmap = np.full(num_node, EMPTY, np.int32)
    cached = rng.permutation(num_node)[:1500]
    posmap[cached] = rng.permutation(1500).astype(np.int32)
    if case == "no_miss":
        ids = cached[rng.integers(0, 1500, n)]
    elif case == "all_miss":
        ids = np.flatnonzero(posmap == EMPTY)[rng.integers(0, 3500, n)]
    else:
        ids = rng.integers(0, num_node, n)
        ids[::7] = EMPTY
    ids = ids.astype(np.int32)
    pos, hits, misses, miss_pos, miss_ids = _jax_positions(posmap, ids)
    got = tiered_split_positions_plain(torch.from_numpy(ids), n,
                                       torch.from_numpy(posmap))
    np.testing.assert_array_equal(got[0].numpy(), pos)
    assert got[1].tolist() == [hits, misses]
    np.testing.assert_array_equal(got[2].numpy(), miss_pos)
    np.testing.assert_array_equal(got[3].numpy(), miss_ids)
    if case == "no_miss":
        assert misses == 0 and hits == n
    if case == "all_miss":
        assert misses == n and hits == 0
