"""The PyTorch port's modules against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
(Pallas kernels in interpret mode) and its counterpart in
``xgnn_tpu_torch``.  On the CPU the port's kernel wrappers take their plain
PyTorch versions; the CUDA kernels are held against those versions on the
card by ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------- K1 gather
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("num_ids", [37, 64, 203])
def test_gather_rows_matches_pallas(dtype, num_ids):
    from xgnn_tpu.ops.pallas_gather import gather_rows_pallas
    from xgnn_tpu_torch.ops.gather import gather_rows

    rng = np.random.default_rng(num_ids)
    if dtype == np.float32:
        feat = rng.standard_normal((150, 12)).astype(np.float32)
    else:
        feat = rng.integers(-1000, 1000, (150, 12)).astype(np.int32)
    ids = rng.integers(0, 150, num_ids).astype(np.int32)
    ids[::5] = EMPTY_KEY
    ids[3::7] = -rng.integers(1, 50, len(ids[3::7]))
    pad = (-num_ids) % 16  # the Pallas call takes multiples of 16 rows
    ids_pad = np.concatenate([ids, np.full(pad, EMPTY_KEY, np.int32)])
    ref = np.asarray(gather_rows_pallas(jnp.asarray(feat), jnp.asarray(ids_pad),
                                        rows_per_step=16, interpret=True))
    out = gather_rows(_t(feat), _t(ids))
    assert out.dtype == _t(feat).dtype
    np.testing.assert_array_equal(out.numpy(), ref[:num_ids])


def test_gather_rows_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.gather import gather_rows

    feat = torch.zeros((4, 3))
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        gather_rows(feat.double(), ids)
    with pytest.raises(ValueError):
        gather_rows(feat, ids.long())
    with pytest.raises(ValueError):
        gather_rows(feat.t(), ids)
    with pytest.raises(NotImplementedError):
        gather_rows(feat.requires_grad_(True), ids)


# ------------------------------------------------------------------ sampler
def _csr(rng, degrees):
    n = len(degrees)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


@pytest.mark.parametrize("name", ["sample_khop0", "sample_khop2",
                                  "sample_khop3"])
@pytest.mark.parametrize("fanout", [3, 15])
def test_khop_picks_match_jax(name, fanout):
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops import sampling

    rng = np.random.default_rng(fanout)
    # deg 0, deg < K, deg == K and deg >> K, and EMPTY frontier entries
    degrees = rng.choice([0, 1, 2, 3, 5, 15, 16, 40, 300], size=80)
    indptr, indices = _csr(rng, degrees)
    frontier = rng.integers(0, 80, 120).astype(np.int32)
    frontier[::6] = EMPTY_KEY
    frontier[-20:] = EMPTY_KEY
    u = rng.random((120, fanout)).astype(np.float32)
    ref = np.asarray(getattr(jsampling, name)(
        jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(frontier),
        fanout, u=jnp.asarray(u)))
    out = getattr(sampling, name)(_t(indptr), _t(indices), _t(frontier),
                                  fanout, u=_t(u))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    # without replacement: no id twice in a row unless the CSR row repeats it
    assert (out.numpy() != EMPTY_KEY).sum() == np.minimum(
        np.where(frontier == EMPTY_KEY, 0, degrees[np.minimum(frontier, 79)]),
        fanout).sum()


def test_khop_draws_its_own_uniforms_from_a_generator():
    from xgnn_tpu_torch.ops.sampling import sample_khop3

    rng = np.random.default_rng(0)
    indptr, indices = _csr(rng, rng.integers(0, 30, 50))
    frontier = _t(np.arange(50, dtype=np.int32))
    a = sample_khop3(_t(indptr), _t(indices), frontier, 5,
                     torch.Generator().manual_seed(3))
    b = sample_khop3(_t(indptr), _t(indices), frontier, 5,
                     torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


def test_khop_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.sampling import sample_khop0, sample_khop0_plain

    rng = np.random.default_rng(1)
    indptr, indices = (_t(a) for a in _csr(rng, rng.integers(0, 9, 20)))
    frontier = _t(np.arange(20, dtype=np.int32))
    u = torch.rand((20, 4), generator=torch.Generator().manual_seed(0))
    # on the CPU the wrapper is the plain version
    assert torch.equal(sample_khop0(indptr, indices, frontier, 4, u=u),
                       sample_khop0_plain(indptr, indices, frontier, 4, u=u))
    bad = [
        (indptr.long(), indices, frontier, 4, u),  # 2^31 edges or more
        (indptr, indices.long(), frontier, 4, u),
        (indptr, indices, frontier.long(), 4, u),
        (indptr, indices, frontier, 4, u[:, :3]),  # u not (B, K)
        (indptr, indices, frontier, 4, u[:19]),
        (indptr, indices, frontier, 4, u.double()),
        (indptr, indices, frontier, 4, u.t().contiguous().t()),
        (indptr, indices, frontier, 0, None),
        (indptr, indices, frontier, 65, None),  # more records than it keeps
    ]
    for ip, ix, fr, k, uu in bad:
        with pytest.raises(ValueError):
            sample_khop0(ip, ix, fr, k, u=uu)


# ------------------------------------------------------------------- unique
def _seeded_ids(seed):
    """``concat(prev_frontier, picks)`` with 25 valid of 32 prefix slots,
    EMPTY picks and picks that repeat prefix ids."""
    rng = np.random.default_rng(seed)
    prev_cap, num_prev = 32, 25
    prev = np.full(prev_cap, EMPTY_KEY, np.int32)
    prev[:num_prev] = rng.choice(500, num_prev, replace=False)
    picks = rng.integers(0, 120, 200).astype(np.int32)
    picks[::4] = EMPTY_KEY
    picks[1::9] = prev[rng.integers(0, num_prev, len(picks[1::9]))]
    return np.concatenate([prev, picks]), num_prev, prev_cap


@pytest.mark.parametrize("out_cap", [400, 60, 9])  # ample, overflow, tiny
def test_unique_seeded_matches_jax(out_cap):
    from xgnn_tpu.ops.unique import unique_seeded as jax_unique
    from xgnn_tpu_torch.ops.unique import unique_seeded

    ids, num_prev, prev_cap = _seeded_ids(out_cap)
    ref = jax_unique(jnp.asarray(ids), jnp.int32(num_prev), prev_cap, out_cap)
    out = unique_seeded(_t(ids), torch.tensor(num_prev, dtype=torch.int32),
                        prev_cap, out_cap)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (int(out[1]) > out_cap) == (out_cap != 400)  # overflow flagged


@pytest.mark.parametrize("out_cap", [400, 60, 9])
def test_unique_seeded_num_node_leaves_the_plain_result(out_cap):
    from xgnn_tpu_torch.ops.unique import unique_seeded, unique_seeded_plain

    ids, num_prev, prev_cap = _seeded_ids(out_cap)
    n_prev = torch.tensor(num_prev, dtype=torch.int32)
    ref = unique_seeded_plain(_t(ids), n_prev, prev_cap, out_cap)
    for kwargs in ({}, {"num_node": 500}):
        out = unique_seeded(_t(ids), n_prev, prev_cap, out_cap, **kwargs)
        for o, r in zip(out, ref):
            assert o.dtype == r.dtype and torch.equal(o, r)


def test_unique_seeded_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.unique import unique_seeded

    ids = torch.arange(10, dtype=torch.int32)
    n_prev = torch.tensor(2, dtype=torch.int32)
    assert int(unique_seeded(ids, n_prev, 4, 8, num_node=10)[1]) == 10
    bad = [
        ((ids.long(), n_prev, 4, 8), {}),
        ((ids[::2], n_prev, 4, 8), {}),
        ((ids, n_prev.long(), 4, 8), {}),
        ((ids, torch.tensor([2, 3], dtype=torch.int32), 4, 8), {}),
        ((ids, n_prev, 11, 8), {}),  # a prefix longer than the ids
        ((ids, n_prev, 4, -1), {}),
        ((ids, n_prev, 4, 8), {"num_node": -1}),
        ((ids, 2, 4, 8), {}),  # num_prev stays on the device
    ]
    for args, kwargs in bad:
        with pytest.raises(ValueError):
            unique_seeded(*args, **kwargs)


@pytest.mark.parametrize("out_cap", [400, 60, 9])
def test_unique_seeded_split_matches_jax(out_cap):
    from xgnn_tpu.ops.unique import unique_seeded as jax_unique
    from xgnn_tpu_torch.ops.unique import unique_seeded_split

    ids, num_prev, prev_cap = _seeded_ids(out_cap)
    ref = jax_unique(jnp.asarray(ids), jnp.int32(num_prev), prev_cap, out_cap)
    out = unique_seeded_split(_t(ids[:prev_cap]), _t(ids[prev_cap:]),
                              torch.tensor(num_prev, dtype=torch.int32),
                              out_cap, num_node=500)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    assert int(out[1]) == int(ref[1])
    np.testing.assert_array_equal(out[2].numpy(),
                                  np.asarray(ref[2])[prev_cap:])


def test_unique_seeded_split_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.unique import unique_seeded_split

    prefix = torch.arange(4, dtype=torch.int32)
    picks = torch.arange(2, 10, dtype=torch.int32)
    n_prev = torch.tensor(2, dtype=torch.int32)
    out = unique_seeded_split(prefix, picks, n_prev, 8, num_node=10)
    assert int(out[1]) == 10 and out[2].shape == (8,)
    bad = [
        ((prefix.long(), picks, n_prev, 8), {}),
        ((prefix, picks.long(), n_prev, 8), {}),
        ((prefix, picks[::2], n_prev, 8), {}),
        ((prefix[None], picks, n_prev, 8), {}),
        ((prefix, picks, n_prev.long(), 8), {}),
        ((prefix, picks, 2, 8), {}),
        ((prefix, picks, n_prev, -1), {}),
        ((prefix, picks, n_prev, 8), {"num_node": EMPTY_KEY + 1}),
    ]
    for args, kwargs in bad:
        with pytest.raises(ValueError):
            unique_seeded_split(*args, **kwargs)


@pytest.mark.parametrize("direct,caps", [
    (True, None),
    (False, None),
    (True, (48, 160, 512, 1024)),  # layer 1 overflows its capacity
])
def test_sampler_blocks_unchanged_by_the_split_dedup(small_ds, monkeypatch,
                                                     direct, caps):
    """The sampler dedups the prefix and the picks as two tensors; its
    blocks equal those of a dedup of their concatenation."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.ops import unique
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.types import Graph

    fanout = (5, 4, 3)
    sampler = Sampler(Graph.from_dataset(small_ds, "cpu"),
                      RunConfig(batch_size=48, fanout=fanout,
                                frontier_capacities=caps),
                      direct_extract=direct)
    rng = np.random.default_rng(int(direct) + 2 * (caps is not None))
    seeds = np.full(48, EMPTY_KEY, np.int32)
    seeds[:40] = small_ds.train_set[:40]
    us = [_t(rng.random((b, k)).astype(np.float32))
          for b, k in zip([48] + sampler.capacities[1:-1], fanout)]
    got = sampler.sample(_t(seeds), 40, u=us)

    def concatenated(prefix, picks, num_prev, out_cap, num_node=None):
        uids, num_unique, local = unique.unique_seeded(
            torch.cat([prefix, picks]), num_prev, prefix.shape[0], out_cap,
            num_node=num_node)
        return uids, num_unique, local[prefix.shape[0]:]

    monkeypatch.setattr(unique, "unique_seeded_split", concatenated)
    ref = sampler.sample(_t(seeds), 40, u=us)
    assert len(got.blocks) == len(ref.blocks) == 3
    for gb, rb in zip(got.blocks, ref.blocks):
        for f in ("neigh", "num_dst", "num_src", "dst_ids"):
            a, b = getattr(gb, f), getattr(rb, f)
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    for f in ("input_nodes", "num_input", "overflow"):
        assert torch.equal(getattr(got, f), getattr(ref, f))
    assert bool(got.overflow) == (caps is not None)


# ---------------------------------------------------------- K4 fanout reduce
@pytest.mark.parametrize("weighted", [False, True])
def test_fanout_reduce_and_grad_match_jax(weighted):
    from xgnn_tpu.models.gnn import fanout_reduce as jax_fanout
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.ops.fanout import fanout_reduce

    rng = np.random.default_rng(int(weighted))
    n, f, d, k = 40, 8, 12, 5
    h = rng.standard_normal((n, f)).astype(np.float32)
    neigh = rng.integers(0, n, (d, k)).astype(np.int32)
    neigh[rng.random((d, k)) < 0.3] = EMPTY_KEY
    neigh[4] = EMPTY_KEY  # a row with no valid pick
    w = (rng.random((d, k)).astype(np.float32) + 0.5) if weighted else None
    g = rng.standard_normal((d, f)).astype(np.float32)
    blk = JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(d),
                 num_src=jnp.int32(n))
    jw = None if w is None else jnp.asarray(w)
    s_ref, d_ref = jax_fanout(jnp.asarray(h), blk, jw, impl="loop")
    gh_ref = jax.grad(
        lambda x: jnp.sum(jax_fanout(x, blk, jw, impl="loop")[0] * g)
    )(jnp.asarray(h))

    ht = _t(h).requires_grad_(True)
    s, den = fanout_reduce(ht, _t(neigh), None if w is None else _t(w))
    (gh,) = torch.autograd.grad(s, ht, _t(g))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_ref), **tol)
    np.testing.assert_allclose(den.numpy(), np.asarray(d_ref), **tol)
    np.testing.assert_allclose(gh.numpy(), np.asarray(gh_ref), **tol)
    assert not den.requires_grad


def _prefix_case(weighted, seed):
    """A local-id block over ``n`` src rows: EMPTY, negative and too-large
    picks, repeated ids, and row 3 picked 520 times."""
    rng = np.random.default_rng(seed)
    n, f, d, k = 150, 8, 120, 6
    h = rng.standard_normal((n, f)).astype(np.float32)
    neigh = rng.integers(0, 40, (d, k)).astype(np.int32)  # many repeats
    bad = rng.random((d, k))
    neigh[bad < 0.1] = EMPTY_KEY
    neigh[(bad >= 0.1) & (bad < 0.15)] = -7
    neigh[(bad >= 0.15) & (bad < 0.2)] = n + 11
    neigh.reshape(-1)[100:620] = 3
    neigh[5] = EMPTY_KEY  # a dst row with no valid pick
    w = (rng.random((d, k)).astype(np.float32) + 0.5) if weighted else None
    g_dst = rng.standard_normal((d, f)).astype(np.float32)
    g_sum = rng.standard_normal((d, f)).astype(np.float32)
    return h, neigh, w, g_dst, g_sum


@pytest.mark.parametrize("weighted", [False, True])
def test_prefix_fanout_grad_matches_jax(weighted):
    """The gradient w.r.t. ``h_src`` of a local-id block's dst prefix and
    fanout sum, one Function in the port, against ``jax.grad`` of
    ``_take_dst`` plus ``fanout_reduce``."""
    from xgnn_tpu.models.gnn import _take_dst
    from xgnn_tpu.models.gnn import fanout_reduce as jax_fanout
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.ops.fanout import prefix_fanout_reduce

    h, neigh, w, g_dst, g_sum = _prefix_case(weighted, 3 + int(weighted))
    n, d = h.shape[0], neigh.shape[0]
    assert (neigh == 3).sum() >= 500
    # the port skips every pick outside [0, N); the JAX loop skips only
    # EMPTY and clips the rest (ROADMAP section 3), so it sees them as EMPTY
    jneigh = np.where((neigh >= 0) & (neigh < n), neigh, EMPTY_KEY)
    blk = JBlock(neigh=jnp.asarray(jneigh), num_dst=jnp.int32(d),
                 num_src=jnp.int32(n))
    jw = None if w is None else jnp.asarray(w)

    def jloss(x):
        s, _ = jax_fanout(x, blk, jw, impl="loop")
        return jnp.sum(_take_dst(blk, x) * g_dst) + jnp.sum(s * g_sum)

    gh_ref = jax.grad(jloss)(jnp.asarray(h))

    ht = _t(h).requires_grad_(True)
    h_dst, s, den = prefix_fanout_reduce(ht, _t(neigh),
                                         None if w is None else _t(w))
    assert h_dst.shape == (d, h.shape[1]) and torch.equal(h_dst, ht[:d])
    (gh,) = torch.autograd.grad((h_dst, s), ht, (_t(g_dst), _t(g_sum)))
    np.testing.assert_allclose(gh.numpy(), np.asarray(gh_ref), rtol=1e-5,
                               atol=1e-6)
    assert not den.requires_grad


@pytest.mark.parametrize("weighted", [False, True])
def test_prefix_backward_is_the_old_route_bit_for_bit(weighted):
    """On the CPU the new backward is ``fanout_backward_plain`` plus the
    prefix gradient, and equals autograd through a slice and
    ``fanout_reduce`` bit for bit."""
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
        fanout_reduce,
        prefix_fanout_reduce,
    )

    h, neigh, w, g_dst, g_sum = (
        None if a is None else _t(a) for a in _prefix_case(weighted, 9))
    n, d = h.shape[0], neigh.shape[0]
    ref = fanout_backward_plain(g_sum, neigh, w, n)
    ref[:d] += g_dst
    assert torch.equal(fanout_backward_plain(g_sum, neigh, w, n, g_dst), ref)
    assert torch.equal(fanout_backward(g_sum, neigh, w, n, g_dst), ref)

    ht = h.clone().requires_grad_(True)
    h_dst, s, _ = prefix_fanout_reduce(ht, neigh, w)
    (gh,) = torch.autograd.grad((h_dst, s), ht, (g_dst, g_sum))
    assert torch.equal(gh, ref)
    old = h.clone().requires_grad_(True)
    s_old, _ = fanout_reduce(old, neigh, w)
    (g_old,) = torch.autograd.grad((old[:d], s_old), old, (g_dst, g_sum))
    assert torch.equal(gh, g_old)


def test_fanout_backward_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        prefix_fanout_reduce,
    )

    gs = torch.zeros((3, 4))
    neigh = torch.zeros((3, 2), dtype=torch.int32)
    assert fanout_backward(gs, neigh, None, 5, torch.ones((3, 4)))[:3].eq(
        1).all()
    bad = [
        ((gs[:2], neigh, None, 5), {}),  # grad_sum rows != dst rows
        ((gs, neigh, None, 5), {"grad_dst": torch.zeros((2, 4))}),
        ((gs, neigh, None, 5), {"grad_dst": torch.zeros((3, 4)).double()}),
        ((gs, neigh, None, 2), {"grad_dst": torch.zeros((3, 4))}),  # D > N
    ]
    for args, kwargs in bad:
        with pytest.raises(ValueError):
            fanout_backward(*args, **kwargs)
    with pytest.raises(ValueError):
        prefix_fanout_reduce(torch.zeros((2, 4)), neigh)  # D > N


def test_fanout_reduce_refuses_weight_gradients_and_bad_input():
    from xgnn_tpu_torch.ops.fanout import fanout_reduce

    h = torch.zeros((5, 4))
    neigh = torch.zeros((3, 2), dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        fanout_reduce(h, neigh, torch.ones((3, 2), requires_grad=True))
    with pytest.raises(ValueError):
        fanout_reduce(h, neigh.long())
    with pytest.raises(ValueError):
        fanout_reduce(h.double(), neigh)


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_masked_mean_matches_jax(prefix, weighted):
    """``masked_mean`` against ``masked_mean_stream``, and
    ``prefix_masked_mean`` against ``_take_dst`` plus it: values and
    ``jax.grad``, on ``_prefix_case``'s picks (EMPTY, negative and too-large
    ids, a dst row with no valid pick, src row 3 picked 520 times)."""
    from xgnn_tpu.models.gnn import _take_dst, masked_mean_stream
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.ops.fanout import masked_mean, prefix_masked_mean

    h, neigh, w, g_dst, g_mean = _prefix_case(weighted,
                                              11 + 2 * prefix + weighted)
    n, d = h.shape[0], neigh.shape[0]
    assert (neigh == 3).sum() >= 500 and not (
        (neigh[5] >= 0) & (neigh[5] < n)).any()
    # the JAX loop clips picks outside [0, N) other than EMPTY (ROADMAP
    # section 3); the port skips them, so JAX sees them as EMPTY
    jneigh = np.where((neigh >= 0) & (neigh < n), neigh, EMPTY_KEY)
    blk = JBlock(neigh=jnp.asarray(jneigh), num_dst=jnp.int32(d),
                 num_src=jnp.int32(n))
    jw = None if w is None else jnp.asarray(w)

    def jfwd(x):
        return _take_dst(blk, x), masked_mean_stream(x, blk, jw, impl="loop")

    def jloss(x):
        h_dst, mean = jfwd(x)
        return (jnp.sum(h_dst * g_dst) if prefix else 0.0) + jnp.sum(
            mean * g_mean)

    dst_ref, mean_ref = jfwd(jnp.asarray(h))
    gh_ref = jax.grad(jloss)(jnp.asarray(h))

    ht = _t(h).requires_grad_(True)
    tw = None if w is None else _t(w)
    if prefix:
        h_dst, mean, den = prefix_masked_mean(ht, _t(neigh), tw)
        np.testing.assert_array_equal(h_dst.detach().numpy(),
                                      np.asarray(dst_ref))
        (gh,) = torch.autograd.grad((h_dst, mean), ht,
                                    (_t(g_dst), _t(g_mean)))
    else:
        mean, den = masked_mean(ht, _t(neigh), tw)
        (gh,) = torch.autograd.grad(mean, ht, _t(g_mean))
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean.detach().numpy(), np.asarray(mean_ref),
                               **tol)
    np.testing.assert_allclose(gh.numpy(), np.asarray(gh_ref), **tol)
    assert torch.all(mean[5] == 0) and float(den[5]) == 0.0
    assert not den.requires_grad


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_masked_mean_is_the_sum_route_bit_for_bit(prefix, weighted):
    """On the CPU the mean form and its gradient equal the sum form
    followed by ``s / torch.clamp(denom, min=1e-9)`` under autograd bit for
    bit, and ``fanout_backward`` with ``denom`` equals the plain backward
    of the divided gradient."""
    from xgnn_tpu_torch.ops.fanout import (
        fanout_backward,
        fanout_backward_plain,
        fanout_reduce,
        masked_mean,
        masked_mean_plain,
        prefix_masked_mean,
    )

    h, neigh, w, g_dst, g_mean = (
        None if a is None else _t(a)
        for a in _prefix_case(weighted, 21 + 2 * prefix + weighted))
    n, d = h.shape[0], neigh.shape[0]
    old = h.clone().requires_grad_(True)
    s, den_old = fanout_reduce(old, neigh, w)
    mean_old = s / torch.clamp(den_old, min=1e-9)
    outs_old, grads = (((old[:d], mean_old), (g_dst, g_mean)) if prefix
                       else ((mean_old,), (g_mean,)))
    (g_old,) = torch.autograd.grad(outs_old, old, grads)

    new = h.clone().requires_grad_(True)
    if prefix:
        h_dst, mean, den = prefix_masked_mean(new, neigh, w)
        (g_new,) = torch.autograd.grad((h_dst, mean), new, grads)
    else:
        mean, den = masked_mean(new, neigh, w)
        (g_new,) = torch.autograd.grad(mean, new, grads)
    assert torch.equal(mean, mean_old) and torch.equal(den, den_old)
    assert torch.equal(g_new, g_old)
    plain_mean, plain_den = masked_mean_plain(h, neigh, w)
    assert torch.equal(plain_mean, mean_old) and torch.equal(plain_den, den)
    g_dst_arg = g_dst if prefix else None
    ref = fanout_backward_plain(g_mean / torch.clamp(den, min=1e-9), neigh,
                                w, n, g_dst_arg)
    assert torch.equal(fanout_backward(g_mean, neigh, w, n, g_dst_arg, den),
                       ref)
    assert torch.equal(g_new, ref)


def test_masked_mean_without_a_gradient_skips_autograd():
    """A table that needs no gradient, or a call under ``no_grad``, takes
    the launch alone: the outputs have no autograd node, and equal the
    tracked call's."""
    from xgnn_tpu_torch.ops.fanout import (
        fanout_reduce,
        masked_mean,
        prefix_masked_mean,
    )

    h, neigh, w, _, _ = (None if a is None else _t(a)
                         for a in _prefix_case(True, 31))
    tracked = h.clone().requires_grad_(True)
    for fn in (fanout_reduce, masked_mean, prefix_masked_mean):
        outs = fn(tracked, neigh, w)
        assert outs[-2].grad_fn is not None and not outs[-1].requires_grad
        with torch.no_grad():
            quiet = fn(tracked, neigh, w)
        plain = fn(h, neigh, w)
        for a, b, c in zip(outs, quiet, plain):
            assert b.grad_fn is None and c.grad_fn is None
            assert torch.equal(a, b) and torch.equal(a, c)
    with pytest.raises(NotImplementedError):
        masked_mean(h, neigh, w.clone().requires_grad_(True))
    with pytest.raises(ValueError):
        prefix_masked_mean(h[:10], neigh, w)  # D > N


def test_fanout_backward_refuses_a_bad_denom():
    from xgnn_tpu_torch.ops.fanout import fanout_backward

    gs = torch.zeros((3, 4))
    neigh = torch.zeros((3, 2), dtype=torch.int32)
    assert fanout_backward(gs, neigh, None, 5, denom=torch.ones((3, 1))).eq(
        0).all()
    for denom in (torch.ones((2, 1)), torch.ones((3, 1)).double(),
                  torch.ones((6, 1))[::2]):
        with pytest.raises(ValueError):
            fanout_backward(gs, neigh, None, 5, denom=denom)


# --------------------------------------------------------------- SAGE model
def _jax_batch(ds, direct, fanout, seed):
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.sampler import Sampler as JSampler
    from xgnn_tpu.types import Graph as JGraph

    cfg = JConfig(batch_size=48, fanout=fanout, num_layer=len(fanout))
    sampler = JSampler(JGraph.from_dataset(ds), cfg, direct_extract=direct)
    seeds = np.asarray(ds.train_set[:48], np.int32)
    return sampler.sample(jnp.asarray(seeds), 48, jax.random.key(seed))


def _port_blocks(jbatch):
    from xgnn_tpu_torch.types import Block

    blocks = []
    for b in jbatch.blocks:
        blocks.append(Block(
            neigh=_t(b.neigh), num_dst=_t(b.num_dst), num_src=_t(b.num_src),
            dst_ids=None if b.dst_ids is None else _t(b.dst_ids),
        ))
    return blocks


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("fanout", [(4, 3), (5, 4, 3)])
def test_gnn_forward_and_grads_match_flax(small_ds, direct, fanout):
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models.gnn import GNN
    from xgnn_tpu_torch.ops.gather import gather_rows

    jb = _jax_batch(small_ds, direct, fanout, seed=len(fanout))
    feat = np.asarray(small_ds.feat, np.float32)
    if direct:
        x = feat
    else:  # the features of the input frontier, zero rows for EMPTY
        x = gather_rows(_t(feat), _t(jb.input_nodes)).numpy()
    nl, num_class = len(fanout), 8
    jmodel = JGNN(conv="graphsage", hidden_dim=16, out_dim=num_class,
                  num_layers=nl, dropout=0.0)
    params = jmodel.init(jax.random.key(5), jb.blocks, jnp.asarray(x),
                         False)["params"]
    g = np.random.default_rng(1).standard_normal(
        (jb.blocks[-1].dst_cap, num_class)).astype(np.float32)
    nd = int(jb.num_output)

    def jloss(p):
        out = jmodel.apply({"params": p}, jb.blocks, jnp.asarray(x), False)
        return jnp.sum(out[:nd] * g[:nd]), out

    (_, ref), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)

    model = GNN(x.shape[1], 16, num_class, nl, dropout=0.0)
    model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, params)))
    out = model(_port_blocks(jb), _t(x), train=True)
    torch.sum(out[:nd] * _t(g)[:nd]).backward()

    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy()[:nd],
                               np.asarray(ref)[:nd], **tol)
    for i, layer in enumerate(model.layers):
        jl = jgrads[f"SAGEConv_{i}"]
        np.testing.assert_allclose(layer.fc_self.weight.grad.numpy().T,
                                   np.asarray(jl["Dense_0"]["kernel"]), **tol)
        np.testing.assert_allclose(layer.fc_neigh.weight.grad.numpy().T,
                                   np.asarray(jl["Dense_1"]["kernel"]), **tol)
        np.testing.assert_allclose(layer.fc_neigh.bias.grad.numpy(),
                                   np.asarray(jl["Dense_1"]["bias"]), **tol)


def test_init_is_lecun_normal_and_seeded():
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.models import build_model

    cfg = RunConfig(num_hidden=256, num_layer=2)
    a = build_model(cfg, 128, 47, torch.Generator().manual_seed(0))
    b = build_model(cfg, 128, 47, torch.Generator().manual_seed(0))
    w = a.layers[0].fc_self.weight.detach()
    assert torch.equal(w, b.layers[0].fc_self.weight)
    std = float(w.std())
    assert abs(std - (1 / 128) ** 0.5) < 0.1 * (1 / 128) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 128) ** 0.5 / 0.8796 + 1e-6
    assert torch.count_nonzero(a.layers[0].fc_neigh.bias) == 0


def test_dropout_is_flax_style():
    from xgnn_tpu_torch.models.gnn import apply_dropout

    h = torch.ones((2000, 8))
    out = apply_dropout(h, 0.5, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.all(out[kept] == 2.0)
    assert abs(float(kept.float().mean()) - 0.5) < 0.02
    assert apply_dropout(h, 0.0, None) is h


# ---------------------------------------------------------- loss and Adam
def test_loss_fn_matches_jax():
    from xgnn_tpu.train import loss_fn as jax_loss
    from xgnn_tpu_torch.train import loss_fn

    rng = np.random.default_rng(0)
    logits = rng.standard_normal((20, 6)).astype(np.float32)
    labels = rng.integers(-1, 6, 20).astype(np.int32)
    labels[:3] = -1  # clipped to 0 for the loss, never "correct"
    ref = jax_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.int32(15))
    out = loss_fn(_t(logits), _t(labels), torch.tensor(15))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(float(o), float(r), rtol=1e-6)


def test_adam_matches_optax():
    import optax

    from xgnn_tpu_torch.train import Adam

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    grads = [rng.standard_normal((4, 3)).astype(np.float32) for _ in range(5)]
    tx = optax.adam(0.01)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = _t(p0.copy())
    opt = Adam([tp], 0.01)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([_t(g)])
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-7)
    assert int(opt.count) == 5


def test_skip_update_leaves_state_unchanged():
    from xgnn_tpu_torch.train import Adam

    p = torch.randn(5, 3, generator=torch.Generator().manual_seed(0))
    opt = Adam([p], 0.01)
    opt.step([torch.ones(5, 3)])
    before = [t.clone() for t in (p, opt.mu[0], opt.nu[0], opt.count)]
    opt.step([torch.full((5, 3), 7.0)], skip=torch.tensor(True))
    for a, b in zip((p, opt.mu[0], opt.nu[0], opt.count), before):
        assert torch.equal(a, b)
    opt.step([torch.full((5, 3), 7.0)], skip=torch.tensor(False))
    assert not torch.equal(p, before[0])
    assert int(opt.count) == 2


# ------------------------------------------------------- shuffler, dataset
@pytest.mark.parametrize("batch_size,epoch", [(64, 0), (100, 3), (900, 1)])
def test_shuffler_matches_jax(learn_ds, batch_size, epoch):
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler
    from xgnn_tpu_torch.engine.shuffler import Shuffler

    a = list(Shuffler(learn_ds.train_set, batch_size, seed=43)
             .epoch_batches(epoch))
    b = list(JShuffler(learn_ds.train_set, batch_size, seed=43)
             .epoch_batches(epoch))
    assert len(a) == len(b)
    for (sa, na), (sb, nb) in zip(a, b):
        assert na == nb
        np.testing.assert_array_equal(sa, sb)


def test_device_dataset_csr_is_well_formed():
    from xgnn_tpu_torch.synthetic_device import make_device_dataset

    ds = make_device_dataset(10_000, 40_000, 16, 5, seed=3, device="cpu",
                             dedup=False)
    indptr = ds.graph.indptr.long()
    indices = ds.graph.indices.long()
    assert indptr.shape == (10_001,) and int(indptr[0]) == 0
    assert torch.all(indptr[1:] >= indptr[:-1])
    assert int(indptr[-1]) == ds.num_edge == indices.shape[0]
    src = torch.repeat_interleave(torch.arange(10_000), indptr.diff())
    assert not torch.any(src == indices)  # no self-loops
    assert 0 < ds.num_edge <= 80_000
    assert int(indices.min()) >= 0 and int(indices.max()) < 10_000
    assert ds.feat.shape == (10_000, 16) and ds.label.dtype == torch.int32
    assert len(ds.train_set) == 800
    again = make_device_dataset(10_000, 40_000, 16, 5, seed=3, device="cpu",
                                dedup=False)
    assert torch.equal(again.graph.indptr, ds.graph.indptr)
    assert torch.equal(again.graph.indices, ds.graph.indices)
