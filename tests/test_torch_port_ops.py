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


# ------------------------------------------------------------------- unique
@pytest.mark.parametrize("out_cap", [400, 60, 9])  # ample, overflow, tiny
def test_unique_seeded_matches_jax(out_cap):
    from xgnn_tpu.ops.unique import unique_seeded as jax_unique
    from xgnn_tpu_torch.ops.unique import unique_seeded

    rng = np.random.default_rng(out_cap)
    prev_cap, num_prev = 32, 25
    prev = np.full(prev_cap, EMPTY_KEY, np.int32)
    prev[:num_prev] = rng.choice(500, num_prev, replace=False)
    picks = rng.integers(0, 120, 200).astype(np.int32)
    picks[::4] = EMPTY_KEY
    picks[1::9] = prev[rng.integers(0, num_prev, len(picks[1::9]))]
    ids = np.concatenate([prev, picks])
    ref = jax_unique(jnp.asarray(ids), jnp.int32(num_prev), prev_cap, out_cap)
    out = unique_seeded(_t(ids), torch.tensor(num_prev, dtype=torch.int32),
                        prev_cap, out_cap)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    assert (int(out[1]) > out_cap) == (out_cap != 400)  # overflow flagged


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

    ds = make_device_dataset(10_000, 40_000, 16, 5, seed=3, device="cpu")
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
    again = make_device_dataset(10_000, 40_000, 16, 5, seed=3, device="cpu")
    assert torch.equal(again.graph.indptr, ds.graph.indptr)
    assert torch.equal(again.graph.indices, ds.graph.indices)
