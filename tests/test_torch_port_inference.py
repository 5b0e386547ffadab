"""The port's full-graph inference and evaluation against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in ``xgnn_tpu_torch``: K6a (``spmm_csr``),
``segment_max_csr``, K6b (``gat_aggregate_csr``), against JAX's scan forms
and the degree-bucketed plan that JAX's ``full_graph_inference`` runs;
``full_graph_inference`` and ``evaluate_full`` for the zoo with converted
weights; and ``Engine.evaluate`` against the JAX ``Engine.evaluate``.  On the
CPU the kernel wrappers take their plain PyTorch versions;
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py`` hold the CUDA
kernels to those versions on the card.

The graph has isolated rows, duplicate edges and one row of degree 2,500,
past the plan's hub split at 2048.  Sums over a row are taken in other
orders than XLA's, so an aggregate is held to 1e-5 of the same aggregate
of the magnitudes (``|h|``; for GAT the softmax-weighted ``|feat|``), the
error bound of a reordered float32 sum; logits to 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402

HUB = 7  # the row of degree 2,500
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _graph(n=300, seed=0):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, n)
    deg[rng.choice(n, 20, replace=False)] = 0  # isolated rows
    deg[HUB] = 2500
    deg[3] = 6
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    indices[indptr[3]: indptr[4]] = 11  # one id six times
    indices[indptr[HUB]: indptr[HUB] + 40] = 5
    return indptr, indices


def _assert_agg_close(out, ref, mass, rtol=1e-5):
    """``|out - ref| <= rtol * mass``, where ``mass`` is the aggregate of
    the terms' magnitudes: a reordered float32 sum's error scales with it."""
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    bound = rtol * np.asarray(mass, np.float64) + 1e-7
    worst = np.unravel_index(np.argmax(err - bound), err.shape)
    assert (err <= bound).all(), (worst, err[worst], bound[worst])


def _inv_deg(indptr):
    d = np.diff(indptr)
    return jnp.asarray(np.where(d > 0, 1.0 / np.maximum(d, 1), 0.0)
                       .astype(np.float32))


# ---------------------------------------------------------------- K6a
@pytest.mark.parametrize("mean", [False, True])
def test_spmm_csr_matches_jax_scan_and_plan(mean):
    """Against JAX's edge-chunked scan and its degree-bucketed plan
    (``fine_buckets``, with and without the pre-expanded ids, as
    ``full_graph_inference`` runs it); the port's chunk changes nothing."""
    from xgnn_tpu.ops import spmm as J
    from xgnn_tpu_torch.ops.spmm import spmm_csr

    indptr, indices = _graph()
    n = len(indptr) - 1
    h = np.random.default_rng(1).standard_normal((n, 24)).astype(np.float32)
    out = spmm_csr(_t(indptr), _t(indices), _t(h), num_node=n, mean=mean)
    assert out.shape == (n, 24) and out.dtype == torch.float32
    assert torch.equal(out, spmm_csr(_t(indptr), _t(indices), _t(h),
                                     num_node=n, chunk=97, mean=mean))
    mass = spmm_csr(_t(indptr), _t(indices), _t(np.abs(h)), num_node=n,
                    mean=mean).numpy()
    ji, jx, jh = jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(h)
    _assert_agg_close(out, J.spmm_csr(ji, jx, jh, num_node=n, chunk=256,
                                      mean=mean), mass)
    for pre in (False, True):
        plan, meta = J.build_spmm_plan(indptr, fine_buckets=True)
        assert any(b["cap"] == 2048 for b in plan)  # the hub, split
        if pre:
            J.materialize_plan_ids(plan, meta, jx, n)
        ref = J.spmm_csr_planned(plan, meta, jx, jh, mean=mean,
                                 inv_deg=_inv_deg(indptr))
        _assert_agg_close(out, ref, mass)
    deg = np.diff(indptr)
    assert not out.numpy()[deg == 0].any()  # empty rows are zero rows


def test_spmm_csr_plain_sums_in_csr_order():
    """The plain version's sum is each row's edges added in order from 0:
    what the kernel computes, bit for bit, on a row of at most HUB_CAP
    edges."""
    from xgnn_tpu_torch.ops.spmm import spmm_csr

    indptr, indices = _graph(seed=2)
    n = len(indptr) - 1
    h = np.random.default_rng(3).standard_normal((n, 5)).astype(np.float32)
    out = spmm_csr(_t(indptr), _t(indices), _t(h), num_node=n,
                   mean=True).numpy()
    for v in (0, 3, HUB, n - 1):
        acc = np.zeros(5, np.float32)
        for u in indices[indptr[v]: indptr[v + 1]]:
            acc = acc + h[u]
        inv = np.float32(1) / np.float32(max(indptr[v + 1] - indptr[v], 1))
        np.testing.assert_array_equal(out[v], acc * inv)


def test_segment_max_csr_matches_jax():
    from xgnn_tpu.ops.spmm import segment_max_csr as jax_segmax
    from xgnn_tpu_torch.ops.spmm import segment_max_csr

    indptr, indices = _graph(seed=4)
    n = len(indptr) - 1
    vals = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    ref = np.asarray(jax_segmax(jnp.asarray(indptr), jnp.asarray(indices),
                                jnp.asarray(vals), num_node=n, chunk=128))
    out = segment_max_csr(_t(indptr), _t(indices), _t(vals), num_node=n,
                          chunk=61)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out.numpy()[np.diff(indptr) == 0] == -1e30).all()


# ---------------------------------------------------------------- K6b
@pytest.mark.parametrize("heads,d", [
    pytest.param(1, 4, id="1"), pytest.param(2, 4, id="2"),
    pytest.param(8, 4, id="8"),
    # gat1's 47-wide logits layer and gat8's (8, 32) heads
    (1, 47), (8, 32)])
def test_gat_aggregate_csr_matches_jax_scan_and_plan(heads, d):
    from xgnn_tpu.ops import spmm as J
    from xgnn_tpu_torch.ops.spmm import gat_aggregate_csr

    indptr, indices = _graph(seed=heads)
    n = len(indptr) - 1
    rng = np.random.default_rng(10 + heads)
    feat = rng.standard_normal((n, heads, d)).astype(np.float32)
    el = rng.standard_normal((n, heads)).astype(np.float32)
    er = (2 * rng.standard_normal((n, heads))).astype(np.float32)
    args = [_t(a) for a in (indptr, indices, feat, el, er)]
    out = gat_aggregate_csr(*args, num_node=n)
    assert out.shape == (n, heads, d)
    mass = gat_aggregate_csr(*args[:2], _t(np.abs(feat)), *args[3:],
                             num_node=n).numpy()
    jargs = [jnp.asarray(a) for a in (indptr, indices, feat, el, er)]
    _assert_agg_close(out, J.gat_aggregate_csr(*jargs, num_node=n,
                                               chunk=512), mass)
    plan, meta = J.build_spmm_plan(indptr, fine_buckets=True)
    _assert_agg_close(out, J.gat_aggregate_planned(plan, meta, *jargs[1:]),
                      mass)
    assert not out.numpy()[np.diff(indptr) == 0].any()
    # the chunk is the plain version's pass size, nothing more
    torch.testing.assert_close(
        gat_aggregate_csr(*args, num_node=n, chunk=53), out, rtol=1e-6,
        atol=1e-6)


# ------------------------------------------------- full-graph inference
def _jax_blocks(rng, num_src, weighted):
    from xgnn_tpu.types import Block as JBlock

    blocks = []
    for _ in range(3):
        neigh = rng.integers(0, num_src, (num_src, 4)).astype(np.int32)
        neigh[rng.random(neigh.shape) < 0.3] = EMPTY_KEY
        blocks.append(JBlock(
            neigh=jnp.asarray(neigh), num_dst=jnp.int32(num_src),
            num_src=jnp.int32(num_src),
            weights=(jnp.asarray(rng.random(neigh.shape).astype(np.float32))
                     if weighted else None)))
    return blocks


def _models(conv, heads, in_dim, num_class, seed=0):
    """The flax GNN with initial weights, and the port's with the same."""
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models.gnn import GNN

    rng = np.random.default_rng(seed)
    jmodel = JGNN(conv=conv, hidden_dim=16, out_dim=num_class, num_layers=3,
                  dropout=0.0, num_heads=heads)
    x = jnp.asarray(rng.standard_normal((32, in_dim)).astype(np.float32))
    params = jmodel.init(jax.random.key(seed),
                         _jax_blocks(rng, 32, conv == "pinsage"), x,
                         False)["params"]
    model = GNN(in_dim, 16, num_class, 3, dropout=0.0, conv=conv,
                num_heads=heads)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jmodel, params, model


@pytest.mark.parametrize("conv,heads", [("graphsage", 1), ("gcn", 1),
                                        ("gat", 1), ("gat", 2),
                                        ("pinsage", 1)])
def test_full_graph_inference_matches_jax(conv, heads):
    """Logits of every node, three layers of 16, against JAX's
    ``full_graph_inference`` (its plan, pre-expanded but for GAT)."""
    from xgnn_tpu.inference import full_graph_inference as jax_infer
    from xgnn_tpu_torch.inference import full_graph_inference

    indptr, indices = _graph(seed=20)
    n, num_class = len(indptr) - 1, 5
    feat = np.random.default_rng(21).standard_normal((n, 12)).astype(
        np.float32)
    jmodel, params, model = _models(conv, heads, 12, num_class)
    ref = np.asarray(jax_infer(jmodel, params, jnp.asarray(indptr),
                               jnp.asarray(indices), jnp.asarray(feat)))
    out = full_graph_inference(model, indptr, indices, feat, device="cpu")
    assert out.shape == (n, num_class) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)
    # tensors and an indptr longer than the graph (num_node given) agree
    longer = np.concatenate([indptr, indptr[-1:]])
    again = full_graph_inference(model, _t(longer), _t(indices), _t(feat),
                                 num_node=n, device="cpu")
    assert torch.equal(again, out)


@pytest.mark.parametrize("conv,heads", [("graphsage", 1), ("gat", 2)])
def test_evaluate_full_matches_jax(conv, heads):
    from xgnn_tpu.inference import evaluate_full as jax_evaluate
    from xgnn_tpu_torch.inference import evaluate_full

    indptr, indices = _graph(seed=30)
    n, num_class = len(indptr) - 1, 4
    rng = np.random.default_rng(31)
    feat = rng.standard_normal((n, 12)).astype(np.float32)
    label = rng.integers(0, num_class, n).astype(np.int64)
    nodes = rng.choice(n, 120, replace=False).astype(np.int32)
    jmodel, params, model = _models(conv, heads, 12, num_class, seed=3)
    ref = jax_evaluate(jmodel, params, jnp.asarray(indptr),
                       jnp.asarray(indices), jnp.asarray(feat), label, nodes)
    got = evaluate_full(model, indptr, indices, feat, label, nodes,
                        device="cpu")
    assert got == ref
    assert 0.0 < got < 1.0


def test_full_graph_inference_refuses_mlp():
    """The JAX lookup has no full-graph MLP layer (a KeyError there)."""
    from xgnn_tpu.inference import full_graph_inference as jax_infer
    from xgnn_tpu_torch.inference import full_graph_inference

    indptr, indices = _graph(seed=40)
    n = len(indptr) - 1
    feat = np.ones((n, 12), np.float32)
    jmodel, params, _ = _models("graphsage", 1, 12, 3)
    from xgnn_tpu_torch.models.gnn import GNN

    with pytest.raises(KeyError):
        jax_infer(jmodel.clone(conv="mlp"), params, jnp.asarray(indptr),
                  jnp.asarray(indices), jnp.asarray(feat))
    with pytest.raises(ValueError, match="MLPConv"):
        full_graph_inference(GNN(12, 16, 3, 3, conv="mlp"), indptr, indices,
                             feat, device="cpu")


def test_full_graph_inference_refuses_2_31_edges():
    """Both packages refuse a graph of 2^31 edges or more before reading
    an edge."""
    from xgnn_tpu.inference import full_graph_inference as jax_infer
    from xgnn_tpu_torch.inference import full_graph_inference

    indptr = np.array([0, 2**31], np.int64)
    indices = np.zeros(4, np.int32)
    feat = np.ones((1, 12), np.float32)
    jmodel, params, model = _models("graphsage", 1, 12, 3)
    with pytest.raises(ValueError, match="2\\^31"):
        jax_infer(jmodel, params, indptr, jnp.asarray(indices),
                  jnp.asarray(feat))
    for ip in (indptr, _t(indptr)):
        with pytest.raises(ValueError, match="2\\^31"):
            full_graph_inference(model, ip, indices, feat, device="cpu")


# ------------------------------------------------------ Engine.evaluate
@pytest.fixture(scope="module")
def full_fanout_ds():
    """No row has more neighbours than the smallest fanout (3): khop0
    picks every neighbour whatever the draws, so the sampled evaluation is
    deterministic and exact."""
    from xgnn_tpu.dataset import Dataset as JDataset

    rng = np.random.default_rng(50)
    n, num_class = 600, 4
    deg = rng.integers(0, 4, n)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    label = rng.integers(0, num_class, n).astype(np.int64)
    feat = (rng.standard_normal((n, 12))
            + 0.8 * np.eye(num_class, 12)[label]).astype(np.float32)
    perm = rng.permutation(n).astype(np.int32)
    return JDataset(name="full_fanout", num_node=n, num_edge=len(indices),
                    feat_dim=12, num_class=num_class, indptr=indptr,
                    indices=indices, feat=feat, label=label,
                    train_set=perm[:200], valid_set=perm[200:430],
                    test_set=perm[430:])


@pytest.mark.parametrize("conv,heads", [("graphsage", 1), ("gcn", 1),
                                        ("gat", 2)])
def test_engine_evaluate_matches_jax(full_fanout_ds, conv, heads):
    """Converted weights, batches of 64 (the last one partial), both
    splits and ``max_batches``: the JAX ``Engine.evaluate``'s accuracy."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.engine import Engine as JEngine
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.dataset import Dataset

    ds = full_fanout_ds
    common = dict(batch_size=64, fanout=(5, 4, 3), num_layer=3, num_hidden=16,
                  model=conv, num_head=heads, dropout=0.5, pipeline=False,
                  gpu_extract=True, cache_percentage=0.0)
    jengine = JEngine(ds, JConfig(**common, num_epoch=1)).init()
    engine = Engine(Dataset.from_arrays(ds),
                    RunConfig(**common,
                              frontier_capacities=jengine.sampler.capacities),
                    device="cpu").init()
    engine.model.load_state_dict(params_from_flax(
        jax.tree.map(np.asarray, jengine.state.params)))
    for split, max_batches in (("valid", None), ("test", None),
                               ("valid", 2)):
        ref = jengine.evaluate(split, max_batches)
        got = engine.evaluate(split, max_batches)
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-7), split


def test_sampled_evaluate_equals_full_graph_on_full_fanout(full_fanout_ds):
    """Where every neighbour is sampled, GraphSAGE's sampled accuracy is
    its full-graph accuracy: both packages' layers compute each node
    exactly."""
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.inference import evaluate_full

    ds = full_fanout_ds
    engine = Engine(Dataset.from_arrays(ds),
                    RunConfig(batch_size=64, fanout=(5, 4, 3), num_hidden=16,
                              lr=0.01, pipeline=False),
                    device="cpu").init()
    engine.train_epoch(0)
    for split, nodes in (("valid", ds.valid_set), ("test", ds.test_set)):
        full = evaluate_full(engine.model, ds.indptr, ds.indices, ds.feat,
                             ds.label, nodes, device="cpu")
        assert engine.evaluate(split) == pytest.approx(full, abs=1e-6)


def test_entry_points_need_cuda_unless_told(full_fanout_ds, monkeypatch):
    from xgnn_tpu_torch.inference import evaluate_full, full_graph_inference
    from xgnn_tpu_torch.models.gnn import GNN

    ds = full_fanout_ds
    model = GNN(12, 16, 4, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        full_graph_inference(model, ds.indptr, ds.indices, ds.feat)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_full(model, ds.indptr, ds.indices, ds.feat, ds.label,
                      ds.valid_set)
    logits = full_graph_inference(model, ds.indptr, ds.indices, ds.feat,
                                  device="cpu")
    assert logits.shape == (ds.num_node, 4)
    # the model's weights stay where they are
    with pytest.raises(ValueError, match="model is on"):
        full_graph_inference(model, ds.indptr, ds.indices, ds.feat,
                             device="meta")


def test_kernel_wrappers_refuse_what_they_cannot_take():
    from xgnn_tpu_torch.ops.spmm import gat_aggregate_csr, spmm_csr

    indptr, indices = _t(np.array([0, 2, 3], np.int32)), _t(
        np.array([0, 1, 1], np.int32))
    h = torch.ones((2, 4))
    for args, kw in (((indptr.long(), indices, h), {}),
                     ((indptr, indices, h.double()), {}),
                     ((indptr, indices, h), {"num_node": 3})):
        with pytest.raises(ValueError):
            spmm_csr(*args, **{"num_node": 2, **kw})
    with pytest.raises(ValueError):
        gat_aggregate_csr(indptr, indices, h.reshape(2, 2, 2),
                          torch.ones(2, 3), torch.ones(2, 2), num_node=2)
    with pytest.raises(NotImplementedError):
        spmm_csr(indptr, indices, h.requires_grad_(), num_node=2)
