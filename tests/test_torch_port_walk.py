"""The port's random walk (K9), with-replacement samplers (K8a), PinSAGE
and MLP against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in ``xgnn_tpu_torch``; the walk's uniforms are the ones
the JAX function draws, found by repeating its key splits here.  On the CPU
the kernel wrappers take their plain PyTorch versions; ``chip_smoke.py``
and ``tests/test_torch_port_cuda.py`` hold the CUDA kernels to those
versions on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402

from test_torch_port_slice import _walk_uniforms as walk_uniforms  # noqa: E402,E501

# float32 sums in other orders than XLA's: 1e-4 relative, 1e-5 absolute
TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _csr(rng, degrees, num_ids=None):
    """A CSR over ``len(degrees)`` nodes whose neighbours are drawn from the
    first ``num_ids`` ids (few ids: many repeated visits)."""
    n = len(degrees)
    indptr = np.concatenate([[0], np.cumsum(degrees)]).astype(np.int32)
    indices = rng.integers(0, num_ids or n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _frontier(rng, n, b, degrees):
    """EMPTY seeds, seeds of degree 0 and a tail of EMPTY padding."""
    frontier = rng.integers(0, n, b).astype(np.int32)
    frontier[::7] = EMPTY_KEY
    frontier[3] = int(np.flatnonzero(degrees == 0)[0])
    frontier[-5:] = EMPTY_KEY
    return frontier


# ------------------------------------------------------------- K9 walk
@pytest.mark.parametrize("w,l,k,p", [
    (4, 3, 5, 0.5),  # the bench's walk
    (2, 5, 3, 0.0),  # never restarts
    (3, 4, 12, 1.0),  # restarts before every step; K = W*L
    (5, 2, 8, 0.7),  # float32(0.7) < 0.7
    (1, 1, 1, 0.3),
])
def test_random_walk_matches_jax(w, l, k, p):
    from xgnn_tpu.ops.random_walk import sample_random_walk as jwalk
    from xgnn_tpu_torch.ops.random_walk import sample_random_walk

    rng = np.random.default_rng(w * 10 + l)
    degrees = rng.choice([0, 1, 2, 3, 8, 40], size=60)
    indptr, indices = _csr(rng, degrees, num_ids=12)
    frontier = _frontier(rng, 60, 90, degrees)
    key = jax.random.key(w + l)
    ref_n, ref_w, _ = jwalk(jnp.asarray(indptr), jnp.asarray(indices),
                            jnp.asarray(frontier), k, key, num_random_walk=w,
                            random_walk_length=l, restart_prob=p)
    u = walk_uniforms(key, 90, w, l)
    neigh, weights = sample_random_walk(_t(indptr), _t(indices),
                                        _t(frontier), k, num_random_walk=w,
                                        random_walk_length=l,
                                        restart_prob=p, u=u)
    assert neigh.dtype == torch.int32 and weights.dtype == torch.float32
    np.testing.assert_array_equal(neigh.numpy(), np.asarray(ref_n))
    np.testing.assert_array_equal(weights.numpy(), np.asarray(ref_w))
    # EMPTY seeds and seeds of degree 0 visit nothing
    dead = (frontier == EMPTY_KEY) | (degrees[np.minimum(frontier, 59)] == 0)
    assert np.all(neigh.numpy()[dead] == EMPTY_KEY)
    assert np.all(weights.numpy()[dead] == 0)
    if w * l > 2:
        wt = weights.numpy()[~dead]
        # rows with ties in count, and rows with fewer distinct visits
        # than K (EMPTY after the last visit, weight 0)
        assert np.any(wt[:, :-1] == wt[:, 1:])
        assert np.any((wt[:, 0] > 0) & (wt[:, -1] == 0))


def test_random_walk_restart_compares_in_float32_as_jax():
    """A restart draw equal to float32(p), for a p that float32 rounds
    down, restarts under a float64 compare but not under JAX's float32
    one.  On the chain 0 -> 1 -> 2 a walker from 0 visits 1 and then 2, or
    1 again after a restart."""
    from xgnn_tpu_torch.ops.random_walk import sample_random_walk

    p = 0.7
    u_r = np.float32(p)
    assert float(u_r) < p and not bool(jnp.asarray(u_r) < p)  # JAX: none
    indptr = _t(np.array([0, 1, 2, 3], np.int32))
    indices = _t(np.array([1, 2, 0], np.int32))
    frontier = _t(np.array([0, 0], np.int32))
    u_step = torch.zeros((2, 2, 1))
    u_restart = torch.tensor([[[1.0], [1.0]], [[u_r], [np.nextafter(
        u_r, np.float32(0))]]], dtype=torch.float32)
    neigh, weights = sample_random_walk(
        indptr, indices, frontier, 2, num_random_walk=1,
        random_walk_length=2, restart_prob=p, u=(u_step, u_restart))
    assert neigh.tolist() == [[1, 2], [1, EMPTY_KEY]]
    assert weights.tolist() == [[1.0, 1.0], [2.0, 0.0]]


def test_random_walk_draws_its_own_uniforms_from_a_generator():
    from xgnn_tpu_torch.ops.random_walk import sample_random_walk

    rng = np.random.default_rng(0)
    indptr, indices = (_t(a) for a in _csr(rng, rng.integers(0, 9, 40)))
    frontier = _t(np.arange(40, dtype=np.int32))
    kw = dict(num_random_walk=4, random_walk_length=3, restart_prob=0.5)
    a = sample_random_walk(indptr, indices, frontier, 5,
                           torch.Generator().manual_seed(3), **kw)
    b = sample_random_walk(indptr, indices, frontier, 5,
                           torch.Generator().manual_seed(3), **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_random_walk_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.random_walk import (
        sample_random_walk,
        sample_random_walk_plain,
    )

    rng = np.random.default_rng(1)
    indptr, indices = (_t(a) for a in _csr(rng, rng.integers(0, 9, 20)))
    frontier = _t(np.arange(20, dtype=np.int32))
    g = torch.Generator().manual_seed(0)
    u = (torch.rand((3, 20, 4), generator=g),
         torch.rand((3, 20, 4), generator=g))
    kw = dict(num_random_walk=4, random_walk_length=3, restart_prob=0.5)
    # on the CPU the wrapper is the plain version
    got = sample_random_walk(indptr, indices, frontier, 5, u=u, **kw)
    want = sample_random_walk_plain(indptr, indices, frontier, 5, u=u, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bad = [
        ((indptr.long(), indices, frontier, 5), kw, u),
        ((indptr, indices, frontier.long(), 5), kw, u),
        ((indptr, indices, frontier, 13), kw, u),  # fanout > W*L
        ((indptr, indices, frontier, 0), kw, u),
        # 8 walks of 9 steps: more visits than the kernel keeps
        ((indptr, indices, frontier, 5),
         dict(kw, num_random_walk=8, random_walk_length=9), None),
        ((indptr, indices, frontier, 5), kw, (u[0],)),
        ((indptr, indices, frontier, 5), kw, (u[0][:, :19], u[1])),
        ((indptr, indices, frontier, 5), kw, (u[0], u[1].double())),
        ((indptr, indices, frontier, 5), kw,
         (u[0].transpose(0, 1).contiguous().transpose(0, 1), u[1])),
    ]
    for args, kwargs, uu in bad:
        with pytest.raises(ValueError):
            sample_random_walk(*args, u=uu, **kwargs)


# ------------------------------------------------ K8a uniform_wr, khop1
@pytest.mark.parametrize("name", ["sample_uniform_wr", "sample_khop1"])
@pytest.mark.parametrize("fanout", [3, 15])
def test_with_replacement_picks_match_jax(name, fanout):
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops import sampling

    rng = np.random.default_rng(fanout)
    degrees = rng.choice([0, 1, 2, 3, 5, 15, 40], size=80)
    indptr, indices = _csr(rng, degrees)
    frontier = _frontier(rng, 80, 120, degrees)
    u = rng.random((120, fanout)).astype(np.float32)
    ref = np.asarray(getattr(jsampling, name)(
        jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(frontier),
        fanout, u=jnp.asarray(u)))
    out = getattr(sampling, name)(_t(indptr), _t(indices), _t(frontier),
                                  fanout, u=_t(u))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    dead = (frontier == EMPTY_KEY) | (degrees[np.minimum(frontier, 79)] == 0)
    assert np.all(out.numpy()[dead] == EMPTY_KEY)
    if name == "sample_uniform_wr":
        assert np.all(out.numpy()[~dead] != EMPTY_KEY)  # duplicates kept
    else:
        assert np.any(out.numpy()[~dead] == EMPTY_KEY)  # draws collided


def test_khop1_sorts_and_masks_repeats_without_compacting():
    from xgnn_tpu.ops import sampling as jsampling
    from xgnn_tpu_torch.ops.sampling import sample_khop1

    indptr = np.array([0, 2], np.int32)
    indices = np.array([3, 5], np.int32)
    frontier = np.array([0], np.int32)
    u = np.array([[0.9, 0.1, 0.2]], np.float32)  # offsets 1, 0, 0
    out = sample_khop1(_t(indptr), _t(indices), _t(frontier), 3, u=_t(u))
    assert out.tolist() == [[3, EMPTY_KEY, 5]]
    ref = jsampling.sample_khop1(indptr, indices, frontier, 3, u=u)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_with_replacement_refuses_what_it_cannot_take():
    from xgnn_tpu_torch.ops.sampling import (
        sample_khop1,
        sample_khop1_plain,
        sample_uniform_wr,
    )

    rng = np.random.default_rng(2)
    indptr, indices = (_t(a) for a in _csr(rng, rng.integers(0, 9, 20)))
    frontier = _t(np.arange(20, dtype=np.int32))
    u = torch.rand((20, 4), generator=torch.Generator().manual_seed(0))
    assert torch.equal(sample_khop1(indptr, indices, frontier, 4, u=u),
                       sample_khop1_plain(indptr, indices, frontier, 4, u=u))
    for fn in (sample_uniform_wr, sample_khop1):
        for k, uu in ((65, None), (0, None), (4, u[:, :3]), (4, u.double())):
            with pytest.raises(ValueError):
                fn(indptr, indices, frontier, k, u=uu)


# ------------------------------------------------- PinSAGEConv, MLPConv
def _blocks(seed, direct, n_src, d=20, k=5):
    """A JAX block and the port's with visit-count weights (0 on EMPTY),
    repeats across rows, a dst row with no valid pick; a direct-extract
    block's dst ids include EMPTY."""
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.types import Block

    rng = np.random.default_rng(seed)
    neigh = rng.integers(0, n_src if direct else min(n_src, 3 * d),
                         (d, k)).astype(np.int32)
    neigh[rng.random((d, k)) < 0.25] = EMPTY_KEY
    neigh[3] = EMPTY_KEY
    weights = np.where(neigh == EMPTY_KEY, 0,
                       rng.integers(1, 6, (d, k))).astype(np.float32)
    dst_ids = None
    if direct:
        dst_ids = rng.integers(0, n_src, d).astype(np.int32)
        dst_ids[-2:] = EMPTY_KEY
    jb = JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(d),
                num_src=jnp.int32(n_src), weights=jnp.asarray(weights),
                dst_ids=None if dst_ids is None else jnp.asarray(dst_ids))
    pb = Block(neigh=_t(neigh), num_dst=torch.tensor(d, dtype=torch.int32),
               num_src=torch.tensor(n_src, dtype=torch.int32),
               dst_ids=None if dst_ids is None else _t(dst_ids),
               weights=_t(weights))
    return jb, pb


@pytest.mark.parametrize("direct", [True, False])
@pytest.mark.parametrize("conv_name", ["PinSAGEConv", "MLPConv"])
def test_conv_matches_flax(conv_name, direct):
    """Forward, every parameter's gradient and (on a local-id block) the
    gradient w.r.t. h_src, against flax through ``params_from_flax``."""
    from xgnn_tpu.models import gnn as jgnn
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models import gnn

    n_src, width, out_dim, seed = 60, 8, 6, len(conv_name) + direct
    jb, pb = _blocks(seed, direct, n_src)
    h = np.random.default_rng(seed + 1).standard_normal(
        (n_src, width)).astype(np.float32)
    jconv = getattr(jgnn, conv_name)(out_dim=out_dim)
    params = jconv.init(jax.random.key(seed), jb, jnp.asarray(h))["params"]
    out_j = jconv.apply({"params": params}, jb, jnp.asarray(h))
    g = np.random.default_rng(seed + 2).standard_normal(
        out_j.shape).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jconv.apply({"params": p}, jb, x) * g)

    jg_p, jg_h = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(h))

    def state(tree):
        s = params_from_flax({f"{conv_name}_0": jax.tree.map(np.asarray,
                                                              tree)})
        return {k[len("layers.0."):]: v for k, v in s.items()}

    conv = getattr(gnn, conv_name)(width, out_dim)
    conv.load_state_dict(state(params))
    ht = _t(h).requires_grad_(not direct)
    out = conv(pb, ht)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    torch.sum(out * _t(g)).backward()
    want = state(jg_p)
    assert set(want) == {n for n, _ in conv.named_parameters()}
    for pname, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[pname].numpy(), **TOL,
                                   err_msg=f"gradient w.r.t. {pname}")
    if not direct:
        np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jg_h), **TOL,
                                   err_msg="gradient w.r.t. h_src")


def test_build_model_pinsage_and_mlp():
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.models.gnn import MLPConv, PinSAGEConv

    cfg = RunConfig(model="pinsage", num_layer=3, num_layer_pinsage=2)
    model = build_model(cfg, 128, 47, torch.Generator().manual_seed(0))
    assert [type(m) for m in model.layers] == [PinSAGEConv, PinSAGEConv]
    assert model.activation is torch.relu
    model = build_model(RunConfig(model="mlp"), 128, 47,
                        torch.Generator().manual_seed(0))
    assert [type(m) for m in model.layers] == [MLPConv] * 3
    w = model.layers[0].fc.weight.detach()
    assert w.shape == (256, 128)
    assert abs(float(w.std()) - 128 ** -0.5) < 0.1 * 128 ** -0.5
    assert all(torch.count_nonzero(m.fc.bias) == 0 for m in model.layers)


# --------------------------------------------------------- the sampler
@pytest.mark.parametrize("direct", [True, False])
def test_pinsage_sampler_batch_matches_jax(small_ds, direct):
    """Blocks (picks, counts, weights), capacities and the input frontier of
    the two-layer walk against the JAX ``Sampler`` for the same uniforms."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.sampler import Sampler as JSampler
    from xgnn_tpu.types import Graph as JGraph
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.sampler import Sampler
    from xgnn_tpu_torch.types import Graph

    common = dict(batch_size=48, model="pinsage", num_neighbor=4,
                  num_random_walk=3, random_walk_length=3,
                  random_walk_restart_prob=0.4)
    jsampler = JSampler(JGraph.from_dataset(small_ds), JConfig(**common),
                        direct_extract=direct)
    cfg = RunConfig(**common)
    assert cfg.sample_type.value == "random_walk"  # coerced, as in JAX
    sampler = Sampler(Graph.from_dataset(small_ds, "cpu"), cfg,
                      direct_extract=direct)
    assert sampler.fanouts == (4, 4)
    assert sampler.capacities == jsampler.capacities
    seeds = np.full(48, EMPTY_KEY, np.int32)
    seeds[:40] = small_ds.train_set[:40]
    key = jax.random.key(5)
    ref = jsampler.sample(jnp.asarray(seeds), 40, key)
    us = []
    for b in [48] + sampler.capacities[1:-1]:
        key, k = jax.random.split(key)
        us.append(walk_uniforms(k, b, 3, 3))
    port = sampler.sample(_t(seeds), 40, u=us)
    assert len(port.blocks) == len(ref.blocks) == 2
    for pb, rb in zip(port.blocks, ref.blocks):
        np.testing.assert_array_equal(pb.neigh.numpy(), np.asarray(rb.neigh))
        np.testing.assert_array_equal(pb.weights.numpy(),
                                      np.asarray(rb.weights))
        assert int(pb.num_src) == int(rb.num_src)
        assert int(pb.num_dst) == int(rb.num_dst)
        assert (pb.dst_ids is None) == (rb.dst_ids is None)
        if rb.dst_ids is not None:
            np.testing.assert_array_equal(pb.dst_ids.numpy(),
                                          np.asarray(rb.dst_ids))
    assert float(port.blocks[-1].weights.sum()) > 0
    np.testing.assert_array_equal(port.input_nodes.numpy(),
                                  np.asarray(ref.input_nodes))
    assert int(port.num_input) == int(ref.num_input)
    assert bool(port.overflow) == bool(ref.overflow)


def test_pinsage_device_loop_builds_and_trains(learn_ds):
    """``device_loop``, once refused, builds and trains on the walk: each
    step runs the captured step's function (uncaptured on the CPU), with
    the same losses as the host loop."""
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.dataset import Dataset

    losses = []
    for device_loop in (False, True):
        cfg = RunConfig(model="pinsage", batch_size=64, num_hidden=8,
                        num_neighbor=3, calibration_batches=1,
                        device_loop=device_loop)
        engine = Engine(Dataset.from_arrays(learn_ds), cfg,
                        device="cpu").init()
        engine.train_epoch(0)
        assert (engine._fused is not None) == device_loop
        losses.append(engine.history[0]["loss"])
    assert np.all(np.isfinite(losses[1]))
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)


def test_unported_messages_name_roadmap_items_that_exist():
    """Each message names its ROADMAP item by a title that ROADMAP.md
    holds, so a renumbering cannot make it stale.  Every ``RunConfig`` of
    one card has its path now (GAT under bfloat16 among them), and so has
    every multi-card one: the command line's GAT with more heads than K5
    keeps still raises."""
    import re
    from pathlib import Path

    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.examples import train

    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    # use_dist_graph, once refused, is the tiered topology now, and GAT
    # under bfloat16 (ROADMAP's K5 bf16) is ported
    RunConfig(use_dist_graph=True, dist_graph_percentage=0.5)
    for kwargs in (dict(feat_dtype="bfloat16"),
                   dict(use_dist_graph=True, feat_dtype="bfloat16"),
                   dict(agg_impl="tiled", compute_dtype="bfloat16"),
                   dict(compute_dtype="bfloat16"),
                   dict(remat=True, feat_dtype="bfloat16")):
        assert RunConfig(model="gat", **kwargs).model == "gat"
    # more than one card runs the collocated engine now, its partial cache
    # (presample_static among its rankings), its host cold tier
    # (test_multicard_flags_once_refused_train below), its placement solve
    # and DCN groups (tests/test_torch_port_dcn.py), and the disaggregated
    # engine (tests/test_torch_disagg.py); GAT with more heads than K5
    # keeps raises, on one card or several
    cases = [["--model", "gat", "--num-head", "16"],
             ["--num-worker", "2", "--auto-placement", "--model", "gat",
              "--num-head", "9"],
             ["--num-dcn-groups", "2", "--num-worker", "4", "--feat-dtype",
              "bfloat16", "--model", "gat", "--num-head", "32"]]
    for argv in cases:
        with pytest.raises(NotImplementedError) as err:
            train.main(["--cpu", "--synthetic"] + argv)
        titles = [t for part in str(err.value).split("ROADMAP")[1:]
                  for t in re.findall(r"'([^']+)'", part.split(";")[0])]
        assert titles, str(err.value)
        for title in titles:
            if title.startswith("K"):
                assert f"**{title} " in roadmap, title
            else:
                assert f"**{title}" in roadmap, title
    with pytest.raises(ValueError, match="zoo"):
        RunConfig(model="gin")


@pytest.mark.parametrize("flags", [
    ["--num-worker", "2", "--compute-dtype", "bfloat16",
     "--cache-percentage", "0.5", "--cache-policy", "presample_static"],
    ["--part-cache", "--model", "gat", "--remat", "--num-worker", "2",
     "--use-dist-graph", "--dist-graph-percentage", "0.5"]],
    ids=["presample_static_bf16", "gat_remat_cold_tier"])
def test_multicard_flags_once_refused_train(flags):
    """The multi-card flags that once raised (presample_static with a
    partial cache; the host cold tier under the partitioned topology)
    train over two gloo ranks at toy size and print the test_result:
    lines."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = str(Path(__file__).resolve().parents[1])
    out = subprocess.run(
        [sys.executable, "-m", "xgnn_tpu_torch.examples.train", "--cpu",
         "--synthetic", "--synthetic-nodes", "1500", "--num-epoch", "2",
         "--batch-size", "200", "--fanout", "4", "3", "--num-hidden", "16",
         "--report-acc", "1"] + flags,
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True,
        text=True, timeout=150)
    assert out.returncode == 0, out.stderr[-3000:]
    results = dict(line.split("=", 1) for line in out.stdout.splitlines()
                   if line.startswith("test_result:"))
    for key in ("test_result:final_train_acc", "test_result:test_acc"):
        assert np.isfinite(float(results[key])), key
