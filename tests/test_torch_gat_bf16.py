"""GAT under bfloat16 in the port against the JAX package, on the CPU.

Under ``feat_dtype`` or ``compute_dtype`` "bfloat16" layer 0 of GAT reads
bfloat16 rows.  JAX's ``GATConv`` multiplies them through ``_mp_dot``:
bfloat16 operands (the projection rounded to bfloat16) and a float32
result, for ``el_dst``, the scores and the per-head transform; its
aggregate and every later layer are float32.  The port keeps K5's
accumulators in float32 and rounds the projections where JAX does
(``models/gnn._mp_dot``), so:

- K5's plain version over a bfloat16 table equals the same over the
  widened float32 table, bit for bit;
- ``GNN`` (two layers, 1 and 2 heads, local-id blocks through K5's prefix
  form and direct-extract blocks through its dst-ids form, a bfloat16
  table and float32 rows cast by ``compute_dtype``) against JAX's
  aggregate-first form (forced with ``acc_limit``): logits within 1e-5,
  the gradients within 1e-5 but those of layer 0's ``kernel`` and
  ``attn_r``: JAX's ``_mp_dot`` sits inside its per-pick score, so its
  gradient of ``wr`` is a sum of K bfloat16-rounded terms, one a pick,
  where the port's cast rounds their sum once; they differ by at most
  (K + 1) / 2 bfloat16 ulps, held at the gradient's largest magnitude;
- the same against JAX's default path selection (its contraction form at
  two heads rounds the attention weights to bfloat16) at JAX's own 3e-2;
- six Adam steps of the ``Engine`` against the JAX ``Engine`` at dropout
  0, within 1e-4, with JAX's aggregate-first form; ``device_loop`` equal
  to the host loop.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu.constants import EMPTY_KEY  # noqa: E402

from test_torch_port_options import _BASE, _trajectory  # noqa: E402
from test_torch_port_slice import _t  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)  # float32 sums in other orders
TOL_JAX_BF16 = dict(rtol=3e-2, atol=3e-2)  # tests/test_models.py's
TOL_STEPS = dict(rtol=1e-4, atol=1e-4)  # a few steps of float32 training
BF16_ULP = 2.0 ** -8  # bfloat16's spacing at 1, relative to the magnitude
FANOUT0 = 5  # layer 0's picks a dst row


def _blocks(rng, direct):
    """Two blocks, outermost first, over a 64-row table: layer 0 of 20 of
    32 dst rows and fanout 5, local ids into its first 60 rows or (direct
    extract) global ids of the table with the dst rows' ids (some EMPTY);
    layer 1 of 8 of 16 dst rows over layer 0's 20, fanout 3."""
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.types import Block

    jblocks, blocks = [], []
    for layer, (nd, ns, k, dcap) in enumerate(((20, 60, FANOUT0, 32),
                                               (8, 20, 3, 16))):
        neigh = np.full((dcap, k), EMPTY_KEY, np.int32)
        for i in range(nd):
            c = rng.integers(1, k + 1)
            neigh[i, :c] = rng.integers(0, ns, c)
        dst = None
        if direct and layer == 0:
            dst = rng.integers(0, 64, dcap).astype(np.int32)
            dst[nd:] = EMPTY_KEY
        jblocks.append(JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(nd),
                              num_src=jnp.int32(ns),
                              dst_ids=None if dst is None
                              else jnp.asarray(dst)))
        blocks.append(Block(neigh=_t(neigh), num_dst=_t(np.int32(nd)),
                            num_src=_t(np.int32(ns)),
                            dst_ids=None if dst is None else _t(dst)))
    return jblocks, blocks


def _grads(heads, direct, source, acc_limit, seed, width=12):
    """``(ref, out, jax grads, port grads)`` of a two-layer GAT over the
    bfloat16 rows of ``source``: "feat" hands both models a bfloat16
    table, "compute" float32 rows with ``compute_dtype`` bfloat16.  A
    table wider than the hidden layer's 16 takes the per-head branch at
    layer 0."""
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models.gnn import GNN

    rng = np.random.default_rng(seed)
    jblocks, blocks = _blocks(rng, direct)
    x = rng.standard_normal((64, width)).astype(np.float32)
    g = rng.standard_normal((16, 5)).astype(np.float32)
    compute = source == "compute"
    jx = jnp.asarray(x) if compute else jnp.asarray(x).astype(jnp.bfloat16)
    px = _t(x) if compute else _t(x).to(torch.bfloat16)
    jmodel = JGNN(conv="gat", hidden_dim=16, out_dim=5, num_layers=2,
                  dropout=0.0, num_heads=heads, gat_acc_limit=acc_limit,
                  compute_dtype=jnp.bfloat16 if compute else jnp.float32)
    params = jmodel.init({"params": jax.random.key(seed)}, jblocks, jx,
                         False)["params"]

    def jloss(p):
        out = jmodel.apply({"params": p}, jblocks, jx, False)
        return jnp.sum(out * g), out

    (_, ref), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    model = GNN(width, 16, 5, 2, dropout=0.0, conv="gat", num_heads=heads,
                compute_dtype=torch.bfloat16 if compute else torch.float32)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    out = model(blocks, px, train=True)
    torch.sum(out * _t(g)).backward()
    want = params_from_flax(jax.tree.map(np.asarray, jg))
    got = {n: p.grad for n, p in model.named_parameters()}
    return np.asarray(ref), out.detach().numpy(), want, got


def test_k5_plain_over_bf16_equals_the_widened_table():
    """Both modes, forward and the backward that writes no table gradient,
    bit-equal to the same over the widened float32 table."""
    from xgnn_tpu_torch.ops.attend import (
        PER_HEAD,
        SHARED,
        attend_backward,
        attend_forward,
    )

    rng = np.random.default_rng(1)
    n, f, d, k = 200, 16, 90, 6
    half = torch.from_numpy(rng.standard_normal((n, f)).astype(
        np.float32)).to(torch.bfloat16)
    neigh = rng.integers(0, n, (d, k)).astype(np.int32)
    neigh[rng.random((d, k)) < 0.25] = EMPTY_KEY
    el = _t(rng.standard_normal((d, 2)).astype(np.float32))
    for mode, shape in ((SHARED, (f, 2)), (PER_HEAD, (2, f // 2))):
        proj = _t((0.3 * rng.standard_normal(shape)).astype(np.float32))
        got = attend_forward(half, _t(neigh), el, proj, mode)
        want = attend_forward(half.float(), _t(neigh), el, proj, mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        gout = _t(rng.standard_normal(got[0].shape).astype(np.float32))
        back = attend_backward(gout, half, _t(neigh), el, proj, *got[1:],
                               mode, False)
        back32 = attend_backward(gout, half.float(), _t(neigh), el, proj,
                                 *got[1:], mode, False)
        assert back[0] is None
        assert all(torch.equal(a, b) for a, b in zip(back[1:], back32[1:]))


@pytest.mark.parametrize("width", [12, 24], ids=["shared", "per_head"])
@pytest.mark.parametrize("source", ["feat", "compute"])
@pytest.mark.parametrize("direct", [False, True], ids=["prefix", "dst_ids"])
@pytest.mark.parametrize("heads", [1, 2])
def test_gat_bf16_matches_jax_aggregate_first(heads, direct, source, width):
    """Against JAX's aggregate-first form (acc_limit above every layer's
    accumulator): the logits within 1e-5 and the gradients as the module
    docstring says.  At width 24 layer 0 takes the per-head branch, whose
    K5 table is the transform's float32 output."""
    ref, out, want, got = _grads(heads, direct, source, 2**40, seed=heads,
                                 width=width)
    np.testing.assert_allclose(out, ref, **TOL)
    rounded = ("layers.0.kernel", "layers.0.attn_r")
    for name, grad in got.items():
        w = want[name].numpy()
        if name in rounded:
            atol = (FANOUT0 + 1) / 2 * BF16_ULP * np.abs(w).max()
            np.testing.assert_allclose(grad.numpy(), w, rtol=0, atol=atol,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(grad.numpy(), w, **TOL, err_msg=name)


@pytest.mark.parametrize("direct", [False, True], ids=["prefix", "dst_ids"])
@pytest.mark.parametrize("heads", [1, 2])
def test_gat_bf16_matches_jax_default_paths(heads, direct):
    """Against JAX's default path selection (two heads: its contraction
    form, whose aggregate multiplies bfloat16-rounded attention weights),
    logits and gradients at JAX's own bfloat16 tolerance, 3e-2."""
    ref, out, want, got = _grads(heads, direct, "feat", None, seed=10 + heads)
    np.testing.assert_allclose(out, ref, **TOL_JAX_BF16)
    for name, grad in got.items():
        np.testing.assert_allclose(grad.numpy(), want[name].numpy(),
                                   **TOL_JAX_BF16, err_msg=name)


def test_gat_under_bf16_constructs_and_trains(learn_ds):
    """``RunConfig(model="gat")`` under ``feat_dtype`` and under
    ``compute_dtype`` "bfloat16" constructs, and an epoch trains to finite
    losses; the table is bfloat16 under ``feat_dtype``."""
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.models.gnn import GNN

    ds = Dataset.from_arrays(learn_ds)
    for kw in (dict(feat_dtype="bfloat16"), dict(compute_dtype="bfloat16"),
               dict(feat_dtype="bfloat16", compute_dtype="bfloat16")):
        cfg = RunConfig(model="gat", num_head=2, batch_size=256,
                        fanout=(5, 4), num_layer=2, num_hidden=16,
                        calibration_batches=1, pipeline=False, **kw)
        eng = Engine(ds, cfg, device="cpu").init()
        assert eng.feature_source.feat.dtype == (
            torch.bfloat16 if "feat_dtype" in kw else torch.float32)
        assert np.isfinite(eng.train_epoch(0)["loss"])
    assert GNN(8, 8, 3, 2, conv="gat",
               compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16


def test_gat_bf16_device_loop_equals_the_host_loop(learn_ds):
    """``device_loop`` over the bfloat16 table: two epochs at dropout 0.5,
    every step's loss and accuracy equal to the host loop's within 1e-5."""
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.dataset import Dataset

    ds = Dataset.from_arrays(learn_ds)
    hist = []
    for device_loop in (False, True):
        cfg = RunConfig(model="gat", num_head=2, feat_dtype="bfloat16",
                        batch_size=256, fanout=(5, 4), num_layer=2,
                        num_hidden=16, dropout=0.5, calibration_batches=1,
                        device_loop=device_loop)
        eng = Engine(ds, cfg, device="cpu").init()
        for epoch in range(2):
            eng.train_epoch(epoch)
        assert (eng._fused is not None) == device_loop
        hist.append([eng.history[e] for e in range(2)])
    for host, fused in zip(*hist):
        assert np.all(np.isfinite(host["loss"]))
        np.testing.assert_allclose(fused["loss"], host["loss"], rtol=1e-5)
        np.testing.assert_allclose(fused["acc"], host["acc"], rtol=1e-5)


@pytest.mark.parametrize("case", [
    dict(feat_dtype="bfloat16"),
    dict(feat_dtype="bfloat16", num_head=2),
    dict(compute_dtype="bfloat16", num_head=2),
    # non-direct extract: the float32 rows cast, K5's prefix form
    dict(compute_dtype="bfloat16", gpu_extract=False),
], ids=["feat-1", "feat-2", "compute-2", "compute-nondirect-1"])
def test_gat_bf16_trajectory_matches_jax_engine(learn_ds, case, monkeypatch):
    """Six Adam steps at dropout 0 from flax's initial weights, the JAX
    Engine (aggregate-first, XGNN_GAT_ACC_LIMIT) against the port:
    per-step losses within 1e-4."""
    monkeypatch.setenv("XGNN_GAT_ACC_LIMIT", str(2**40))
    common = dict(_BASE, model="gat",
                  batch_size=len(learn_ds.train_set) // 21, **case)
    jl, pl = _trajectory(learn_ds, common)
    assert len(pl) == 6 and np.isfinite(jl).all()
    np.testing.assert_allclose(pl, jl, **TOL_STEPS)
