"""F16 feature files in the port against the JAX package, on the CPU.

JAX keeps a dataset's float16 table (``FEAT_DATA_TYPE F16``) in float16:
on the device, in the tiered store's host tier and cache, and through
full-graph inference, where layer 0 rounds in float16.  Its training does
no float16 arithmetic: ``GNN`` casts its input to ``compute_dtype`` before
any convolution.  The port keeps the table in float16 too and widens its
rows exactly in the kernels.  Here:

- K6a's float16 form (``spmm_csr`` over a float16 ``h``) against JAX's
  degree-bucketed plan over the same table (``spmm_csr_planned``): a row
  of one segment (at most 2048 edges) bit for bit, a longer row within
  one float16 ulp for each segment added (XLA keeps some of those sums in
  float32, as its excess precision allows, depending on which of the
  plan's chunks holds the segments);
- ``full_graph_inference`` over the float16 table (graphsage, gcn, gat,
  pinsage) against JAX's, where the float32 widening of the parent commit
  falls outside the tolerance for the three that round; the accuracy
  command line over an F16 directory against JAX's ``evaluate_full``;
- K1, K4 and K5's plain versions and the model over a float16 table equal
  to the same over the table widened to float32, bit for bit;
- the port's ``Engine`` over an F16 directory: per-step losses bit-equal
  to the port over an F32 directory of the same values, within 1e-4 of
  the JAX ``Engine`` over the F16 directory, and under ``device_loop``
  equal to the host loop;
- the tiered store over a float16 host table against JAX's
  ``TieredFeatureSource``: rows, counts and ``miss_bytes`` at 2 bytes a
  value.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_dataset_files import (  # noqa: E402
    _file_trajectory,
    _to_f16,
    _toy,
)
from test_torch_port_inference import _inv_deg, _models  # noqa: E402
from test_torch_port_slice import _t  # noqa: E402

from xgnn_tpu_torch import dataset as pdataset  # noqa: E402
from xgnn_tpu_torch.constants import EMPTY_KEY  # noqa: E402

# float32 sums in other orders than XLA's, over logits up to about 30
LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
TOL_AGG = dict(rtol=1e-5, atol=1e-5)
TOL_STEPS = dict(rtol=1e-4, atol=1e-4)  # a few steps of float32 training
SEGMENT = 2048  # JAX's plan's max_cap


def _hub_graph(seed, n=400):
    """Rows of degree 0 to 11 and rows past one segment: 2500 and 5000 (a
    partial last segment of at most 1536 edges, which JAX adds first),
    6000 (a partial of 1904, added last), 4100 (a partial of 4), 4096 and
    2048 (whole segments only)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, n)
    deg[rng.choice(n, 30, replace=False)] = 0
    for row, d in ((7, 2500), (9, 4096), (11, 5000), (13, 2048), (15, 6000),
                   (17, 4100)):
        deg[row] = d
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    return indptr, indices


def _ulp16(x):
    """The spacing of float16 at |x| (2^-24 below the normal range)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0 ** -14)
    return 2.0 ** (np.floor(np.log2(a)) - 10)


def _jax_planned(indptr, indices, h, mean):
    """JAX's full-graph aggregation as its inference runs it: the fine
    bucketed plan with the ids pre-expanded."""
    from xgnn_tpu.ops import spmm as J

    n = len(indptr) - 1
    plan, meta = J.build_spmm_plan(indptr, fine_buckets=True)
    J.materialize_plan_ids(plan, meta, jnp.asarray(indices), n)
    return np.asarray(J.spmm_csr_planned(plan, meta, jnp.asarray(indices),
                                         jnp.asarray(h), mean=mean,
                                         inv_deg=_inv_deg(indptr)))


# ------------------------------------------------------- K6a over float16
@pytest.mark.parametrize("mean", [False, True])
def test_spmm_f16_matches_jax_plan(mean):
    """Each segment summed in float32 and rounded, the mean's factor and a
    rounding more, the segments added in float16 in the plan's order: a
    row of one segment equals JAX's bit for bit, a longer row is within
    one float16 ulp for each segment added."""
    from xgnn_tpu_torch.ops.spmm import spmm_csr

    indptr, indices = _hub_graph(1)
    n = len(indptr) - 1
    h = (3 * np.random.default_rng(2).standard_normal((n, 12))).astype(
        np.float16)
    ref = _jax_planned(indptr, indices, h, mean)
    assert ref.dtype == np.float16
    out = spmm_csr(_t(indptr), _t(indices), _t(h), num_node=n, mean=mean)
    assert out.dtype == torch.float16
    out = out.numpy()
    deg = np.diff(indptr)
    one = deg <= SEGMENT
    np.testing.assert_array_equal(out[one], ref[one])
    nseg = -(-deg[~one] // SEGMENT)
    err = np.abs(out[~one].astype(np.float64) - ref[~one])
    bound = nseg[:, None] * _ulp16(np.maximum(np.abs(out[~one]),
                                              np.abs(ref[~one])))
    assert (err <= bound).all()
    # the chunk is the plain version's pass size, nothing more
    assert np.array_equal(spmm_csr(_t(indptr), _t(indices), _t(h),
                                   num_node=n, mean=mean, chunk=997).numpy(),
                          out)


@pytest.mark.parametrize("conv,heads", [("graphsage", 1), ("gcn", 1),
                                        ("gat", 1), ("pinsage", 1)])
def test_full_graph_inference_over_f16_matches_jax(conv, heads):
    """Logits of every node over a float16 table against JAX's
    ``full_graph_inference`` over the same table.  graphsage, pinsage
    (K6a's float16 mean) and gcn (the float16 degree norm) round where JAX
    rounds: the table widened to float32 first, as the parent commit did,
    falls outside the tolerance; GAT's transform widens the rows first in
    both packages."""
    from xgnn_tpu.inference import full_graph_inference as jax_infer
    from xgnn_tpu_torch.inference import full_graph_inference

    indptr, indices = _hub_graph(20)
    n, num_class = len(indptr) - 1, 5
    feat = (3 * np.random.default_rng(21).standard_normal((n, 12))).astype(
        np.float16)
    jmodel, params, model = _models(conv, heads, 12, num_class)
    ref = np.asarray(jax_infer(jmodel, params, jnp.asarray(indptr),
                               jnp.asarray(indices), jnp.asarray(feat)))
    out = full_graph_inference(model, indptr, indices, feat, device="cpu")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **LOGIT_TOL)
    widened = full_graph_inference(model, indptr, indices,
                                   feat.astype(np.float32), device="cpu")
    close = np.allclose(widened.numpy(), ref, **LOGIT_TOL)
    assert close == (conv == "gat")


def test_accuracy_cli_over_an_f16_directory_matches_jax(tmp_path):
    """The accuracy command line over an F16 directory, from a checkpoint
    of flax's initial weights: JAX's ``evaluate_full`` (what JAX's command
    line prints) over the JAX-loaded directory, equal."""
    from xgnn_tpu import load_dataset as jload
    from xgnn_tpu.inference import evaluate_full as jax_evaluate
    from xgnn_tpu.models.gnn import GNN as JGNN
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.checkpoint import CheckpointManager
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.examples import accuracy
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.train import Adam

    path = str(tmp_path / "f16")
    pdataset.save_dataset(_toy(seed=4, num_node=1200, avg_degree=6), path)
    _to_f16(path)
    jds = jload(path)
    assert np.asarray(jds.feat).dtype == np.float16
    jmodel = JGNN(conv="graphsage", hidden_dim=16, out_dim=jds.num_class,
                  num_layers=2, dropout=0.0)
    dummy = JBlock(neigh=jnp.full((4, 2), EMPTY_KEY, jnp.int32),
                   num_dst=jnp.int32(1), num_src=jnp.int32(1))
    params = jmodel.init({"params": jax.random.key(5)}, [dummy] * 2,
                         jnp.zeros((4, jds.feat_dim)), False)["params"]
    cfg = RunConfig(num_hidden=16, num_layer=2, fanout=(4, 3))
    model = build_model(cfg, jds.feat_dim, jds.num_class)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    ckpt = str(tmp_path / "ckpt")
    CheckpointManager(ckpt).save(0, (model, Adam(list(model.parameters()),
                                                 cfg.lr)))
    root, name = os.path.split(path)
    got = accuracy.main(["--cpu", "--dataset", name, "--root-path", root,
                         "--fanout", "4", "3", "--num-hidden", "16",
                         "--checkpoint-dir", ckpt])
    feat = jnp.asarray(np.asarray(jds.feat))
    for split, nodes in (("valid", jds.valid_set), ("test", jds.test_set)):
        want = jax_evaluate(jmodel, params, jnp.asarray(jds.indptr),
                            jnp.asarray(jds.indices), feat, jds.label, nodes)
        assert got[split] == want, split


# --------------------------------------------- kernels and model over f16
def test_k1_k4_k5_over_f16_equal_the_widened_table():
    """K1's plain version returns the float16 rows; K4's and K5's (both
    modes, el_dst formed from the prefix or given) over a float16 table
    equal the same over the widened float32 table, bit for bit, and K4's
    sum is JAX's loop over the widened table within 1e-5."""
    from xgnn_tpu.models.gnn import fanout_reduce as jreduce
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu_torch.ops.attend import (
        PER_HEAD,
        SHARED,
        attend_backward,
        attend_forward,
        gat_attend_prefix,
    )
    from xgnn_tpu_torch.ops.fanout import fanout_reduce, prefix_masked_mean
    from xgnn_tpu_torch.ops.gather import gather_rows

    rng = np.random.default_rng(6)
    n, f, d, k = 300, 24, 120, 5
    half = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float16))
    wide = half.float()
    neigh = rng.integers(0, n, (d, k)).astype(np.int32)
    neigh[rng.random((d, k)) < 0.3] = EMPTY_KEY
    ids = rng.integers(-2, n + 2, 77).astype(np.int32)
    rows = gather_rows(half, _t(ids))
    assert rows.dtype == torch.float16
    assert torch.equal(rows.float(), gather_rows(wide, _t(ids)))
    w = _t(rng.random((d, k)).astype(np.float32) + 0.5)
    s16, d16 = fanout_reduce(half, _t(neigh), w)
    s32, d32 = fanout_reduce(wide, _t(neigh), w)
    assert torch.equal(s16, s32) and torch.equal(d16, d32)
    jblk = JBlock(neigh=jnp.asarray(neigh), num_dst=jnp.int32(d),
                  num_src=jnp.int32(n))
    js, _ = jreduce(jnp.asarray(wide.numpy()), jblk, jnp.asarray(w.numpy()))
    np.testing.assert_allclose(s16.numpy(), np.asarray(js), **TOL_AGG)
    for a, b in zip(prefix_masked_mean(half, _t(neigh)),
                    prefix_masked_mean(wide, _t(neigh))):
        assert torch.equal(a.float(), b)
    el = _t(rng.standard_normal((d, 2)).astype(np.float32))
    for mode, proj in ((SHARED, rng.standard_normal((f, 2))),
                       (PER_HEAD, rng.standard_normal((2, f // 2)))):
        proj = _t((0.2 * proj).astype(np.float32))
        got = attend_forward(half, _t(neigh), el, proj, mode)
        want = attend_forward(wide, _t(neigh), el, proj, mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        g = _t(rng.standard_normal(got[0].shape).astype(np.float32))
        back = attend_backward(g, half, _t(neigh), el, proj, *got[1:], mode,
                               False)
        back32 = attend_backward(g, wide, _t(neigh), el, proj, *got[1:],
                                 mode, False)
        assert back[0] is None
        assert all(torch.equal(a, b) for a, b in zip(back[1:], back32[1:]))
        with pytest.raises(NotImplementedError, match="float16"):
            attend_backward(g, half, _t(neigh), el, proj, *got[1:], mode,
                            True)
    wl, wr = (_t((0.2 * rng.standard_normal((f, 2))).astype(np.float32))
              for _ in range(2))
    assert torch.equal(gat_attend_prefix(half, _t(neigh), wl, wr),
                       gat_attend_prefix(wide, _t(neigh), wl, wr))


@pytest.mark.parametrize("conv", ["graphsage", "gcn", "gat", "pinsage",
                                  "mlp"])
def test_model_over_f16_equals_the_widened_table(conv):
    """The GNN over a float16 input at float32 compute keeps it whole and
    gives the logits and every gradient of the same GNN over the widened
    input, bit for bit (local-id and direct-extract blocks); at bfloat16
    compute it rounds the input to bfloat16, as JAX's ``astype`` does."""
    from test_torch_port_options import _local_blocks

    from xgnn_tpu_torch.models.gnn import GNN

    rng = np.random.default_rng(len(conv))
    _, blocks = _local_blocks(rng, conv == "pinsage")
    x = torch.from_numpy(rng.standard_normal((64, 12)).astype(np.float16))
    g = _t(rng.standard_normal((16, 5)).astype(np.float32))
    outs = []
    for inp, dtype in ((x, torch.float32), (x.float(), torch.float32),
                       (x, torch.bfloat16), (x.to(torch.bfloat16),
                                             torch.bfloat16)):
        torch.manual_seed(0)
        model = GNN(12, 16, 5, 2, dropout=0.0, conv=conv, num_heads=2,
                    compute_dtype=dtype)
        model.reset_parameters(torch.Generator().manual_seed(3))
        out = model(blocks, inp, train=True)
        torch.sum(out * g).backward()
        outs.append([out.detach()] + [p.grad for p in model.parameters()])
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
    for a, b in zip(outs[2], outs[3]):
        assert torch.equal(a, b)


# ------------------------------------------------------- training on F16
@pytest.fixture(scope="module")
def f16_dirs(tmp_path_factory):
    """``learn_ds``'s graph written twice by the port: an F16 directory
    and an F32 one holding the same (float16) values, with a ``degree``
    ranking file."""
    ds = _toy()
    ds.feat = ds.feat.astype(np.float16).astype(np.float32)
    deg = np.diff(ds.indptr)
    ds.cache_rankings["degree"] = np.argsort(-deg, kind="stable").astype(
        np.int32)
    root = tmp_path_factory.mktemp("f16")
    wide, half = str(root / "f32"), str(root / "f16")
    pdataset.save_dataset(ds, wide)
    pdataset.save_dataset(ds, half)
    _to_f16(half)
    return half, wide


_F16_CASES = {
    "graphsage": dict(),
    "gcn": dict(model="gcn"),
    "gat2": dict(model="gat", num_head=2),
    "pinsage": dict(model="pinsage", sample_type="random_walk"),
    "sage-bf16-compute": dict(compute_dtype="bfloat16"),
    "gat-bf16-compute": dict(model="gat", compute_dtype="bfloat16"),
    "sage-cached": dict(cache_percentage=0.2, cache_policy="degree"),
    "sage-bf16-feat-cached": dict(cache_percentage=0.2,
                                  cache_policy="degree",
                                  feat_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(_F16_CASES))
def test_engine_over_f16_equals_the_widened_directory(f16_dirs, case):
    """An epoch of the port's ``Engine`` (dropout 0.5) over the F16
    directory: its per-step losses equal those over the F32 directory of
    the same values bit for bit, and its tables are the F16 file's
    (float16, or bfloat16 under a bfloat16 option)."""
    from xgnn_tpu_torch import Engine, RunConfig, load_dataset

    half, wide = f16_dirs
    kw = _F16_CASES[case]
    common = dict(batch_size=128, fanout=(5, 4), num_layer=2, num_hidden=16,
                  lr=0.01, dropout=0.5, calibration_batches=1,
                  pipeline=False, **kw)
    hist = []
    for path in (half, wide):
        eng = Engine(load_dataset(path), RunConfig(**common),
                     device="cpu").init()
        eng.train_epoch(0)
        hist.append(eng.history[0]["loss"])
        src = eng.feature_source
        table = src.cache_feat if hasattr(src, "cache_feat") else src.feat
        bf16 = "bfloat16" in (kw.get("feat_dtype"), kw.get("compute_dtype"))
        if path == half:
            assert table.dtype == (torch.bfloat16 if bf16 else torch.float16)
    assert np.isfinite(hist[0]).all()
    np.testing.assert_array_equal(hist[0], hist[1])


@pytest.mark.parametrize("case", ["graphsage", "gcn", "gat2",
                                  "sage-bf16-compute", "gat-bf16-compute",
                                  "sage-cached"])
def test_f16_trajectory_matches_jax_engine(f16_dirs, case, monkeypatch):
    """Six steps over the F16 directory, the JAX Engine against the port's
    at dropout 0 with flax's initial weights: per-step losses within
    1e-4.  JAX's GAT takes its aggregate-first form (XGNN_GAT_ACC_LIMIT),
    the port's one form."""
    monkeypatch.setenv("XGNN_GAT_ACC_LIMIT", str(2**40))
    common = dict(fanout=(5, 4), num_layer=2, num_hidden=16, dropout=0.0,
                  lr=0.01, pipeline=False, sample_type="khop3",
                  cache_percentage=0.0, batch_size=42, model="graphsage")
    common.update(_F16_CASES[case])
    jl, pl, eng = _file_trajectory(f16_dirs[0], common, monkeypatch)
    assert len(pl) == 6 and np.isfinite(jl).all()
    np.testing.assert_allclose(pl, jl, **TOL_STEPS)


def test_f16_pinsage_trajectory_matches_jax_engine(f16_dirs):
    """PinSAGE over the F16 directory's table (as JAX loads it): six
    steps of the JAX Engine against the port's sampler, store and model at
    dropout 0, the walks fed JAX's uniforms; per-step losses within 1e-4,
    the float16 tables equal."""
    from test_torch_port_options import _BASE, _trajectory

    from xgnn_tpu import load_dataset as jload

    ds = jload(f16_dirs[0])
    assert np.asarray(ds.feat).dtype == np.float16
    common = dict(_BASE, model="pinsage", sample_type="random_walk",
                  batch_size=len(ds.train_set) // 21)
    jl, pl = _trajectory(ds, common)
    assert len(pl) == 6 and np.isfinite(jl).all()
    np.testing.assert_allclose(pl, jl, **TOL_STEPS)


# ------------------------------------------------ the tiered store on F16
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_tiered_store_over_f16_matches_jax(dtype):
    """The tiered store over a float16 host table against JAX's
    ``TieredFeatureSource`` (its dynamic bucket) with the same ranking:
    the cache's type, the extracted rows bit for bit, the hit and miss
    counts, and ``miss_bytes`` at the host's 2 bytes a value."""
    from xgnn_tpu.store.feature_store import TieredFeatureSource as JTiered
    from xgnn_tpu_torch.store import TieredFeatureSource

    rng = np.random.default_rng(7)
    num_node, width, n = 2000, 24, 900
    feat = rng.standard_normal((num_node, width)).astype(np.float16)
    ranking = rng.permutation(num_node).astype(np.int32)
    jdt = jnp.bfloat16 if dtype else None
    tdt = torch.bfloat16 if dtype else None
    jsrc = JTiered(feat, ranking, 0.2, dtype=jdt)
    src = TieredFeatureSource(feat, ranking, 0.2, "cpu", tdt)
    assert src.feat_host.dtype == torch.float16
    assert src.cache_feat.dtype == (tdt or torch.float16)
    assert src.row_bytes == 2 * width
    ids = rng.integers(0, num_node, n).astype(np.int32)
    ids[rng.random(n) < 0.2] = EMPTY_KEY
    num = 800
    want, jinfo = jsrc.extract(jnp.asarray(ids), jnp.int32(num))
    got, info = src.extract(_t(ids), num)
    assert got.dtype == (tdt or torch.float16)
    want = np.asarray(want)[:num].view(np.uint16)
    np.testing.assert_array_equal(
        got[:num].contiguous().view(torch.int16).numpy().view(np.uint16),
        want)
    num_hit, num_miss = int(info["num_hit"]), int(info["num_miss"])
    assert num_hit / (num_hit + num_miss) == jinfo["hit_rate"]
    assert int(info["miss_bytes"]) == jinfo["miss_bytes"]
    assert int(info["miss_bytes"]) == num_miss * width * 2


@pytest.mark.parametrize("model", ["graphsage", "gat"])
def test_device_loop_over_f16_equals_the_host_loop(f16_dirs, model):
    """``device_loop`` runs over the F16 directory's float16 table where it
    runs over float32 (the whole table on the device): two epochs at
    dropout 0.5, every step's loss and accuracy equal to the host loop's
    within 1e-5, as tests/test_torch_port_tooling.py holds the float32
    paths."""
    from xgnn_tpu_torch import Engine, RunConfig, load_dataset

    hist = []
    for device_loop in (False, True):
        cfg = RunConfig(batch_size=128, fanout=(5, 4), num_layer=2,
                        num_hidden=16, model=model, dropout=0.5,
                        calibration_batches=1, device_loop=device_loop)
        eng = Engine(load_dataset(f16_dirs[0]), cfg, device="cpu").init()
        assert eng.feature_source.feat.dtype == torch.float16
        for epoch in range(2):
            eng.train_epoch(epoch)
        assert (eng._fused is not None) == device_loop
        hist.append([eng.history[e] for e in range(2)])
    for host, fused in zip(*hist):
        assert np.all(np.isfinite(host["loss"]))
        np.testing.assert_allclose(fused["loss"], host["loss"], rtol=1e-5)
        np.testing.assert_allclose(fused["acc"], host["acc"], rtol=1e-5)
