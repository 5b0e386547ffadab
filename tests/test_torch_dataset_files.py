"""Dataset directories and the host test graphs of the port against the
JAX package, on the CPU.

A directory written by either package loads in both with equal arrays and
dtypes (every optional table, the five ranking files, an F16 table,
``fake_feat_dim``), with the same refusals; ``xgnn-convert``'s tables,
from the binary that the port's ``clib.convert_path()`` builds, load equal
in both; the loader's big offsets reach the tiered topology alone.
``make_synthetic_dataset`` and ``plant_hop2_task`` are bit-equal to
JAX's, and the device build with ``dedup`` equals JAX's ``_build_csr``.
Six steps of the port's ``Engine`` over a loaded directory hold to the JAX
``Engine`` over the same directory (graphsage; a cache of the file's
degree ranking; ``weighted_khop`` from the file's alias tables; the tiered
topology at 0.85), the hop2 task separates graphsage from the MLP on the
port's engine, and the two command lines train and evaluate from a
directory and build the JAX command line's ``--synthetic`` graph.  Training
and inference over an F16 directory are ``tests/test_torch_f16_files.py``'s.
"""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from xgnn_tpu import constants as JC  # noqa: E402
from xgnn_tpu import dataset as jdataset  # noqa: E402
from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.parallel import ggms  # noqa: E402

from test_big_offsets import GIANT_ROW, big_ds  # noqa: E402,F401
from test_torch_port_slice import (  # noqa: E402
    _assert_same_batch,
    _layer_uniforms,
    _t,
)

from xgnn_tpu_torch import constants as C  # noqa: E402
from xgnn_tpu_torch import dataset as pdataset  # noqa: E402
from xgnn_tpu_torch import synthetic as psyn  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EMPTY = C.EMPTY_KEY
TOL_STEPS = dict(rtol=1e-4, atol=1e-4)  # a few steps of float32 training
FIELDS = ("indptr", "indices", "feat", "label", "train_set", "valid_set",
          "test_set", "prob_table", "alias_table", "prob_prefix_table",
          "in_degrees", "out_degrees")
POLICIES = ("degree", "heuristic", "degree_hop", "fake_optimal", "random")


def _toy(seed=2, **kw):
    """The port's copy of ``tests/conftest.py``'s ``learn_ds``."""
    args = dict(num_node=3000, avg_degree=8, feat_dim=32, num_class=6,
                seed=seed, planted_signal=2.0, train_frac=0.3)
    return psyn.make_synthetic_dataset(**dict(args, **kw))


def _assert_same_dataset(a, b, fields=FIELDS):
    """Equal scalars, and every array equal in value and dtype."""
    for name in ("num_node", "num_edge", "feat_dim", "num_class"):
        assert getattr(a, name) == getattr(b, name), name
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.asarray(x).dtype == np.asarray(y).dtype, name
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)
    assert sorted(a.cache_rankings) == sorted(b.cache_rankings)
    for policy in a.cache_rankings:
        x, y = a.cache_rankings[policy], b.cache_rankings[policy]
        assert x.dtype == y.dtype == np.int32, policy
        np.testing.assert_array_equal(x, y, err_msg=policy)


def _full_dataset():
    """A toy dataset with every optional table: the alias and prefix
    tables and a ranking for each of the five policies."""
    ds = _toy(seed=5, num_node=600, avg_degree=5)
    psyn.build_alias_tables(ds, seed=1)
    rng = np.random.default_rng(9)
    for policy in POLICIES:
        ds.cache_rankings[policy] = rng.permutation(ds.num_node).astype(
            np.int32)
    return ds


def _write_degrees(ds, path):
    """The degree files as ``xgnn-convert degrees`` lays them out."""
    deg = np.diff(ds.indptr).astype(np.uint32)
    deg.tofile(os.path.join(path, C.OUT_DEGREE_FILE))
    np.bincount(ds.indices, minlength=ds.num_node).astype(np.uint32).tofile(
        os.path.join(path, C.IN_DEGREE_FILE))


def _to_f16(path):
    """Rewrite a directory's features as an F16 file."""
    feat = np.fromfile(os.path.join(path, C.FEAT_FILE), np.float32)
    feat.astype(np.float16).tofile(os.path.join(path, C.FEAT_FILE))
    meta = Path(path, C.META_FILE)
    meta.write_text(meta.read_text().replace(
        f"{C.META_FEAT_DATA_TYPE} F32", f"{C.META_FEAT_DATA_TYPE} F16"))


# ------------------------------------------------------------ file interop
def test_file_names_and_meta_keys_are_jax_s():
    for name in dir(JC):
        if name.endswith("_FILE") or name.startswith("META_"):
            assert getattr(C, name) == getattr(JC, name), name


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_directory_loads_equal_in_both_packages(tmp_path, writer):
    """Written by either package (the same bytes), loaded by both: every
    field equal in value and dtype, each equal to what was written."""
    ds = _full_dataset()
    path = str(tmp_path / "ds")
    save = pdataset.save_dataset if writer == "port" else \
        jdataset.save_dataset
    save(ds, path)
    other = str(tmp_path / "other")
    (jdataset.save_dataset if writer == "port" else pdataset.save_dataset)(
        ds, other)
    for f in sorted(os.listdir(path)):
        assert Path(path, f).read_bytes() == Path(other, f).read_bytes(), f
    assert sorted(os.listdir(path)) == sorted(os.listdir(other))
    _write_degrees(ds, path)
    jds, pds = jdataset.load_dataset(path), pdataset.load_dataset(path)
    _assert_same_dataset(pds, jds)
    assert pds.name == jds.name == "ds"
    assert isinstance(pds.indices, np.memmap) and not pds.feat.flags.writeable
    assert pds.indptr.dtype == np.int32 and pds.label.dtype == np.int64
    _assert_same_dataset(pds, ds, ("indptr", "indices", "feat", "label",
                                   "train_set", "valid_set", "test_set",
                                   "prob_table", "alias_table",
                                   "prob_prefix_table"))
    np.testing.assert_array_equal(pds.out_degrees, pds.degrees)
    pds.validate()


def test_f16_features_and_fake_feat_dim_load_as_jax_s(tmp_path):
    ds = _toy(seed=4, num_node=500, avg_degree=4)
    path = str(tmp_path / "ds")
    pdataset.save_dataset(ds, path)
    fake = [m.load_dataset(path, fake_feat_dim=7) for m in (jdataset,
                                                            pdataset)]
    assert fake[1].feat.shape == (ds.num_node, 7) and fake[1].feat_dim == 7
    _assert_same_dataset(fake[1], fake[0])
    no_feat = pdataset.load_dataset(path, load_feat=False)
    assert no_feat.feat is None
    _to_f16(path)
    jds, pds = jdataset.load_dataset(path), pdataset.load_dataset(path)
    assert pds.feat.dtype == np.float16
    _assert_same_dataset(pds, jds)
    np.testing.assert_array_equal(pds.feat, ds.feat.astype(np.float16))


def _meta_without(key):
    def edit(path):
        meta = Path(path, C.META_FILE)
        meta.write_text("".join(line for line in meta.read_text()
                                .splitlines(True)
                                if not line.startswith(key + " ")))
    return edit


def _meta_set(key, value):
    def edit(path):
        meta = Path(path, C.META_FILE)
        meta.write_text(re.sub(rf"^{key} .*$", f"{key} {value}",
                               meta.read_text(), flags=re.M))
    return edit


@pytest.mark.parametrize("edit", [
    _meta_without(C.META_NUM_CLASS),
    _meta_without(C.META_NUM_TEST_SET),
    _meta_set(C.META_NUM_NODE, 2**31 - 1),
    _meta_set(C.META_NUM_EDGE, 2**32),
    _meta_set(C.META_NUM_EDGE, 123),  # indptr inconsistent with meta.txt
    _meta_set(C.META_FEAT_DATA_TYPE, "F64"),
    lambda path: os.unlink(os.path.join(path, C.META_FILE)),
    lambda path: os.unlink(os.path.join(path, C.TRAIN_SET_FILE)),
], ids=["no-num-class", "no-num-test-set", "num-node", "num-edge-2^32",
        "inconsistent-indptr", "feat-type", "no-meta", "no-train-set"])
def test_refusals_raise_as_jax_s(tmp_path, edit):
    path = str(tmp_path / "ds")
    pdataset.save_dataset(_toy(seed=3, num_node=300, avg_degree=3), path)
    edit(path)
    with pytest.raises(Exception) as jerr:
        jdataset.load_dataset(path)
    with pytest.raises(type(jerr.value)) as perr:
        pdataset.load_dataset(path)
    assert type(perr.value) is type(jerr.value)
    if isinstance(jerr.value, ValueError):
        assert str(perr.value) == str(jerr.value)


def test_save_refuses_2_32_edges_as_jax_s(tmp_path):
    ds = dataclasses.replace(_toy(seed=3, num_node=300, avg_degree=3),
                             num_edge=2**32)
    for m in (jdataset, pdataset):
        with pytest.raises(ValueError, match="uint32 offset space"):
            m.save_dataset(ds, str(tmp_path / m.__name__))


# ------------------------------------------------------- xgnn-convert's tables
@pytest.fixture(scope="module")
def convert_exe():
    """``xgnn-convert`` built by the port (skips only where there is no
    compiler, as the JAX package's fixture does)."""
    from xgnn_tpu_torch import clib

    exe = clib.convert_path()
    if exe is None:
        pytest.skip("no C++ compiler available to build xgnn-convert")
    return exe


def test_convert_path_builds_into_the_port_s_build_directory(convert_exe):
    from xgnn_tpu_torch import clib
    from xgnn_tpu_torch.ops._build import BUILD_DIR

    assert Path(convert_exe).parent == BUILD_DIR
    assert os.access(convert_exe, os.X_OK)
    assert clib.convert_path() == convert_exe  # built once
    assert not list(BUILD_DIR.glob(".xgnn-convert*.tmp"))


def test_convert_builds_serially_without_openmp(tmp_path, monkeypatch,
                                                 convert_exe):
    """A compiler that refuses the OpenMP flag (one without OpenMP's
    runtime) builds the serial tool, whose tables equal the OpenMP
    build's byte for byte."""
    from xgnn_tpu_torch import clib

    monkeypatch.setattr(clib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(clib, "OPENMP_FLAGS", ["-fno-such-openmp-flag"])
    serial = clib.convert_path()
    assert Path(serial) == clib._binary(clib.CXX_FLAGS)
    assert not list((tmp_path / "build").glob(".*.tmp"))
    ds = _toy(seed=8, num_node=700, avg_degree=5)
    outs = []
    for exe in (convert_exe, serial):
        path = str(tmp_path / Path(exe).name)
        pdataset.save_dataset(ds, path)
        for cmd in ("create-weights", "cache-by-heuristic",
                    "cache-by-degree-hop"):
            r = subprocess.run([exe, cmd, path], capture_output=True,
                               text=True, timeout=120)
            assert r.returncode == 0, r.stderr
        outs.append({f: Path(path, f).read_bytes() for f in (
            C.PROB_TABLE_FILE, C.ALIAS_TABLE_FILE, C.PROB_PREFIX_TABLE_FILE,
            C.CACHE_BY_HEURISTIC_FILE, C.CACHE_BY_DEGREE_HOP_FILE)})
    assert outs[0] == outs[1]


def test_convert_tables_load_equal_in_both_packages(tmp_path, convert_exe):
    """``degrees``, the four ranking commands and ``create-weights`` on a
    directory the port wrote: both packages load every table equal."""
    ds = _toy(seed=6, num_node=800, avg_degree=5)
    path = str(tmp_path / "ds")
    pdataset.save_dataset(ds, path)
    for cmd in (["degrees"], ["cache-by-degree"], ["cache-by-heuristic"],
                ["cache-by-degree-hop"], ["cache-by-random", "3"],
                ["create-weights", "7"]):
        r = subprocess.run([convert_exe, cmd[0], path] + cmd[1:],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
    jds, pds = jdataset.load_dataset(path), pdataset.load_dataset(path)
    assert sorted(pds.cache_rankings) == ["degree", "degree_hop",
                                          "heuristic", "random"]
    for name in ("prob_table", "alias_table", "prob_prefix_table",
                 "in_degrees", "out_degrees"):
        assert getattr(pds, name) is not None, name
    _assert_same_dataset(pds, jds)
    np.testing.assert_array_equal(pds.out_degrees, np.diff(ds.indptr))
    deg = np.diff(ds.indptr)
    assert np.all(np.diff(deg[pds.cache_rankings["degree"]]) <= 0)


# ------------------------------------------------------------- big offsets
def test_big_offsets_reach_only_the_tiered_topology(big_ds):  # noqa: F811
    """``test_big_offsets``' sparse 2.4B-edge directory: the port's loader
    keeps a uint32 ``indptr``, ``Graph.from_dataset`` refuses it, and
    ``make_tiered_topology`` takes it with JAX's int32 clamp."""
    from xgnn_tpu.parallel.ggms import clamp_num_cache_node_int32 as jclamp
    from xgnn_tpu.parallel.ggms import compute_num_cache_node as jcompute
    from xgnn_tpu_torch.config import SampleType
    from xgnn_tpu_torch.sampler import make_tiered_topology
    from xgnn_tpu_torch.types import Graph

    path = os.path.dirname(big_ds.indptr.filename)
    pds = pdataset.load_dataset(path, load_feat=False)
    assert pds.indptr.dtype == np.uint32 and pds.indices.dtype == np.int32
    assert int(pds.indptr[-1]) == pds.num_edge > 2**31
    _assert_same_dataset(pds, big_ds, ("indptr", "train_set"))
    with pytest.raises(ValueError, match="2\\^31"):
        Graph.from_dataset(pds, "cpu")
    for pct in (1.0, 0.99, 0.5):
        hot, tier, n = make_tiered_topology(pds.indptr, pds.indices, pct,
                                            SampleType.KHOP3, device="cpu")
        want = jclamp(big_ds.indptr, jcompute(big_ds.indptr, pct), 1)
        assert tier.num_cache_node == hot.num_node == want and n == 64
        assert hot.indptr.dtype == torch.int32
        host = tier.csr.host("indptr")
        assert host.dtype == torch.int64
        np.testing.assert_array_equal(host.numpy(),
                                      big_ds.indptr.astype(np.int64))
        if pct == 1.0:  # the prefix stops before the giant row
            assert want == GIANT_ROW


# ------------------------------------------------------- host test graphs
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("signal", [0.0, 1.5])
@pytest.mark.parametrize("power_law", [True, "rmat", False])
def test_host_graphs_are_bit_equal_to_jax_s(seed, signal, power_law):
    args = dict(num_node=1500, avg_degree=6, feat_dim=16, num_class=5,
                seed=seed, planted_signal=signal, power_law=power_law)
    jds, pds = jsyn.make_synthetic_dataset(**args), \
        psyn.make_synthetic_dataset(**args)
    fields = ("indptr", "indices", "feat", "label", "train_set",
              "valid_set", "test_set")
    _assert_same_dataset(pds, jds, fields)
    assert type(pds).__module__ == "xgnn_tpu_torch.dataset"
    _assert_same_dataset(psyn.plant_hop2_task(pds, seed=seed + 4),
                         jsyn.plant_hop2_task(jds, seed=seed + 4), fields)


@pytest.mark.parametrize("power_law", [True, "rmat"])
def test_edge_generators_are_bit_equal_to_jax_s(power_law):
    fn = "powerlaw_edges" if power_law is True else "rmat_edges"
    for a, b in zip(getattr(psyn, fn)(700, 5000, seed=3),
                    getattr(jsyn, fn)(700, 5000, seed=3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    src = np.array([3, 1, 3, 0, 1], np.int64)
    dst = np.array([1, 3, 1, 2, 0], np.int64)
    for a, b in zip(psyn._coo_to_csr(src, dst, 4),
                    jsyn._coo_to_csr(src, dst, 4)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("seed,num_node,num_draws", [(0, 300, 5000),
                                                     (1, 50, 4000),
                                                     (2, 1000, 600)])
def test_build_csr_matches_jax_s(seed, num_node, num_draws):
    """The port's ``_build_csr`` against JAX's on the same pairs (repeats
    and loops among them): equal ``indptr``, and ``indices`` equal to JAX's
    trimmed to its ``num_unique``."""
    import jax.numpy as jnp
    from xgnn_tpu.synthetic_device import _build_csr as jbuild
    from xgnn_tpu_torch.synthetic_device import _build_csr

    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_node, num_draws).astype(np.int32)
    dst = rng.integers(0, num_node, num_draws).astype(np.int32)
    dst[::7] = src[::7]  # loops
    jip, jix, nu = jbuild(jnp.asarray(src), jnp.asarray(dst), num_node)
    ip, ix = _build_csr(_t(src), _t(dst), num_node)
    assert ip.dtype == ix.dtype == torch.int32
    assert ix.shape[0] == int(nu)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(jip))
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jix)[:int(nu)])


def test_device_dataset_dedup_holds_the_csr_invariants():
    """``tests/test_synthetic_device.py``'s invariants on the port's
    default build (simple, symmetric, loop-free), and the features, labels
    and split of ``dedup=False``."""
    from xgnn_tpu_torch import make_device_dataset

    ds = make_device_dataset(400, 2400, 8, 4, seed=3, device="cpu")
    ip, ind = ds.graph.indptr.numpy(), ds.graph.indices.numpy()
    assert ip[0] == 0 and ip[-1] == len(ind) == ds.num_edge
    edges = set()
    for v in range(ds.num_node):
        ns = ind[ip[v]:ip[v + 1]]
        assert v not in ns
        assert np.all(np.diff(ns) > 0)
        edges.update((v, int(u)) for u in ns)
    assert all((u, v) in edges for (v, u) in edges)
    assert len(ds.train_set) > 0 and ds.feat.shape == (400, 8)
    multi = make_device_dataset(400, 2400, 8, 4, seed=3, device="cpu",
                                dedup=False)
    assert multi.num_edge > ds.num_edge
    for name in ("feat", "label"):
        assert torch.equal(getattr(ds, name), getattr(multi, name))
    for name in ("train_set", "valid_set", "test_set"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(multi, name))
    # each distinct non-loop pair of the dedup=False graph, once
    mip, mind = multi.graph.indptr.numpy(), multi.graph.indices.numpy()
    pairs = {(v, int(u)) for v in range(400) for u in mind[mip[v]:mip[v + 1]]}
    assert pairs == edges


# ----------------------------------------- trajectories from a directory
@pytest.fixture(scope="module")
def toy_dir(tmp_path_factory):
    """``learn_ds``'s graph written by the port, with the alias and prefix
    tables and a ``degree`` ranking (plain descending degree, ties by id:
    not the order that ``build_ranking`` computes)."""
    ds = _toy()
    psyn.build_alias_tables(ds, seed=3)
    deg = np.diff(ds.indptr)
    ds.cache_rankings["degree"] = np.argsort(-deg, kind="stable").astype(
        np.int32)
    path = str(tmp_path_factory.mktemp("toy") / "toy")
    pdataset.save_dataset(ds, path)
    return path


class _ColdRecorder:
    """JAX's ``HostColdSampler`` calls of a step, each with the
    ``_hash_u01`` draws it made, in order."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig_call = ggms.HostColdSampler.__call__
        rec = self

        def call(sampler, ids, keydata, fanout):
            draws = []
            orig = ggms._hash_u01

            def record(x, salt):
                out = orig(x, salt)
                draws.append(out)
                return out

            ggms._hash_u01 = record
            try:
                out = orig_call(sampler, ids, keydata, fanout)
            finally:
                ggms._hash_u01 = orig
            rec.calls.append((np.array(ids), draws))
            return out

        monkeypatch.setattr(ggms.HostColdSampler, "__call__", call)


def _tiered_uniforms(sampler, seeds, n, us, calls):
    """The hot rows' uniforms ``us`` with each layer's cold rows given the
    draws that JAX's host sampler made for them: layer ``l``'s frontier is
    the port's sample of the ``l`` layers before it."""
    from xgnn_tpu_torch.sampler import _sample_minibatch

    ncn, cfg = sampler.tier.num_cache_node, sampler.config
    assert len(calls) == len(us)
    us = [u.clone() for u in us]
    for layer, (ids, draws) in enumerate(calls):
        if layer == 0:
            frontier = _t(seeds)
        else:
            frontier = _sample_minibatch(
                sampler.graph, _t(seeds), n, sample_type=cfg.sample_type,
                fanouts=sampler.fanouts[:layer],
                capacities=tuple(sampler.capacities[:layer + 1]),
                rw_params=(0, 0, 0.0), u=us, tier=sampler.tier,
                num_node=sampler.num_node).input_nodes
        cold = (frontier != EMPTY) & (frontier >= ncn)
        num_cold = int(cold.sum())
        np.testing.assert_array_equal(ids[:num_cold], frontier[cold].numpy())
        assert (ids[num_cold:] == EMPTY).all()
        if num_cold:
            us[layer][cold] = torch.from_numpy(draws[0].astype(np.float32))
    return us


def _file_trajectory(path, common, monkeypatch, steps=6):
    """``steps`` steps of the JAX Engine over ``load_dataset(path)`` of the
    JAX package against the port's ``Engine`` over the port's
    ``load_dataset(path)`` (flax's initial weights; the engine's sampler
    fed the JAX sampler's uniforms, on the tiered topology the host
    sampler's draws for the cold rows): blocks and extracted rows equal
    every step, the per-step losses returned as ``(jax, port)``."""
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu import load_dataset as jload
    from xgnn_tpu.engine import Engine as JEngine
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler
    from xgnn_tpu_torch import Engine, RunConfig, load_dataset
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.train import train_step

    recorder = _ColdRecorder(monkeypatch)
    jeng = JEngine(jload(path), JConfig(**common, num_epoch=1)).init()
    params_np = jax.tree.map(np.asarray, jeng.state.params)
    cfg = RunConfig(**common, frontier_capacities=jeng.sampler.capacities)
    eng = Engine(load_dataset(path), cfg, device="cpu").init()
    eng.model.load_state_dict(params_from_flax(params_np))
    assert eng._direct == jeng._direct
    weighted = cfg.sample_type.value == "weighted_khop"
    shuffler = JShuffler(jeng.ds.train_set, cfg.batch_size,
                         seed=cfg.seed + 1)
    sample_base = jax.random.fold_in(jeng._sample_key, 0)
    drop_base = jax.random.fold_in(jeng._dropout_key, 0)
    state = jeng.state
    jax_losses, port_losses = [], []
    for step, (seeds, n) in enumerate(shuffler.epoch_batches(0)):
        if step >= steps:
            break
        key = jax.random.fold_in(sample_base, step)
        recorder.calls.clear()
        batch, x, labels, _, _ = jeng._produce(((seeds, n), key, (0, step)))
        state, metrics = jeng._train_step(
            state, batch.blocks, x, labels, batch.num_output,
            jax.random.fold_in(drop_base, step), batch.overflow)
        jax_losses.append(float(metrics["loss"]))

        lens = [len(seeds)] + eng.sampler.capacities[1:-1]
        if weighted:  # the alias draw's slot and coin
            us, k = [], key
            for b, fan in zip(lens, eng.sampler.fanouts):
                k, sub = jax.random.split(k)
                k_slot, k_coin = jax.random.split(sub)
                us.append((_t(jax.random.uniform(k_slot, (b, fan))),
                           _t(jax.random.uniform(k_coin, (b, fan)))))
        else:
            us = _layer_uniforms(key, lens, eng.sampler.fanouts)
        if eng._tier is not None:
            us = _tiered_uniforms(eng.sampler, seeds, n, us, recorder.calls)
        pbatch = eng.sampler.sample(_t(seeds), n, u=us)
        _assert_same_batch(pbatch, batch)
        px, plabels, _ = eng._extract(pbatch)
        if not eng._direct:
            num = int(pbatch.num_input)
            np.testing.assert_array_equal(px[:num].numpy(),
                                          np.asarray(x)[:num])
        m = train_step(eng.model, eng.opt, pbatch.blocks, px, plabels,
                       pbatch.num_output, None, pbatch.overflow)
        port_losses.append(float(m["loss"]))
    return np.asarray(jax_losses), np.asarray(port_losses), eng


@pytest.mark.parametrize("case", [
    dict(),
    dict(cache_percentage=0.2, cache_policy="degree"),
    dict(sample_type="weighted_khop"),
    dict(use_dist_graph=True, dist_graph_percentage=0.85),
], ids=["graphsage", "cached-degree-file", "weighted_khop-file-tables",
        "tiered-0.85"])
def test_file_trajectory_matches_jax_engine(toy_dir, case, monkeypatch):
    """Six steps from the files, the JAX Engine against the port's at
    dropout 0 with flax's initial weights: per-step losses within 1e-4."""
    common = dict(fanout=(5, 4), num_layer=2, num_hidden=16, dropout=0.0,
                  lr=0.01, pipeline=False, sample_type="khop3",
                  cache_percentage=0.0, batch_size=42, model="graphsage")
    common.update(case)
    jl, pl, eng = _file_trajectory(toy_dir, common, monkeypatch)
    assert len(pl) == 6 and np.isfinite(jl).all()
    np.testing.assert_allclose(pl, jl, **TOL_STEPS)
    if "cache_policy" in case:
        # the cache holds the file's ranking's prefix
        ranking = eng.ds.cache_rankings["degree"]
        k = eng.feature_source.num_cache
        np.testing.assert_array_equal(
            eng.feature_source.posmap[torch.from_numpy(
                np.array(ranking[:k])).long()].numpy(), np.arange(k))
    if "sample_type" in case:
        np.testing.assert_array_equal(eng.graph.alias_table.numpy(),
                                      eng.ds.alias_table)
    if "use_dist_graph" in case:
        assert 0 < eng._tier.num_cache_node < eng.ds.num_node


def test_engine_reads_the_maps_without_a_copy_warning(toy_dir):
    """An engine over the read-only maps (the whole table, the tiered store
    and topology, full-graph accuracy) raises no warning about them."""
    code = (
        "import sys, warnings\n"
        "warnings.simplefilter('error')\n"
        "from xgnn_tpu_torch import Engine, RunConfig, load_dataset\n"
        "from xgnn_tpu_torch.inference import evaluate_full\n"
        "ds = load_dataset(sys.argv[1])\n"
        "for kw in ({}, dict(cache_percentage=0.2, cache_policy='degree',\n"
        "           use_dist_graph=True, dist_graph_percentage=0.85)):\n"
        "    e = Engine(ds, RunConfig(batch_size=64, fanout=(4, 3),\n"
        "               num_layer=2, num_hidden=8, pipeline=False, **kw),\n"
        "               device='cpu').init()\n"
        "    e.train_epoch(0)\n"
        "evaluate_full(e.model, ds.indptr, ds.indices, ds.feat, ds.label,\n"
        "              ds.valid_set, device='cpu')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code, toy_dir], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"


# ------------------------------------------------- the hop2 task contract
@pytest.fixture(scope="module")
def hop2_ds():
    """``tests/test_hop2_task.py``'s dataset, built by the port."""
    ds = psyn.make_synthetic_dataset(
        num_node=20000, avg_degree=8, feat_dim=32, num_class=8, seed=3,
        planted_signal=1.0, train_frac=0.5)
    return psyn.plant_hop2_task(ds, seed=4)


def _hop2_accuracy(ds, model, num_layer=3, epochs=3):
    from xgnn_tpu_torch import Engine, RunConfig

    config = RunConfig(batch_size=512, fanout=(5,) * num_layer,
                       num_layer=num_layer, num_hidden=64, num_epoch=epochs,
                       model=model, sample_type="khop3",
                       cache_percentage=0.0, pipeline=False, lr=0.01,
                       dropout=0.1, calibration_batches=2)
    engine = Engine(ds, config, device="cpu").init()
    for e in range(epochs):
        r = engine.train_epoch(e)
    assert np.isfinite(r["loss"])
    return engine.evaluate("valid", max_batches=8)


def test_hop2_task_separates_graphsage_from_the_mlp(hop2_ds):
    """The JAX test's contract on the port's engine: graphsage beats the
    feature-only MLP by at least 10 points and stays below the label
    noise's ceiling."""
    acc_sage = _hop2_accuracy(hop2_ds, "graphsage")
    acc_mlp = _hop2_accuracy(hop2_ds, "mlp")
    assert acc_sage - acc_mlp >= 0.10, (acc_sage, acc_mlp)
    assert 0.55 < acc_sage < 0.95, acc_sage


# --------------------------------------------------------- the command lines
def test_run_config_dataset_fields_match_jax_s(capsys):
    from xgnn_tpu.config import RunConfig as JConfig
    from xgnn_tpu_torch import RunConfig

    j, p = JConfig(), RunConfig()
    assert (p.root_path, p.dataset, p.dataset_path) == (
        j.root_path, j.dataset, j.dataset_path)
    cfg = RunConfig(root_path="/data", dataset="papers100M")
    assert cfg.dataset_path == "/data/papers100M"
    assert cfg.to_dict()["dataset"] == "papers100M"
    cfg.print_run_config()
    out = capsys.readouterr().out
    assert "config:root_path=/data\n" in out
    assert "config:dataset=papers100M\n" in out


def test_the_clis_train_and_evaluate_from_a_directory(toy_dir, tmp_path,
                                                      capsys):
    from xgnn_tpu_torch.examples import accuracy, train
    from xgnn_tpu_torch.inference import evaluate_full

    root, name = os.path.split(toy_dir)
    where = ["--cpu", "--dataset", name, "--root-path", root]
    net = ["--fanout", "4", "3", "--num-hidden", "16"]
    ckpt = str(tmp_path / "ckpt")
    engine = train.main(where + net + [
        "--batch-size", "100", "--num-epoch", "2", "--report-acc", "1",
        "--checkpoint-dir", ckpt])
    out = capsys.readouterr().out
    assert f"config:dataset={name}\n" in out
    assert f"config:root_path={root}\n" in out
    for key in ("epoch_time:total", "final_train_acc", "test_acc"):
        assert re.search(rf"^test_result:{key}=[0-9.]+$", out, re.M), key
    ds = engine.ds
    assert isinstance(ds.indices, np.memmap) and ds.name == name
    accs = accuracy.main(where + net + ["--checkpoint-dir", ckpt])
    out = capsys.readouterr().out
    assert re.search(r"^test_result:full_valid_acc=[0-9.]+$", out, re.M)
    assert accs["valid"] == evaluate_full(
        engine.model, ds.indptr, ds.indices, ds.feat, ds.label,
        ds.valid_set, device="cpu")
    assert accs["valid"] > 0.5  # the planted signal is learnt


class _Captured(Exception):
    pass


def _jax_cli(monkeypatch, argv):
    """The dataset that the JAX command line (``examples/train.py``) hands
    its engine for ``argv``, or the exception it raises first."""
    import xgnn_tpu.engine

    def capture(ds, config):
        raise _Captured(ds)

    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", REPO / "examples" / "train.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.setattr(xgnn_tpu.engine, "Engine", capture)
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    try:
        cli.main()
    except _Captured as got:
        return got.args[0]
    raise AssertionError("the JAX command line built no engine")


def _port_cli(monkeypatch, argv):
    import xgnn_tpu_torch
    from xgnn_tpu_torch.examples import train

    def capture(ds, config, device=None):
        assert device == "cpu"
        raise _Captured(ds)

    monkeypatch.setattr(xgnn_tpu_torch, "Engine", capture)
    try:
        train.main(argv)
    except _Captured as got:
        return got.args[0]
    raise AssertionError("the port's command line built no engine")


@pytest.mark.parametrize("flags", [
    [], ["--synthetic-rmat"], ["--synthetic-signal", "0"],
    ["--synthetic-degree", "4", "--seed", "7"],
    ["--sample-type", "weighted_khop"],
    ["--sample-type", "weighted_khop_prefix", "--synthetic-degree", "3"],
])
def test_synthetic_flag_builds_the_jax_command_line_s_graph(monkeypatch,
                                                            flags):
    argv = ["--cpu", "--synthetic", "--synthetic-nodes", "1500"] + flags
    jds = _jax_cli(monkeypatch, argv)
    pds = _port_cli(monkeypatch, argv)
    assert (pds.feat_dim, pds.num_class) == (128, 32)
    _assert_same_dataset(pds, jds)


def test_a_missing_directory_raises_as_jax_s(monkeypatch, tmp_path):
    from xgnn_tpu_torch.examples import accuracy, train

    argv = ["--cpu", "--dataset", "nowhere", "--root-path", str(tmp_path)]
    with pytest.raises(Exception) as jerr:
        _jax_cli(monkeypatch, argv)
    assert isinstance(jerr.value, FileNotFoundError)
    with pytest.raises(FileNotFoundError):
        train.main(argv)
    with pytest.raises(FileNotFoundError):
        accuracy.main(argv + ["--checkpoint-dir", str(tmp_path / "c")])
