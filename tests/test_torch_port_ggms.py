"""XGNN's two-phase GGMS over the cards (the port's ``parallel/ggms.py``,
K11's position form and ``MultiChipEngine`` with a partial cache) against
the JAX package.

``build_cache`` against JAX's at P = 1, 2 and 4; over gloo ranks at P = 2
and 4 (one spawn a P, ``tests/torch_ggms_ranks.py``), ``cache_split``
followed by K11's reads and by the plain ``combine_miss`` against JAX's
``cache_split`` and ``combine_miss`` inside ``shard_map`` over P of the 8
CPU devices, and the presample's owner-accumulated counts against a
``bincount`` of every rank's inputs; the engine at P = 1 (a world of one in
this process) and P = 2 against its fused store with the same seeds; the
command line at P = 2.  Every spawn of ranks joins them under its own time
limit and fails if one hangs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.constants import EMPTY_KEY as EMPTY  # noqa: E402
from xgnn_tpu.parallel import ggms as jggms  # noqa: E402
from xgnn_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402

import torch_ggms_ranks as ranks  # noqa: E402
from xgnn_tpu_torch.ops.tiered import MappedHostTable  # noqa: E402
from xgnn_tpu_torch.parallel import ggms  # noqa: E402
from xgnn_tpu_torch.parallel import mesh as pmesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_S = 150  # each spawn's time limit
PCT = 0.3
LOSS_TOL = 1e-6


@pytest.fixture(scope="module")
def graph():
    return jsyn.make_synthetic_dataset(num_node=600, avg_degree=6,
                                       feat_dim=12, num_class=5, seed=4,
                                       planted_signal=2.0, train_frac=0.4)


def _host_tables(ds):
    """The host tables by name: float32, and float16 (an F16 file)."""
    feat = np.asarray(ds.feat, np.float32)
    return {"float32": feat, "float16": feat.astype(np.float16)}


def _bits(a):
    """A JAX array as numpy, 2-byte floats as their uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype in (np.float16,
                                            ml_dtypes.bfloat16) else a


# ------------------------------------------------------------- build_cache
@pytest.mark.parametrize("num_parts", [1, 2, 4])
@pytest.mark.parametrize("part_cache", [True, False])
@pytest.mark.parametrize("pct", [0.05, 0.3, 0.99])
def test_build_cache_matches_jax(graph, num_parts, part_cache, pct):
    """The posmap, each rank's rows of the interleaved cache (the whole
    cache on every rank when replicated) and the cache size, exactly."""
    rng = np.random.default_rng(int(pct * 100) + num_parts)
    feat = _host_tables(graph)["float32"]
    ranking = rng.permutation(graph.num_node).astype(np.int32)
    parts = num_parts if part_cache else 1
    jposmap, jparts, jnum = jggms.build_cache(feat, ranking, pct, parts)
    host = MappedHostTable(feat, "cpu")
    for r in range(num_parts):
        posmap, part, num = ggms.build_cache(
            host, ranking, pct, parts, r if part_cache else 0, "cpu")
        assert num == jnum
        np.testing.assert_array_equal(posmap.numpy(), jposmap)
        np.testing.assert_array_equal(part.numpy(),
                                      jparts[r if part_cache else 0])


@pytest.mark.parametrize("host,cache", [("float32", "bfloat16"),
                                        ("float16", "float16")])
def test_build_cache_two_byte_rows_match_jax(graph, host, cache):
    """A bfloat16 cache over a float32 host (JAX rounds the host table with
    ``astype`` first) and a float16 cache over an F16 host, bit for bit;
    an empty cache is JAX's ``(P, F)`` zeros."""
    feat = _host_tables(graph)[host]
    ranking = np.arange(graph.num_node, dtype=np.int32)[::-1].copy()
    jfeat = feat.astype(ml_dtypes.bfloat16) if cache == "bfloat16" else feat
    table = MappedHostTable(feat, "cpu")
    for pct in (0.3, 0.0):
        _, jparts, _ = jggms.build_cache(jfeat, ranking, pct, 2)
        for r in range(2):
            _, part, _ = ggms.build_cache(table, ranking, pct, 2, r, "cpu",
                                          ranks.DTYPES[cache])
            np.testing.assert_array_equal(ranks.bits(part), _bits(jparts[r]))


# ------------------------------------------------------- the ranks' suite
def _ids(rng, num_parts, n, num_node):
    ids = rng.integers(0, num_node, (num_parts, n)).astype(np.int32)
    ids[:, ::7] = EMPTY
    ids[:, -9:] = EMPTY
    return ids


def _engine_config(num_worker, **kw):
    cfg = dict(model="graphsage", batch_size=96, fanout=(4, 3),
               num_layer=2, num_hidden=16, lr=0.01, num_worker=num_worker,
               arch="arch6", use_dist_graph=True, part_cache=True,
               calibration_batches=2, dropout=0.5, num_epoch=2,
               cache_percentage=0.2)
    cfg.update(kw)
    return cfg


def _engine_cases(num_worker):
    """The engines each P runs: the two-phase store partitioned (XGNN) on
    the partitioned topology and replicated (SGNN) on the replicated one,
    each beside the fused store with the same seeds; dynamic_cache; a
    forced small exchange segment."""
    cases = {}
    for name, kw in (("xgnn", {}), ("sgnn", dict(part_cache=False,
                                                  use_dist_graph=False))):
        cases[name] = dict(config=_engine_config(num_worker, **kw),
                           epochs=2, recount=True, evaluate=True)
        cases[name + "_fused"] = dict(
            config=_engine_config(num_worker, cache_percentage=1.0, **kw),
            epochs=2)
    cases["dynamic"] = dict(config=_engine_config(
        num_worker, cache_policy="dynamic_cache"), epochs=1)
    cases["replay"] = dict(config=_engine_config(
        num_worker, frontier_capacities=[96, 128, 256],
        exchange_headroom=0.05, calibration_batches=0, seed=11), epochs=1,
        evaluate=True)
    return cases


def _ds_arrays(ds):
    return {k: getattr(ds, k) for k in (
        "name", "num_node", "num_edge", "feat_dim", "num_class", "indptr",
        "indices", "feat", "label", "train_set", "valid_set", "test_set")}


def _suite_data(ds, num_parts):
    rng = np.random.default_rng(num_parts)
    n = 300
    train = np.asarray(ds.train_set, np.int32)
    seeds = np.full((3, num_parts, 64), EMPTY, np.int32)
    nums = np.zeros((3, num_parts), np.int64)
    for b in range(3):
        for r in range(num_parts):
            k = 64 - 11 * ((r + b) % 3)
            seeds[b, r, :k] = rng.choice(train, k, replace=False)
            nums[b, r] = k
    data = {
        "feat": _host_tables(ds), "pct": PCT,
        "ranking": rng.permutation(ds.num_node).astype(np.int32),
        "ids": _ids(rng, num_parts, n, ds.num_node),
        "split": {
            "float32": dict(host="float32", cache="float32", seg_cap=n,
                            partitioned=True),
            "bfloat16": dict(host="float32", cache="bfloat16", seg_cap=n,
                             partitioned=True),
            "float16": dict(host="float16", cache="float16", seg_cap=n,
                            partitioned=True),
            "overflow": dict(host="float32", cache="float32", seg_cap=6,
                             partitioned=True),
            "replicated": dict(host="float32", cache="float32", seg_cap=n,
                               partitioned=False)},
        "csr": {"indptr": ds.indptr, "indices": ds.indices,
                "num_node": ds.num_node},
        "presample": {"config": dict(model="graphsage", batch_size=64,
                                     fanout=(4, 3), num_layer=2,
                                     num_worker=num_parts),
                      "caps": [64, 320, 600], "seg_cap": 200,
                      "seeds": seeds, "nums": nums}}
    if num_parts == 2:
        data["ds"] = _ds_arrays(ds)
        data["engines"] = _engine_cases(num_parts)
    return data


@pytest.fixture(scope="module", params=[2, 4], ids=lambda p: f"P{p}")
def suite(request, graph):
    p = request.param
    data = _suite_data(graph, p)
    outs = pmesh.spawn(ranks.suite, p, data, device="cpu", timeout=SPAWN_S)
    return p, data, outs


def _jax_split(data, case, p):
    """JAX's cache_split inside shard_map over P CPU devices, then its
    combine_miss over the rows gathered from the host table: each rank's
    ``(x, num_hit, num_miss, overflow)``."""
    feat = data["feat"][case["host"]]
    table = (feat.astype(ml_dtypes.bfloat16) if case["cache"] == "bfloat16"
             else feat)
    parts = p if case["partitioned"] else 1
    posmap, cache_parts, _ = jggms.build_cache(table, data["ranking"],
                                               data["pct"], parts)
    if not case["partitioned"]:
        cache_parts = np.broadcast_to(cache_parts,
                                      (p,) + cache_parts.shape[1:]).copy()
    ids = data["ids"]

    def fn(posmap, parts, ids):
        out = jggms.cache_split(posmap, parts.reshape(parts.shape[1:]),
                                ids.reshape(-1), "data", case["seg_cap"],
                                ids.shape[-1], case["partitioned"])
        return tuple(o[None] for o in out)

    outs = [np.asarray(o) for o in jax.jit(shard_map(
        fn, mesh=jax_mesh(p), in_specs=(PS(), PS("data"), PS("data")),
        out_specs=(PS("data"),) * 6))(jnp.asarray(posmap),
                                      jnp.asarray(cache_parts),
                                      jnp.asarray(ids))]
    hit_rows, miss_ids, miss_pos, num_miss, num_hit, of = outs
    result = []
    for r in range(p):
        rows = feat[np.where(miss_ids[r] == EMPTY, 0, miss_ids[r])]
        x = jggms.combine_miss(jnp.asarray(hit_rows[r]), jnp.asarray(rows),
                               jnp.asarray(miss_pos[r]),
                               jnp.int32(num_miss[r]))
        result.append((_bits(x), int(num_hit[r]), int(num_miss[r]),
                       bool(of[r])))
    return result


def test_cache_split_and_reads_match_jax(suite):
    """``cache_split`` then K11's reads, and the plain ``combine_miss``:
    ``x`` bit-equal to JAX's ``cache_split`` and ``combine_miss``, the
    counts and the overflow flag equal, for a float32 cache, a bfloat16
    cache over a float32 host, an F16 host, a small segment that makes the
    positions' exchange overflow, and the replicated (SGNN) cache."""
    p, data, outs = suite
    for name, case in data["split"].items():
        want = _jax_split(data, case, p)
        for r in range(p):
            got = outs[r]["split"][name]
            x, hits, misses, of = want[r]
            np.testing.assert_array_equal(got["x"], x, err_msg=name)
            np.testing.assert_array_equal(got["plain"], x, err_msg=name)
            assert tuple(got["counts"]) == (hits, misses), name
            assert got["overflow"] == of, name
        overflowed = [outs[r]["split"][name]["overflow"] for r in range(p)]
        assert any(overflowed) == (name == "overflow"), name


def test_presample_counts_every_input_at_its_owner(suite):
    """The owners' interleaved counts, reassembled (``full[w::P] =
    parts[w]``), equal a bincount of every rank's valid inputs; the sizes
    are the frontiers' maxima over the ranks."""
    p, data, outs = suite
    num_node = data["csr"]["num_node"]
    rows = outs[0]["presample"]["freq"].shape[0]
    full = np.zeros(rows * p, np.int64)
    for w in range(p):
        full[w::p] = outs[w]["presample"]["freq"]
    inputs = np.concatenate([i for o in outs
                             for i in o["presample"]["inputs"]])
    np.testing.assert_array_equal(full[:num_node],
                                  np.bincount(inputs, minlength=num_node))
    assert not full[num_node:].any()
    for b in range(len(data["presample"]["nums"])):
        sizes = [o["presample"]["sizes"][b] for o in outs]
        want = np.max([[s[1]] + s[2] for s in sizes], axis=0)
        for s in sizes:
            np.testing.assert_array_equal(s[0], want)


def _check_engines(engines, num_worker, steps):
    """Per rank's engine results: the two-phase store's losses equal the
    fused store's with the same seeds, its hit rate the posmap's count over
    every rank, dynamic_cache moved the posmap, and the forced overflow
    replayed every step."""
    for name in ("xgnn", "sgnn"):
        for o in engines:
            two, fused = o[name], o[name + "_fused"]
            assert two["caps0"] == fused["caps0"], name
            for a, b in zip(two["losses"], fused["losses"]):
                np.testing.assert_allclose(a, b, rtol=0, atol=LOSS_TOL,
                                           err_msg=name)
            assert all(r["contributed_steps"] == r["steps"] == steps
                       for r in two["epochs"])
            assert 0.0 <= two["acc"] <= 1.0
        hits = sum(o[name]["recount"][0] for o in engines)
        total = sum(o[name]["recount"][1] for o in engines)
        for o in engines:
            got = o[name]["epochs"][-1]["hit_rate"]
            assert abs(got - hits / total) < 1e-12, (name, got, hits, total)
            assert 0.0 < got < 1.0
            assert o[name]["epochs"][-1]["hit_rate"] == \
                engines[0][name]["epochs"][-1]["hit_rate"]
    for o in engines:
        dyn = o["dynamic"]
        assert (dyn["posmap"] != dyn["posmap0"]).any()
        assert (dyn["posmap"] != EMPTY).sum() == \
            (dyn["posmap0"] != EMPTY).sum()
        rep = o["replay"]
        r = rep["epochs"][0]
        assert r["contributed_steps"] == r["steps"] == steps, r
        assert np.isfinite(r["loss"])
        assert rep["caps"][-1] > 256
        assert 0.0 <= rep["acc"] <= 1.0


def _jax_steps(train_set, batch_size, num_parts, seed):
    from xgnn_tpu.engine.shuffler import Shuffler as JShuffler

    return max(JShuffler(np.asarray(train_set), batch_size,
                         num_worker=num_parts, worker_id=w,
                         seed=seed + 1).num_local_step
               for w in range(num_parts))


@pytest.mark.parametrize("suite", [2], indirect=True, ids=["P2"])
def test_multichip_engine_p2_two_phase(graph, suite):
    """At P = 2: per-step losses within 1e-6 of the fused store's with the
    same seeds (the same samples and rows, fetched another way), for the
    partitioned and the replicated cache; the hit rate over both ranks;
    dynamic_cache; a replay that loses no batch."""
    p, data, outs = suite
    engines = [o["engines"] for o in outs]
    assert engines[0]["xgnn"]["epochs"][0]["steps"] == _jax_steps(
        graph.train_set, 96, 2, 42)
    _check_engines(engines, 2, _jax_steps(graph.train_set, 96, 2, 42))
    assert _jax_steps(graph.train_set, 96, 2, 11) == \
        engines[0]["replay"]["epochs"][0]["steps"]


def test_multichip_engine_p1_two_phase(graph):
    """At P = 1 in a world of one in this process, the same checks."""
    arrays = _ds_arrays(graph)
    mesh = pmesh.make_mesh("cpu")
    try:
        out = ranks.engine_cases(mesh, arrays, _engine_cases(1))
    finally:
        mesh.close()
    steps = _jax_steps(graph.train_set, 96, 1, 42)
    _check_engines([out], 1, steps)


def test_cli_arch6_two_ranks_partial_cache_prints_results():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "xgnn_tpu_torch.examples.train", "--cpu",
         "--synthetic", "--synthetic-nodes", "2000", "--arch", "arch6",
         "--num-worker", "2", "--part-cache", "--use-dist-graph",
         "--cache-percentage", "0.2", "--num-epoch", "2", "--batch-size",
         "200", "--fanout", "5", "3", "--num-hidden", "16", "--report-acc",
         "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=SPAWN_S)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "config:cache_percentage=0.2" in lines
    assert "config:part_cache=True" in lines
    results = dict(l.split("=", 1) for l in lines
                   if l.startswith("test_result:"))
    for key in ("test_result:epoch_time:train_total",
                "test_result:final_train_acc", "test_result:test_acc",
                "test_result:cache_hit_rate"):
        assert np.isfinite(float(results[key])), key
    assert 0.0 < float(results["test_result:cache_hit_rate"]) < 1.0
