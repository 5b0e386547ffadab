"""Ranks on several hosts and the host tier held once a host, against the
JAX package.

``parallel/multihost.py`` against ``xgnn_tpu/parallel/multihost.py``:
``put_sharded_global``'s shards at four ranks equal JAX's addressable
shards of ``NamedSharding(mesh, PS("data"))`` over four CPU devices, and it
refuses what JAX refuses; ``local_worker_ids`` equals JAX's function with
``jax.process_count`` / ``process_index`` patched (host = process);
``launch_env`` reads torchrun's variables.  One spawn of four gloo ranks
as two simulated hosts of two (``tests/torch_multihost_ranks.py``, over a
TCP store, under its own time limit) runs the three configurations of
``tests/test_multihost.py`` (the fused store, the two-phase GGMS with the
cold tier, and the same in two DCN groups on the host boundary) on the two
hosts and, in the same ranks, as one host of four: the losses and hit
rates are equal on every rank, bit-equal between the two shapes, and
within the collocated step's tolerance (rtol 1e-5) of JAX's engine over
four devices from the same weights.  Every fanout covers the graph's
largest degree and dropout is 0, so the port's draws and JAX's keys take
the same neighbours.  A host's ranks map one file, the two hosts two, no
file of the job is left, and a rank that cannot create its file makes
every rank raise.  arch5 at 2 + 2 roles shares one table.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as PS  # noqa: E402

from xgnn_tpu import synthetic as jsyn  # noqa: E402
from xgnn_tpu.config import RunConfig as JRunConfig  # noqa: E402

import torch_multihost_ranks as ranks  # noqa: E402
from xgnn_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from xgnn_tpu_torch.parallel import multihost  # noqa: E402
from xgnn_tpu_torch.store import host_shared  # noqa: E402

SPAWN_S = 150  # the spawn's time limit
WORLD = 4
# tests/test_multihost.py's configurations, with every fanout above the
# graph's largest degree and no dropout: the draws are the whole rows
BASE = dict(batch_size=64, fanout=(16, 16), num_layer=2, num_hidden=16,
            model="graphsage", sample_type="khop3", num_worker=WORLD,
            use_dist_graph=True, part_cache=True, num_epoch=1, lr=0.01,
            dropout=0.0, root_path="/tmp")
TWO_PHASE = dict(BASE, dist_graph_percentage=0.7, cache_percentage=0.3,
                 cache_policy="pre_sample", presample_epoch=1,
                 pipeline=True)
CONFIGS = {"engine": BASE, "two_phase": TWO_PHASE,
           "hier": dict(TWO_PHASE, num_dcn_groups=2)}


@pytest.fixture(scope="module")
def graph():
    ds = jsyn.make_synthetic_dataset(num_node=800, avg_degree=3,
                                     feat_dim=16, num_class=4, seed=3,
                                     power_law=False, train_frac=0.4)
    assert np.diff(ds.indptr).max() <= min(BASE["fanout"])
    return ds


@pytest.fixture(scope="module")
def jax_run(graph):
    """JAX's two-phase engine over four devices: its initial weights, its
    epoch and its valid accuracy (full rows drawn, so the three
    configurations train alike)."""
    from xgnn_tpu.engine.multi_engine import MultiChipEngine as JEngine

    jeng = JEngine(graph, JRunConfig(**TWO_PHASE),
                   devices=jax.devices()[:WORLD]).init()
    params = jax.tree.map(np.asarray, jeng.state.params)
    r = jeng.train_epoch(0)
    return params, r, jeng.evaluate("valid", max_batches=2)


@pytest.fixture(scope="module")
def suite(graph, jax_run):
    from xgnn_tpu_torch.convert import params_from_flax

    arrays = {k: getattr(graph, k) for k in (
        "name", "num_node", "num_edge", "feat_dim", "num_class", "indptr",
        "indices", "feat", "label", "train_set", "valid_set", "test_set")}
    params = {k: v.numpy() for k, v in params_from_flax(jax_run[0]).items()}
    data = {"arr": np.arange(WORLD * 3, dtype=np.float32).reshape(WORLD, 3),
            "ds": arrays, "configs": CONFIGS, "params": params}
    return pmesh.spawn(ranks.suite, WORLD, data, device="cpu",
                       timeout=SPAWN_S, hosts=2)


class _Fake:
    """A rank's view of a world without a process group: what the
    functions of multihost read."""

    def __init__(self, rank, size, host, num_hosts):
        self.rank, self.size, self.device = rank, size, torch.device("cpu")
        self.host, self.num_hosts = host, num_hosts


# ------------------------------------------------------- multihost's API
def test_put_sharded_global_shards_equal_jax():
    """Rank r's block equals JAX's addressable shard on device r."""
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    jmesh = JMesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    g = jax.device_put(arr, NamedSharding(jmesh, PS("data", None)))
    want = {s.device.id: np.asarray(s.data) for s in g.addressable_shards}
    for r in range(WORLD):
        got = multihost.put_sharded_global(arr, _Fake(r, WORLD, 0, 1))
        np.testing.assert_array_equal(got.numpy(),
                                      want[jax.devices()[r].id])


@pytest.mark.parametrize("shape", [(6, 3), ()], ids=["indivisible", "0d"])
def test_put_sharded_global_refuses_what_jax_refuses(shape):
    arr = np.zeros(shape, np.float32)
    jmesh = JMesh(np.asarray(jax.devices()[:WORLD]), ("data",))
    with pytest.raises(ValueError):
        jax.device_put(arr, NamedSharding(jmesh, PS("data")))
    with pytest.raises(ValueError):
        multihost.put_sharded_global(arr, _Fake(0, WORLD, 0, 1))


@pytest.mark.parametrize("hosts", [1, 2, 4])
@pytest.mark.parametrize("total", [4, 8])
def test_local_worker_ids_equal_jax(monkeypatch, hosts, total):
    """JAX's formula with the host in place of JAX's process."""
    from xgnn_tpu.parallel import multihost as jmultihost

    for h in range(hosts):
        monkeypatch.setattr(jax, "process_count", lambda: hosts)
        monkeypatch.setattr(jax, "process_index", lambda h=h: h)
        want = list(jmultihost.local_worker_ids(total))
        assert multihost.local_worker_ids(
            total, _Fake(0, total, h, hosts)) == want


def test_launch_env_reads_torchrun_and_refuses_missing(monkeypatch):
    env = dict(MASTER_ADDR="node0", MASTER_PORT="29500", WORLD_SIZE="8",
               RANK="5", LOCAL_RANK="1", LOCAL_WORLD_SIZE="4",
               GROUP_RANK="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.launch_env() == ("tcp://node0:29500", 8, 5, 1, 1)
    monkeypatch.delenv("GROUP_RANK")
    assert multihost.launch_env(host=None)[3] == 5 // 4
    # the arguments win, an address with a scheme is the method itself
    assert multihost.launch_env("file:///tmp/s", 2, 0, 0, 0) == (
        "file:///tmp/s", 2, 0, 0, 0)
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(RuntimeError, match="LOCAL_RANK"):
        multihost.launch_env()


def test_global_mesh_needs_initialize(monkeypatch):
    monkeypatch.setattr(multihost, "_WORLD", None)
    with pytest.raises(RuntimeError, match="initialize"):
        multihost.global_mesh()


# ------------------------------------------------ two hosts of two ranks
def test_two_hosts_of_two_ranks(suite):
    """Each rank's host view, its shard and the summed all_reduce (JAX's
    66.0), and its host's workers."""
    for r, o in enumerate(suite):
        assert o["host"] == (r // 2, 2, r % 2, 2)
        np.testing.assert_array_equal(
            o["shard"], np.arange(12, dtype=np.float32).reshape(4, 3)[r:r + 1])
        assert o["psum"] == 66.0
        assert o["workers"] == {4: [2 * (r // 2), 2 * (r // 2) + 1],
                                8: list(range(4 * (r // 2),
                                              4 * (r // 2) + 4))}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_configs_equal_one_host_and_jax(suite, jax_run, name):
    """Equal on every rank; the two hosts bit-equal to one host of four;
    the epoch's loss and accuracy within rtol 1e-5 of JAX's engine (the
    collocated step's tolerance), the two-phase hit rate equal to JAX's."""
    _, jr, jacc = jax_run
    first = suite[0]["engines"][f"two_hosts/{name}"]
    for o in suite:
        two = o["engines"][f"two_hosts/{name}"]
        one = o["engines"][f"one_host/{name}"]
        assert two["two_phase"] == (name != "engine")
        assert two["num_groups"] == (2 if name == "hier" else 1)
        assert two["num_parts"] == (2 if name == "hier" else 4)
        np.testing.assert_array_equal(two["losses"], one["losses"])
        np.testing.assert_array_equal(two["losses"], first["losses"])
        for k, v in two["params"].items():
            np.testing.assert_array_equal(v, one["params"][k])
            np.testing.assert_array_equal(v, first["params"][k])
        for shape in (two, one):
            r = shape["epoch"]
            assert r["steps"] == jr["steps"]
            np.testing.assert_allclose(r["loss"], jr["loss"], rtol=1e-5)
            np.testing.assert_allclose(shape["acc"], jacc, rtol=1e-5)
            if name != "engine":
                assert r["hit_rate"] == two["epoch"]["hit_rate"]
                np.testing.assert_allclose(r["hit_rate"], jr["hit_rate"],
                                           rtol=1e-6)


@pytest.mark.parametrize("name", ["two_phase", "hier"])
def test_a_hosts_ranks_map_one_file(suite, name):
    """The feature table and each cold-tier array: one file a host (one
    inode on its ranks, another on the other host's), one file for one
    host of four; every name unlinked once mapped, every view read-only."""
    arrays = suite[0]["engines"][f"two_hosts/{name}"]["files"]
    assert set(arrays) == {"feat", "indptr", "indices"}
    for a in arrays:
        two = [o["engines"][f"two_hosts/{name}"]["files"][a]
               for o in suite]
        one = [o["engines"][f"one_host/{name}"]["files"][a] for o in suite]
        assert two[0]["ino"] == two[1]["ino"] != two[2]["ino"] \
            == two[3]["ino"], a
        assert two[0]["path"] == two[1]["path"] != two[2]["path"]
        assert len({f["ino"] for f in one}) == 1
        assert all(f["unlinked"] and f["read_only"] for f in two + one)


def test_no_file_of_the_job_is_left(suite):
    """Each name unlinked by the ranks, and the spawn's directory for the
    job's files (in the shared files' directory) removed with it."""
    for o in suite:
        assert o["left"] == [] and o["left_after_failure"] == []
        assert o["shm_dir"] == suite[0]["shm_dir"]
    job = suite[0]["shm_dir"]
    assert os.path.dirname(job) == host_shared.shm_dir()
    assert os.path.basename(job).startswith("xgnn_job_")
    assert not os.path.exists(job)
    for t in suite[0]["tokens"] + [suite[0]["failing_token"]]:
        assert not [f for f in os.listdir(host_shared.shm_dir())
                    if f.startswith(f"{host_shared.PREFIX}{t}")]


def test_a_rank_that_cannot_create_its_file_raises_on_every_rank(suite):
    """Host 1's first rank finds no directory: every rank raises, naming
    it, within the spawn's limit; nothing falls back to a private copy."""
    for r, o in enumerate(suite):
        assert o["raised"] is not None, r
        assert "failed on rank 2" in o["raised"]
    assert "FileNotFoundError" in suite[2]["raised"]


def test_a_failed_registration_is_released_on_every_rank(suite):
    """Rank 1 cannot register its mapping after ranks 0, 2 and 3 registered
    theirs: every rank raises, naming rank 1; those three release their
    registration, and no rank keeps the file mapped."""
    for r, o in enumerate(suite):
        f = o["failed_registration"]
        assert f["raised"] is not None and "failed on rank 1" in f["raised"]
        assert f["registered"] == 0, r
        assert f["released"] == (0 if r == 1 else 1), r
        assert not f["mapped"], r
    assert "registration refused" in suite[1]["failed_registration"]["raised"]


@pytest.mark.parametrize("when", ["before", "during"])
def test_a_full_directory_raises_with_its_room(monkeypatch, tmp_path, when):
    """A host of one on the CPU: a directory without room for the array
    (checked before the write, or found full by it) raises, naming the
    file, its bytes and the bytes free; nothing is left behind."""
    monkeypatch.setenv(host_shared.SHM_DIR_ENV, str(tmp_path))
    if when == "before":
        real = os.statvfs

        def statvfs(path):
            st = real(path)
            return os.statvfs_result((st.f_bsize, st.f_frsize, st.f_blocks,
                                      st.f_bfree, 0) + tuple(st)[5:])

        monkeypatch.setattr(host_shared.os, "statvfs", statvfs)
    else:
        def pwrite(fd, data, at):
            raise OSError(28, "No space left on device")

        monkeypatch.setattr(host_shared.os, "pwrite", pwrite)
    world = pmesh.make_mesh("cpu")
    try:
        with pytest.raises(RuntimeError, match="failed on rank 0") as e:
            host_shared.SharedHostArray(world, np.ones((100, 8), np.float32),
                                        torch.float32, "full")
    finally:
        world.close()
    cause = str(e.value)
    assert "3200 bytes do not fit" in cause and str(tmp_path) in cause
    assert "bytes free" in cause
    assert os.listdir(tmp_path) == []


# ------------------------------------------------------------------ arch5
def test_arch5_trainers_share_one_table(graph):
    """DisaggregatedEngine at 2 + 2 roles on the CPU: the trainers' tiered
    stores read one host table, the samplers' tiers one host CSR; an epoch
    trains."""
    from xgnn_tpu_torch import RunConfig
    from xgnn_tpu_torch.engine.disagg_engine import DisaggregatedEngine

    cfg = RunConfig(**dict(BASE, num_worker=1, arch="arch5",
                           num_sample_worker=2, num_train_worker=2,
                           cache_percentage=0.3, cache_policy="degree",
                           dist_graph_percentage=0.7))
    eng = DisaggregatedEngine(graph, cfg, device="cpu").init()
    try:
        hosts = [src.host for src in eng.feature_sources]
        assert len(hosts) == 2 and hosts[0] is hosts[1] is eng._host_table
        tiers = [s.tier for s in eng.svc.samplers]
        assert tiers[0].csr is tiers[1].csr
        r = eng.train_epoch(0)
        assert np.isfinite(r["loss"]) and 0.0 < r["hit_rate"] < 1.0
    finally:
        eng.close()
    assert eng._host_table is None
