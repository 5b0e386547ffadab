"""The port's tooling against the JAX package, on the CPU.

The profiler's ``test_result:`` lines, node-access files and trace events,
``check_batch``'s violation flags, checkpoints and resume, ``run()``, the
``device_loop`` epoch (each step run uncaptured from the buffers that the
card's CUDA graph reads) and the two command lines.
"""

import json
import logging
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xgnn_tpu_torch.dataset import Dataset  # noqa: E402

EMPTY = int(np.iinfo(np.int32).max)
TINY = dict(batch_size=64, fanout=(4, 3), num_layer=2, num_hidden=16,
            calibration_batches=1, pipeline=False)


def _log_sequence(prof, P, stages: bool):
    """The same sequence of step, epoch and init items for either
    package's profiler: three epochs of four steps, with per-stage times or
    (as a device_loop epoch logs) only input nodes and epoch times."""
    rng = np.random.default_rng(3)
    for e in range(3):
        for s in range(4):
            if stages:
                prof.log_step(e, s, P.L1_SAMPLE_TIME, float(rng.random()))
                prof.log_step(e, s, P.L1_COPY_TIME, float(rng.random()))
                prof.log_step(e, s, P.L1_TRAIN_TIME, float(rng.random()))
                prof.log_step(e, s, P.L2_CACHE_HIT_RATE, float(rng.random()))
                prof.log_step(e, s, P.L1_MISS_BYTES, float(rng.integers(99)))
            prof.log_step(e, s, P.L1_NUM_NODE, float(rng.integers(1000)))
        prof.log_epoch_add(e, "epoch_time", float(rng.random()))
    prof.log_step(1, 0, P.L3_OVERFLOW_RETRY, 2.0)
    prof.log_init("graph_load_time", 0.25)


@pytest.mark.parametrize("stages", [True, False])
def test_profiler_test_results_equal_jax(capsys, stages):
    from xgnn_tpu import profiler as JP
    from xgnn_tpu_torch import profiler as TP

    out = []
    for P in (JP, TP):
        prof = P.Profiler()
        _log_sequence(prof, P, stages)
        res = prof.test_results(extra={"final_train_acc": 0.5})
        out.append((res, capsys.readouterr().out))
    assert out[0] == out[1]
    assert "test_result:epoch_time:total=" in out[1][1]
    assert ("test_result:epoch_time:sample_total=" in out[1][1]) == stages
    names = [n for n in dir(JP) if n.startswith(("L1_", "L2_", "L3_"))]
    assert names and all(getattr(JP, n) == getattr(TP, n) for n in names)


def test_node_access_files_equal_jax(tmp_path, monkeypatch):
    from xgnn_tpu import profiler as JP
    from xgnn_tpu_torch import profiler as TP

    monkeypatch.setenv("XGNN_LOG_NODE_ACCESS", "1")
    rng = np.random.default_rng(4)
    steps = [rng.integers(0, 50, rng.integers(1, 40)) for _ in range(6)]
    deg = rng.integers(0, 9, 50)
    texts = []
    for tag, P in (("jax", JP), ("torch", TP)):
        prof = P.Profiler()
        for ids in steps:
            prof.log_node_access(ids)
        d = tmp_path / tag
        d.mkdir()
        prof.dump_node_access(str(d / "a.txt"), deg, deg)
        prof.dump_node_access_frequency(str(d / "f.txt"), 50)
        prof.dump_node_access_similarity(str(d / "s.txt"))
        texts.append([(d / n).read_bytes() for n in ("a.txt", "f.txt",
                                                      "s.txt")]
                     + [prof.optimal_cache_hit_rate(0.2, 50)])
    assert texts[0] == texts[1]
    assert texts[1][0]


def test_dump_trace_events_equal_jax(tmp_path):
    from xgnn_tpu import profiler as JP
    from xgnn_tpu_torch import profiler as TP

    events = []
    for P in (JP, TP):
        prof = P.Profiler()
        for step in range(2):
            for stage in ("sample", "copy", "train", "other"):
                prof.trace_begin(1, step, stage)
                prof.trace_end(1, step, stage)
        path = tmp_path / f"{P.__name__}.json"
        prof.dump_trace(str(path))
        events.append(json.loads(path.read_text())["traceEvents"])
    key = lambda ev: [(e["name"], e["ph"], e["pid"], e["tid"]) for e in ev]
    assert key(events[0]) == key(events[1])
    assert {e["tid"] for e in events[1]} == {1, 2, 4, 9}


def _batches(small_ds, violation):
    """One clean batch of the port's sampler (all blocks local ids), a
    copy with ``violation`` planted, and both as the JAX package's type."""
    from xgnn_tpu.types import Block as JBlock
    from xgnn_tpu.types import SampledBatch as JBatch
    from xgnn_tpu_torch import RunConfig, Sampler
    from xgnn_tpu_torch.device import generator
    from xgnn_tpu_torch.types import Graph

    ds = Dataset.from_arrays(small_ds)
    cfg = RunConfig(batch_size=48, fanout=(4, 3), num_layer=2)
    sampler = Sampler(Graph.from_dataset(ds, "cpu"), cfg,
                      capacities=(64, 256, 1024))
    seeds = np.full(64, EMPTY, np.int32)
    seeds[:48] = ds.train_set[:48]
    batch = sampler.sample(torch.from_numpy(seeds), 48,
                           generator(torch.device("cpu"), 1))
    ids = batch.input_nodes.clone()
    n = int(batch.num_input)
    neigh = batch.blocks[0].neigh.clone()
    nd = int(batch.blocks[0].num_dst)
    assert 2 < n < ids.shape[0] and nd < neigh.shape[0]
    if violation == "input_duplicate":
        ids[1] = ids[0]
    elif violation == "input_empty_leak":
        ids[n - 1] = EMPTY
    elif violation == "input_pad_dirty":
        ids[n] = 3
    elif violation == "neigh_out_of_range":
        neigh[0, 0] = int(batch.blocks[0].num_src) + 2
    elif violation == "neigh_pad_dirty":
        neigh[nd, 0] = 0
    blocks = (type(batch.blocks[0])(neigh=neigh,
                                    num_dst=batch.blocks[0].num_dst,
                                    num_src=batch.blocks[0].num_src),
              ) + tuple(batch.blocks[1:])
    port = type(batch)(blocks=blocks, input_nodes=ids,
                       num_input=batch.num_input,
                       output_nodes=batch.output_nodes,
                       num_output=batch.num_output, overflow=batch.overflow)
    ref = JBatch(
        blocks=[JBlock(neigh=jnp.asarray(b.neigh.numpy()),
                       num_dst=jnp.int32(int(b.num_dst)),
                       num_src=jnp.int32(int(b.num_src)))
                for b in blocks],
        input_nodes=jnp.asarray(ids.numpy()),
        num_input=jnp.int32(n),
        output_nodes=jnp.asarray(batch.output_nodes.numpy()),
        num_output=jnp.int32(48), key=jnp.zeros((), jnp.int32),
        overflow=jnp.asarray(False))
    return port, ref


@pytest.mark.parametrize("violation", [
    None, "input_duplicate", "input_empty_leak", "input_pad_dirty",
    "neigh_out_of_range", "neigh_pad_dirty"])
def test_check_batch_flags_equal_jax(small_ds, violation):
    from xgnn_tpu.ops import sanity as jsanity
    from xgnn_tpu_torch.ops import sanity

    port, ref = _batches(small_ds, violation)
    flags = sanity.check_batch(port)
    assert flags.dtype == torch.int32 and flags.shape == ()
    assert int(flags) == int(jsanity.check_batch(ref))
    assert sanity.explain(int(flags)) == (
        [] if violation is None else [violation])
    assert sanity.VIOLATION_NAMES == jsanity.VIOLATION_NAMES


def test_sanity_check_in_the_engine(learn_ds, monkeypatch):
    """``sanity_check`` passes clean batches and raises with the
    violation's name on a bad one."""
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.ops import sanity

    monkeypatch.setenv("XGNN_SANITY_CHECK", "1")
    engine = Engine(Dataset.from_arrays(learn_ds), RunConfig(**TINY),
                    device="cpu").init()
    assert engine.config.sanity_check
    assert np.isfinite(engine.train_epoch(0)["loss"])
    monkeypatch.setattr(sanity, "check_batch",
                        lambda b: torch.tensor(1 << 3, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="neigh_out_of_range"):
        engine.train_epoch(1)


def _train_state(engine):
    return ([p.detach().clone() for p in engine.model.parameters()]
            + [t.clone() for t in engine.opt.mu + engine.opt.nu]
            + [engine.opt.count.clone()])


@pytest.mark.parametrize("device_loop", [False, True])
def test_resume_equals_an_uninterrupted_run(learn_ds, tmp_path, capsys,
                                            device_loop):
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch.checkpoint import CheckpointManager

    ds = Dataset.from_arrays(learn_ds)
    common = dict(TINY, calibration_batches=0, dropout=0.5,
                  device_loop=device_loop)
    whole = Engine(ds, RunConfig(**common, num_epoch=3), device="cpu")
    whole.run()
    ckpt = str(tmp_path / "ckpt")
    first = Engine(ds, RunConfig(**common, num_epoch=2, checkpoint_dir=ckpt),
                   device="cpu")
    first.run()
    resumed = Engine(ds, RunConfig(**common, num_epoch=3,
                                   checkpoint_dir=ckpt), device="cpu")
    r = resumed.run()
    assert "resumed from checkpoint at epoch 2" in capsys.readouterr().out
    assert [e["epoch"] for e in r["epochs"]] == [2]
    for a, b in zip(_train_state(whole), _train_state(resumed)):
        assert torch.equal(a, b)
    assert int(resumed.opt.count) > int(first.opt.count) > 0
    mgr = CheckpointManager(ckpt)
    assert mgr.steps() == [0, 1, 2] and mgr.latest_step() == 2
    for i in range(3, 5):
        mgr.save(i, (resumed.model, resumed.opt), extra={"epoch": i})
    assert mgr.steps() == [2, 3, 4]  # max_to_keep=3
    assert not list(Path(ckpt).glob("*.tmp"))


@pytest.mark.parametrize("device_loop", [False, True])
def test_run_result_keys_equal_jax(learn_ds, device_loop, capsys):
    from xgnn_tpu import RunConfig as JConfig
    from xgnn_tpu.engine import Engine as JEngine
    from xgnn_tpu_torch import Engine, RunConfig

    common = dict(TINY, num_epoch=2, report_acc=1, device_loop=device_loop)
    ref = JEngine(learn_ds, JConfig(**common, root_path="/tmp")).run()
    engine = Engine(Dataset.from_arrays(learn_ds), RunConfig(**common),
                    device="cpu")
    got = engine.run()
    lines = capsys.readouterr().out
    assert got.keys() == ref.keys()
    assert got["test_results"].keys() == ref["test_results"].keys()
    assert [e.keys() for e in got["epochs"]] == [e.keys()
                                                 for e in ref["epochs"]]
    for k, v in got["test_results"].items():
        assert f"test_result:{k}=" in lines
        assert np.isfinite(v)
    assert got["epochs"][-1]["valid_acc"] == engine.evaluate("valid")


@pytest.mark.parametrize("model", ["graphsage", "gcn", "pinsage"])
def test_device_loop_losses_equal_the_host_loop(learn_ds, model):
    """Two epochs at dropout 0.5: every step's loss and accuracy."""
    from xgnn_tpu_torch import Engine, RunConfig

    ds = Dataset.from_arrays(learn_ds)
    hist = []
    for device_loop in (False, True):
        cfg = RunConfig(**TINY, model=model, dropout=0.5,
                        device_loop=device_loop)
        engine = Engine(ds, cfg, device="cpu").init()
        results = [engine.train_epoch(e) for e in range(2)]
        assert (engine._fused is not None) == device_loop
        hist.append((results, [engine.history[e] for e in range(2)]))
    for (rh, hh), (rd, hd) in zip(zip(*hist[0]), zip(*hist[1])):
        assert np.all(np.isfinite(hh["loss"]))
        np.testing.assert_allclose(hd["loss"], hh["loss"], rtol=1e-5)
        np.testing.assert_allclose(hd["acc"], hh["acc"], rtol=1e-5)
        np.testing.assert_array_equal(hd["num_input"], hh["num_input"])
        assert rd["loss"] == pytest.approx(rh["loss"], rel=1e-5)


def test_device_loop_overflow_skips_and_grows(learn_ds, capsys):
    from xgnn_tpu_torch import Engine, RunConfig
    from xgnn_tpu_torch import profiler as P

    cfg = RunConfig(**dict(TINY, calibration_batches=0), device_loop=True,
                    frontier_capacities=(64, 96, 96))  # far too small
    engine = Engine(Dataset.from_arrays(learn_ds), cfg, device="cpu").init()
    r0 = engine.train_epoch(0)
    assert "overflowed capacity in epoch 0" in capsys.readouterr().out
    over = engine.history[0]["overflow"] == 1
    loss = engine.history[0]["loss"]
    assert over.sum() >= len(over) - 1  # the last, short batch may fit
    assert np.isnan(loss[over]).all() and np.isfinite(loss[~over]).all()
    # an overflowed step is skipped on the device: Adam counts the others
    assert int(engine.opt.count) == int((~over).sum())
    assert engine._fused is None and engine.sampler.capacities[-1] > 96
    assert engine.profiler._step_items[(0, 0)][P.L3_OVERFLOW_RETRY] > 0
    engine.train_epoch(1)
    assert engine._fused is not None or engine.sampler.capacities[-1] > 192


@pytest.mark.parametrize("why", ["cache", "sanity_check", "dump_trace"])
def test_ineligible_device_loop_warns_once(learn_ds, caplog, why):
    from xgnn_tpu_torch import Engine, RunConfig

    extra = {"cache": dict(cache_percentage=0.2, cache_policy="degree"),
             "sanity_check": dict(sanity_check=True),
             "dump_trace": dict(dump_trace=True)}[why]
    ds = Dataset.from_arrays(learn_ds)
    engine = Engine(ds, RunConfig(**TINY, **extra, device_loop=True),
                    device="cpu").init()
    host = Engine(ds, RunConfig(**TINY, **extra), device="cpu").init()
    with caplog.at_level(logging.WARNING):
        for epoch in range(2):
            r = engine.train_epoch(epoch)
            np.testing.assert_array_equal(
                engine.history[epoch]["loss"],
                (host.train_epoch(epoch), host.history[epoch]["loss"])[1])
    warned = [m for m in caplog.messages if "device_loop requested" in m]
    assert len(warned) == 1 and engine._fused is None
    assert "stages" in engine.history[1] and np.isfinite(r["loss"])


def test_run_writes_the_trace_and_node_access_files(learn_ds, tmp_path,
                                                    monkeypatch, capsys):
    from xgnn_tpu_torch import Engine, RunConfig

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("XGNN_LOG_NODE_ACCESS", "1")
    monkeypatch.setenv("XGNN_DUMP_TRACE", "1")
    ds = Dataset.from_arrays(learn_ds)
    engine = Engine(ds, RunConfig(**TINY, num_epoch=2), device="cpu")
    engine.run()
    out = capsys.readouterr().out
    assert "test_result:optimal_cache_hit_rate=" in out
    events = json.loads((tmp_path / "xgnn_trace.json").read_text())[
        "traceEvents"]
    steps = -(-len(ds.train_set) // TINY["batch_size"])
    assert len(events) == 2 * 3 * 2 * steps  # B and E, 3 stages, 2 epochs
    access = (tmp_path / "node_access.txt").read_text().split("\n")
    node, count, deg, _ = map(int, access[0].split())
    assert count >= 1 and deg == int(ds.degrees[node])
    for name in ("node_access_frequency.txt", "node_access_similarity.txt"):
        assert (tmp_path / name).read_text()


def test_profiler_logs_init_and_memory(learn_ds):
    from xgnn_tpu_torch import Engine, RunConfig

    engine = Engine(Dataset.from_arrays(learn_ds), RunConfig(**TINY),
                    device="cpu").init()
    items = engine.profiler._init_items
    for k in ("graph_load_time", "sampler_build_time", "cache_build_time",
              "model_init_time", "calibrated_input_cap",
              "mem:model_init:bytes_in_use"):
        assert k in items, k
    assert items["mem:model_init:peak_bytes_in_use"] == 0  # the CPU


_TOY = ["--cpu", "--synthetic", "--synthetic-nodes", "3000",
        "--batch-size", "100", "--fanout", "4", "3", "--num-hidden", "16"]


@pytest.mark.parametrize("device_loop", [False, True])
def test_the_clis_train_and_evaluate_a_checkpoint(tmp_path, capsys,
                                                  device_loop):
    from xgnn_tpu_torch.examples import accuracy, train

    ckpt = str(tmp_path / "ckpt")
    argv = _TOY + ["--num-epoch", "2", "--report-acc", "1",
                   "--checkpoint-dir", ckpt, "--model", "gcn"]
    engine = train.main(argv + (["--device-loop"] if device_loop else []))
    out = capsys.readouterr().out
    assert "config:device_loop=" + str(device_loop) in out
    for key in ("epoch_time:total", "final_train_acc", "test_acc"):
        assert re.search(rf"^test_result:{key}=[0-9.]+$", out, re.M), key
    assert (engine._fused is not None) == device_loop
    accs = accuracy.main(_TOY[:4] + ["--fanout", "4", "3", "--num-hidden",
                                     "16", "--model", "gcn",
                                     "--checkpoint-dir", ckpt])
    out = capsys.readouterr().out
    assert re.search(r"^test_result:full_valid_acc=[0-9.]+$", out, re.M)
    from xgnn_tpu_torch.inference import evaluate_full

    ds = engine.ds
    assert accs["valid"] == evaluate_full(
        engine.model, ds.indptr, ds.indices, ds.feat, ds.label,
        ds.valid_set, device="cpu")


@pytest.mark.parametrize("flags", [
    # --dataset, --synthetic-rmat and --synthetic-signal run now
    # (tests/test_torch_dataset_files.py); --num-worker N runs the
    # collocated engine (tests/test_torch_port_multichip.py), its partial
    # cache (tests/test_torch_port_ggms.py), presample_static and the host
    # cold tier over several cards (test_cli_flags_once_refused_train);
    # GAT under bfloat16 runs now (tests/test_torch_gat_bf16.py), and so
    # do the disaggregated engine (tests/test_torch_disagg.py) and the
    # collocated engine's placement solve and DCN groups
    # (tests/test_torch_port_dcn.py); GAT with more heads than K5 keeps
    # still raises
    ["--model", "gat", "--remat", "--feat-dtype", "bfloat16",
     "--arch", "arch6", "--auto-placement", "--num-head", "16"],
    ["--model", "gat", "--agg-impl", "tiled", "--compute-dtype",
     "bfloat16", "--num-dcn-groups", "2", "--num-worker", "2",
     "--num-head", "12"]])
def test_cli_flags_of_unported_paths_name_roadmap_items(flags):
    from xgnn_tpu_torch.examples import train

    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    argv = ["--cpu", "--synthetic"] + flags
    with pytest.raises(NotImplementedError) as err:
        train.main(argv)
    titles = [t for part in str(err.value).split("ROADMAP")[1:]
              for t in re.findall(r"'([^']+)'", part.split(";")[0])]
    assert titles, str(err.value)
    for title in titles:
        assert f"**{title}" in roadmap, title


@pytest.mark.parametrize("flags", [
    ["--num-worker", "4", "--cache-percentage", "0.2", "--cache-policy",
     "presample_static"],
    ["--use-dist-graph", "--part-cache", "--num-worker", "2",
     "--dist-graph-percentage", "0.85"]],
    ids=["presample_static_p4", "cold_tier"])
def test_cli_flags_once_refused_train(flags):
    """presample_static over four ranks and the host cold tier over two,
    once refused, train at toy size and print the test_result: lines."""
    import os
    import subprocess
    import sys

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
