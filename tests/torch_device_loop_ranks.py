"""What each rank runs in tests/test_torch_multichip_device_loop.py.

The ranks are processes of their own (``parallel.mesh.spawn``, gloo on the
CPU), so these functions import the port alone, never JAX: the test
process holds their results against the JAX package.
"""

import dataclasses

from xgnn_tpu_torch.config import RunConfig
from xgnn_tpu_torch.dataset import Dataset
from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
from xgnn_tpu_torch.parallel import collocated


def _corrupt_on(mesh, rank: int):
    """Make ``sample_any`` on ``rank`` give its batches a duplicate input
    node (the sanity check's first violation); returns the undo."""
    orig = collocated.sample_any

    def sample_any(*args, **kwargs):
        batch = orig(*args, **kwargs)
        if mesh.rank != rank:
            return batch
        ids = batch.input_nodes.clone()
        ids[1] = ids[0]
        return dataclasses.replace(batch, input_nodes=ids)

    collocated.sample_any = sample_any
    return lambda: setattr(collocated, "sample_any", orig)


def _engine(mesh, ds, config, **change):
    return MultiChipEngine(ds, RunConfig(**dict(config, **change)),
                           mesh=mesh).init()


def faults_run(mesh, ds_arrays, config, access_config, access_arrays,
               epochs):
    """On this rank: the node-access log over the fused and the two-phase
    store (rank 0's frequencies, on the dataset ``access_arrays`` under
    ``access_config``), ``device_loop`` against the host loop
    with ``sanity_check`` (the per-step losses and accuracies of
    ``epochs`` epochs), the sanity check's message on a batch corrupted on
    rank 1 in the fused host loop, under ``device_loop`` and in the
    two-phase store, and an overflow replay under ``device_loop``."""
    ds, sparse = Dataset(**ds_arrays), Dataset(**access_arrays)
    out = {"frequency": {}, "history": {}, "raised": {}}
    for shape, change in (("fused", {}), ("two_phase", dict(
            cache_percentage=0.25, cache_policy="degree"))):
        eng = _engine(mesh, sparse, access_config, **change)
        eng.profiler.enable_node_access_log()
        eng.train_epoch(0)
        out["frequency"][shape] = dict(eng.profiler.node_access_frequency())
    for device_loop in (False, True):
        eng = _engine(mesh, ds, config, sanity_check=True,
                      device_loop=device_loop)
        rs = [eng.train_epoch(e) for e in range(epochs)]
        out["history"][device_loop] = {
            "loss": [eng.history[e]["loss"] for e in range(epochs)],
            "acc": [eng.history[e]["acc"] for e in range(epochs)],
            "fused": eng._fused is not None, "results": rs,
            "params": {k: v for k, v in eng.model.state_dict().items()}}
    for shape, change in (("fused", {}), ("device_loop", dict(
            device_loop=True)), ("two_phase", dict(
                cache_percentage=0.25, cache_policy="degree"))):
        eng = _engine(mesh, ds, config, sanity_check=True, **change)
        undo = _corrupt_on(mesh, 1)
        try:
            eng.train_epoch(0)
            out["raised"][shape] = None
        except RuntimeError as e:
            out["raised"][shape] = str(e)
        finally:
            undo()
    tiny = dict(config, frontier_capacities=[config["batch_size"], 128, 256],
                exchange_headroom=0.05, calibration_batches=0,
                device_loop=True)
    eng = _engine(mesh, ds, tiny)
    r = eng.train_epoch(0)
    out["overflow"] = {"result": r, "caps": list(eng.capacities),
                       "dropped": eng._fused is None}
    out["overflow"].update(next=eng.train_epoch(1),
                           again=eng._fused is not None)
    return out

