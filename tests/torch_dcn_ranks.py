"""What each rank runs in tests/test_torch_port_dcn.py.

The ranks are processes of their own (``parallel.mesh.spawn``, gloo on the
CPU), so these functions import the port alone, never JAX: the test
process holds their results against the JAX package.
"""

import numpy as np
import torch

import torch_multichip_ranks as multichip
from xgnn_tpu_torch.config import RunConfig
from xgnn_tpu_torch.parallel import exchange
from xgnn_tpu_torch.parallel.mesh import make_mesh_2d


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def suite(mesh, data):
    """On the world ``mesh``: the DCN groups' rank map and reach, the exact
    presample's counts, one collocated step over 2 x 2 and the engines;
    numpy results by name."""
    out = {"map": {}}
    for groups in data["groups"]:
        m = make_mesh_2d(groups, mesh)
        # a group's sum stays in the group; the world's spans every rank
        inside = m.all_reduce(torch.tensor([mesh.rank], dtype=torch.int64))
        every = m.world.all_reduce(torch.tensor([mesh.rank],
                                                dtype=torch.int64))
        out["map"][groups] = (mesh.rank // m.size, m.rank, m.size,
                              int(inside), int(every))
    out["exact"] = {name: exact_counts(mesh, data["ds"], cfg)
                    for name, cfg in data["exact"].items()}
    step = data["step"]
    group = make_mesh_2d(step["groups"], mesh)
    feat = exchange.interleaved_part(_t(data["feat"]), group.size,
                                     group.rank)
    out["step"] = multichip.collocated_step(group, step, data["label"],
                                            feat, data["csr"])
    out["engines"] = {name: engine_run(mesh, data["ds"], cfg, epochs)
                      for name, (cfg, epochs) in data["engines"].items()}
    return out


def _engine(mesh, ds_arrays, config):
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    return MultiChipEngine(Dataset(**ds_arrays), RunConfig(**config),
                           mesh=mesh)


def _unmap(eng):
    """The mesh is the caller's: unmap the host arrays alone."""
    for held in (eng.host, None if eng.tier is None else eng.tier.csr):
        if held is not None:
            held.close()


def exact_counts(mesh, ds_arrays, config):
    """The engine's presample_static counts (every node's, summed over the
    groups) from a fresh run of its presample."""
    eng = _engine(mesh, ds_arrays, config).init()
    try:
        return eng._presample_and_calibrate()
    finally:
        _unmap(eng)


def engine_run(mesh, ds_arrays, config, epochs):
    """MultiChipEngine's epochs, per-step losses, valid accuracy, solved
    placement and parameters on this rank."""
    eng = _engine(mesh, ds_arrays, config)
    try:
        eng.init()
        rs = [eng.train_epoch(e) for e in range(epochs)]
        cfg = eng.config
        return {"epochs": rs,
                "losses": [eng.history[e]["loss"] for e in range(epochs)],
                "acc": eng.evaluate("valid"),
                "caps": list(eng.capacities), "seg_cap": eng.seg_cap,
                "num_parts": eng.num_parts, "part": eng.part,
                "two_phase": eng.two_phase,
                "ncn": None if eng.tier is None else eng.tier.num_cache_node,
                "placement": (cfg.use_dist_graph, cfg.dist_graph_percentage,
                              cfg.cache_percentage),
                "plan": eng.placement_plan is not None,
                "params": {k: v for k, v in eng.model.state_dict().items()}}
    finally:
        _unmap(eng)
