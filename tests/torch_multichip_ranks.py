"""What each rank runs in tests/test_torch_port_multichip.py.

The ranks are processes of their own (``parallel.mesh.spawn``, gloo on the
CPU), so these functions import the port alone, never JAX: the test
process holds their results against the JAX package.
"""

import numpy as np
import torch

from xgnn_tpu_torch.config import RunConfig, SampleType
from xgnn_tpu_torch.parallel import collocated, dist_topology, exchange


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def suite(mesh, data):
    """The exchange, the partitioned layers and walk, and one collocated
    step, on this rank; numpy results by name."""
    r, p = mesh.rank, mesh.size
    out = {}
    feat = exchange.interleaved_part(_t(data["feat"]), p, r)
    for name, seg in data["gather_segs"].items():
        ids = _t(data["gather_ids"][r])
        rows, of = exchange.partitioned_gather(feat, ids, mesh, seg)
        buf, pick, of2 = exchange.partitioned_gather_indirect(feat, ids,
                                                              mesh, seg)
        out[f"gather_{name}"] = (rows, of, buf, pick, of2)
    csr = data["csr"]
    topo = dist_topology.partition_part(
        _t(csr["indptr"]).long(), _t(csr["indices"]), p, r,
        prob=_t(csr["prob"]), alias=_t(csr["alias"]),
        prefix=_t(csr["prefix"]))
    for st, case in data["layers"].items():
        kind = st if st == dist_topology.UNIFORM_WR else SampleType(st)
        neigh, of = dist_topology.sample_layer_partitioned(
            topo, _t(case["frontier"][r]), data["fanout"], mesh,
            case["seg_cap"], kind, u=_t(case["u"][r]),
            coin=_t(case["coin"][r]) if "coin" in case else None)
        out[f"layer_{st}"] = (neigh, of)
    walk = data["walk"]
    gen = torch.Generator().manual_seed(100 + r)
    out["walk"] = dist_topology.sample_random_walk_partitioned(
        topo, _t(walk["frontier"][r]), walk["fanout"], mesh, walk["seg_cap"],
        num_random_walk=walk["w"], random_walk_length=walk["l"],
        restart_prob=0.5, generator=gen)
    if "step" in data:
        out["step"] = collocated_step(mesh, data["step"], data["label"],
                                      feat, csr)
    return out


def collocated_step(mesh, step, label, feat_part, csr):
    """One collocated step from flax weights at dropout 0: this rank's
    batch (in local-id form, with its input rows), the reduced gradients,
    and the parameters after the update, by the pieces and by the fused
    step (which must agree).  ``mesh`` may be a DCN group's: the stores
    are its parts, the seeds the world rank's."""
    from xgnn_tpu_torch.convert import params_from_flax
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.train import Adam

    r, p, w = mesh.rank, mesh.size, mesh.world.rank
    cfg = RunConfig(**step["config"])
    topo = dist_topology.partition_part(_t(csr["indptr"]).long(),
                                        _t(csr["indices"]), p, r)
    labels = exchange.interleaved_part(_t(label), p, r).reshape(-1, 1)
    seeds, n = _t(step["seeds"][w]), int(step["num_seed"][w])
    results = []
    for fused in (False, True):
        model = build_model(cfg, feat_part.shape[1], step["num_class"])
        model.load_state_dict(params_from_flax(step["params"]))
        opt = Adam(list(model.parameters()), cfg.lr)
        gen = torch.Generator().manual_seed(7 + w)
        if fused:
            fn = collocated.make_collocated_train_step(
                model, opt, cfg, mesh, step["caps"], step["seg_cap"], True)
            m = fn(topo, feat_part, labels, seeds, n, gen)
            results.append({"loss": m["loss"], "overflow": m["overflow"],
                            "params": dict(model.state_dict())})
            continue
        batch = collocated.sample_any(topo, seeds, n, cfg, step["caps"],
                                      step["seg_cap"], mesh, True, gen)
        blocks, x, lab, of = collocated.exchange_inputs(
            batch, feat_part, labels, mesh, step["seg_cap"])
        loss, acc, grads = collocated.lane_loss_and_grads(
            model, opt.params, blocks, x, lab, batch.num_output)
        red, rloss, racc, skip = collocated.reduce_weighted(
            mesh, grads, loss, acc, batch.num_output, of)
        opt.step(red, skip)
        results.append({
            "neigh": [b.neigh for b in batch.blocks],
            "num_src": [b.num_src for b in batch.blocks],
            "input_nodes": batch.input_nodes, "labels": lab,
            "num_output": batch.num_output, "loss": rloss, "skip": skip,
            "grads": dict(zip([k for k, _ in model.named_parameters()],
                              red)),
            "params": dict(model.state_dict())})
    return results


def engine_run(mesh, ds_arrays, config, epochs, evaluate=True):
    """MultiChipEngine's epochs and valid accuracy on this rank."""
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    ds = Dataset(**ds_arrays)
    eng = MultiChipEngine(ds, RunConfig(**config), mesh=mesh).init()
    caps0 = list(eng.capacities)
    rs = [eng.train_epoch(e) for e in range(epochs)]
    acc = eng.evaluate("valid") if evaluate else None
    params = {k: v for k, v in eng.model.state_dict().items()}
    return {"epochs": rs, "acc": acc, "caps0": caps0,
            "caps": list(eng.capacities), "params": params}


def run_printed(mesh, ds_arrays, config):
    """MultiChipEngine.run() on this rank: its epochs' losses, what it
    printed, whether it has a cold tier and a captured epoch, its solved
    config and whether it holds a placement plan."""
    import contextlib
    import io

    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    eng = MultiChipEngine(Dataset(**ds_arrays), RunConfig(**config),
                          mesh=mesh)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            out = eng.run()
    finally:
        # the mesh is the caller's: unmap the host arrays alone
        for held in (eng.host, None if eng.tier is None else eng.tier.csr):
            if held is not None:
                held.close()
    return {"epochs": [r["loss"] for r in out["epochs"]],
            "printed": printed.getvalue(), "tier": eng.tier is not None,
            "fused": eng._fused is not None, "config": eng.config,
            "plan": eng.placement_plan is not None}


def raise_on_rank1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 fails")
    return mesh.rank


def hang_on_rank1(mesh):
    import time

    if mesh.rank == 1:
        time.sleep(3600)
    return mesh.rank
