"""What each rank runs in tests/test_torch_port_dist_cold.py.

The ranks are processes of their own (``parallel.mesh.spawn``, gloo on the
CPU; at P = 1 the test process itself, a world of one), so these functions
import the port alone, never JAX: the test process holds their results
against the JAX package.
"""

import numpy as np
import torch

from xgnn_tpu_torch.config import RunConfig, SampleType
from xgnn_tpu_torch.parallel import collocated, dist_topology
from xgnn_tpu_torch.store.topology import MappedHostCSR, Tier


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _topo(csr, p, r, ncn, tier=True):
    """Rank ``r``'s part of the hot prefix ``[0, ncn)`` with the weighted
    tables, and its cold tier over the whole CSR (``tier``)."""
    tables = [_t(csr[n]) for n in ("prob", "alias", "prefix")]
    topo = dist_topology.partition_part(_t(csr["indptr"]).long(),
                                        _t(csr["indices"]), p, r, ncn,
                                        *tables)
    if tier and ncn < len(csr["indptr"]) - 1:
        topo.tier = Tier(ncn, MappedHostCSR(
            csr["indptr"], csr["indices"], prob_table=csr["prob"],
            alias_table=csr["alias"], prob_prefix_table=csr["prefix"]))
    return topo


def suite(mesh, data):
    """The tiered partitioned layers and walk on JAX's uniforms, the exact
    presample's counts over both topologies and, where asked, the tier's
    placement check and the engines; numpy results by name."""
    r, p = mesh.rank, mesh.size
    csr, ncn = data["csr"], data["ncn"]
    topo = _topo(csr, p, r, ncn)
    out = {}
    for st, case in data["layers"].items():
        out[f"layer_{st}"] = dist_topology.sample_layer_partitioned(
            topo, _t(case["frontier"][r]), case["fanout"], mesh,
            case["seg_cap"], SampleType(st), u=_t(case["u"][r]),
            coin=_t(case["coin"][r]) if "coin" in case else None)
    walk = data["walk"]
    out["walk"] = dist_topology.sample_random_walk_partitioned(
        topo, _t(walk["frontier"][r]), walk["fanout"], mesh, walk["seg_cap"],
        num_random_walk=walk["w"], random_walk_length=walk["l"],
        restart_prob=walk["p"],
        u=([_t(s) for s in walk["steps"][r]], _t(walk["restart"][r])))
    out["exact"] = exact_counts(mesh, data["exact"], csr)
    if "placement" in data:
        out["placement"] = placement(mesh, data["placement"], csr, ncn)
    if "engines" in data:
        out["engines"] = {name: engine_run(mesh, data["ds"], cfg)
                          for name, cfg in data["engines"].items()}
    return out


def exact_counts(mesh, case, csr):
    """The exact presample_static step's counts share over the batches,
    partitioned and replicated."""
    from xgnn_tpu_torch.types import Graph

    r, p = mesh.rank, mesh.size
    cfg = RunConfig(**case["config"])
    num_node = len(csr["indptr"]) - 1
    rows = -(-num_node // p)
    out = {}
    for name, dist_graph in (("partitioned", True), ("replicated", False)):
        topo = (_topo(csr, p, r, num_node) if dist_graph else Graph(
            indptr=_t(csr["indptr"].astype(np.int32)),
            indices=_t(csr["indices"])))
        step = collocated.make_presample_static_exact_step(
            cfg, mesh, num_node, case["seed_cap"], dist_graph)
        freq = torch.zeros(rows, dtype=torch.int32)
        for seeds, nums in zip(case["seeds"], case["nums"]):
            _, sizes = step(freq, topo, _t(seeds[r]), int(nums[r]))
        out[name] = (freq.numpy(), sizes.numpy())
    return out


def placement(mesh, case, csr, ncn):
    """Each sample type's minibatch with and without the cold tier on the
    same request-order uniforms: the blocks, inputs and flags of both."""
    r, p = mesh.rank, mesh.size
    num_node = len(csr["indptr"]) - 1
    out = {}
    for st in case["types"]:
        gen = torch.Generator().manual_seed(1000 + r)
        us = []
        for cap, k in zip(case["caps"], case["fanouts"]):
            width = 4 * k if st == "weighted_khop_hash_dedup" else k
            u = torch.rand((cap, width), generator=gen)
            coin = (torch.rand((cap, width), generator=gen)
                    if st.startswith("weighted_khop") and st != (
                        "weighted_khop_prefix") else None)
            us.append((u, coin))
        got = []
        for topo in (_topo(csr, p, r, num_node), _topo(csr, p, r, ncn)):
            b = dist_topology.sample_minibatch_partitioned(
                topo, _t(case["seeds"][r]), int(case["nums"][r]), mesh,
                seg_cap=case["seg_cap"], sample_type=SampleType(st),
                fanouts=case["fanouts"], capacities=case["caps"], u=us)
            got.append({"neigh": [blk.neigh for blk in b.blocks],
                        "num_src": [blk.num_src for blk in b.blocks],
                        "input_nodes": b.input_nodes,
                        "num_input": b.num_input, "overflow": b.overflow})
        out[st] = got
    return out


def engine_run(mesh, ds_arrays, config):
    """MultiChipEngine's three epochs, its valid accuracy and its tier."""
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    eng = MultiChipEngine(Dataset(**ds_arrays), RunConfig(**config),
                          mesh=mesh).init()
    try:
        rs = [eng.train_epoch(e) for e in range(3)]
        return {"epochs": rs, "acc": eng.evaluate("valid"),
                "caps0": config.get("frontier_capacities"),
                "caps": list(eng.capacities),
                "ncn": None if eng.tier is None else eng.tier.num_cache_node,
                "num_cache": eng.num_cache,
                "params": {k: v for k, v in eng.model.state_dict().items()}}
    finally:
        # the mesh is the caller's: unmap the host arrays alone
        for held in (eng.host, None if eng.tier is None else eng.tier.csr):
            if held is not None:
                held.close()
