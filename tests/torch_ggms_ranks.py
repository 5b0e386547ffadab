"""What each rank runs in tests/test_torch_port_ggms.py.

The ranks are processes of their own (``parallel.mesh.spawn``, gloo on the
CPU), so these functions import the port alone, never JAX: the test
process holds their results against the JAX package.  Tensors of 2-byte
floats come back as their uint16 bits (numpy has no bfloat16).
"""

import numpy as np
import torch

from xgnn_tpu_torch.config import RunConfig
from xgnn_tpu_torch.constants import EMPTY_KEY as EMPTY
from xgnn_tpu_torch.ops.tiered import MappedHostTable, tiered_direct
from xgnn_tpu_torch.parallel import collocated, dist_topology, ggms

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits(t):
    """A tensor as numpy, 2-byte floats as their uint16 bits."""
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def suite(mesh, data):
    """The split and the reads for each case, the presample's counts and,
    where asked, the engines; numpy results by name."""
    out = {"split": {name: split_case(mesh, data, case)
                     for name, case in data["split"].items()},
           "presample": presample_case(mesh, data)}
    if "engines" in data:
        out["engines"] = engine_cases(mesh, data["ds"], data["engines"])
    return out


def split_case(mesh, data, case):
    """``cache_split`` then K11's reads (``tiered_direct``), and the plain
    ``combine_miss`` over the rows gathered on the host, on this rank's
    ids."""
    r, p = mesh.rank, mesh.size
    host = MappedHostTable(data["feat"][case["host"]], "cpu")
    dtype = DTYPES[case["cache"]]
    parts = p if case["partitioned"] else 1
    posmap, cache_part, _ = ggms.build_cache(
        host, data["ranking"], data["pct"], parts,
        r if case["partitioned"] else 0, "cpu", dtype)
    ids = _t(data["ids"][r])
    hit_rows, miss_ids, miss_pos, counts, of = ggms.cache_split(
        posmap, cache_part, ids, ids.shape[0], mesh, case["seg_cap"], host,
        case["partitioned"])
    num_miss = int(counts[1])
    plain = ggms.combine_miss(hit_rows, host.tensor[miss_ids[:num_miss]
                                                    .long()],
                              miss_pos, num_miss)
    x = tiered_direct(hit_rows.clone(), miss_ids, miss_pos, counts, host)
    return {"x": bits(x), "plain": bits(plain), "counts": counts.numpy(),
            "overflow": bool(of), "cache_part": bits(cache_part)}


def presample_case(mesh, data):
    """The presample step's counts over a few batches of this rank on the
    partitioned topology, and each batch's inputs sampled again from the
    same generators."""
    r, p = mesh.rank, mesh.size
    pre = data["presample"]
    cfg = RunConfig(**pre["config"])
    csr = data["csr"]
    topo = dist_topology.partition_part(_t(csr["indptr"]).long(),
                                        _t(csr["indices"]), p, r)
    step = collocated.make_presample_step(cfg, mesh, pre["caps"],
                                          pre["seg_cap"], True)
    freq = torch.zeros(-(-csr["num_node"] // p), dtype=torch.int32)
    inputs, sizes = [], []
    for b, (seeds, nums) in enumerate(zip(pre["seeds"], pre["nums"])):
        s, n = _t(seeds[r]), int(nums[r])
        _, size = step(freq, topo, s, n,
                       torch.Generator().manual_seed(1000 * b + r))
        batch = collocated.sample_any(
            topo, s, n, cfg, pre["caps"], pre["seg_cap"], mesh, True,
            torch.Generator().manual_seed(1000 * b + r))
        inputs.append(batch.input_nodes[:int(batch.num_input)].numpy())
        sizes.append((size.numpy(), int(batch.num_output),
                      [int(blk.num_src) for blk in reversed(batch.blocks)]))
    return {"freq": freq.numpy(), "inputs": inputs, "sizes": sizes}


def engine_cases(mesh, ds_arrays, cases):
    """Each named engine's epochs; ``hits`` recounts this rank's hits and
    valid inputs from the posmap over each step's batch, sampled again from
    the step's generator."""
    return {name: engine_case(mesh, ds_arrays, case)
            for name, case in cases.items()}


def engine_case(mesh, ds_arrays, case):
    from xgnn_tpu_torch.dataset import Dataset
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    eng = MultiChipEngine(Dataset(**ds_arrays), RunConfig(**case["config"]),
                          mesh=mesh).init()
    cfg = eng.config
    out = {"caps0": list(eng.capacities)}
    if eng.two_phase:
        out["posmap0"] = eng.posmap.clone().numpy()
    rs = [eng.train_epoch(e) for e in range(case["epochs"])]
    out.update(epochs=rs, caps=list(eng.capacities),
               losses=[eng.history[e]["loss"] for e in range(len(rs))])
    if eng.two_phase:
        out["posmap"] = eng.posmap.numpy()
        out["counts"] = [(eng.history[e]["hit"], eng.history[e]["miss"])
                         for e in range(len(rs))]
    if case.get("recount"):
        # the last epoch's batches again, looked up in the posmap that
        # served them (no refresh ran after it)
        epoch = len(rs) - 1
        it = eng._shuffler(eng.ds.train_set, cfg.seed + 1).epoch_batches(
            epoch)
        hits = total = 0
        for step in range(rs[-1]["steps"]):
            seeds, n = eng._next(it)
            batch = collocated.sample_any(
                eng.topo, seeds, n, cfg, eng.capacities, eng.seg_cap,
                eng.mesh, cfg.use_dist_graph,
                eng._generators(epoch, step)[0])
            ids = batch.input_nodes[:int(batch.num_input)].long()
            hits += int((eng.posmap[ids] != EMPTY).sum())
            total += ids.shape[0]
        out["recount"] = (hits, total)
    if case.get("evaluate"):
        out["acc"] = eng.evaluate("valid")
    return out
