"""Train a GNN with the PyTorch port: the counterpart of the JAX package's
``examples/train.py``, with its flags.

It prints the ``config:`` lines, then ``Engine.run()``'s ``test_result:``
lines.  ``--dataset NAME --root-path DIR`` loads the dataset directory
``DIR/NAME`` (``load_dataset``).  ``--synthetic`` builds the JAX command
line's graph on the host (``synthetic.make_synthetic_dataset``:
``--synthetic-nodes`` nodes, ``--synthetic-degree`` draws a node,
symmetrised; 128 features, 32 classes, the planted signal
``--synthetic-signal``, RMAT draws with ``--synthetic-rmat``; alias tables
for a weighted ``--sample-type``).  ``--cpu`` runs everything on the CPU.
``--use-dist-graph --dist-graph-percentage P`` trains on the tiered
topology, and ``--auto-placement [--hbm-budget-gb G]`` solves the store's
split.  ``--arch arch6`` (or ``--num-worker N`` with N > 1, as JAX's
command line decides) trains the collocated multi-card engine
(``MultiChipEngine``) over N ranks, one process a card (``--cpu``: N
processes on gloo), the topology replicated or, with ``--use-dist-graph``,
partitioned (with ``--dist-graph-percentage P`` < 1 its hot prefix, the
cold rows read from pinned host memory), the features all on the cards
or, with ``--cache-percentage`` in (0, 1), XGNN's two-phase store (a cache
partitioned over the cards with ``--part-cache``, else replicated on each;
the misses read from pinned host memory; any ``--cache-policy``,
``presample_static`` among them); rank 0's lines are printed.
``--num-dcn-groups G`` splits the N ranks into G DCN groups of N / G
(the stores partitioned over a group and repeated in every group, the
gradients reduced over all N), and ``--auto-placement`` solves the
collocated engine's split for a group's cards (``--hbm-budget-gb`` on the
CPU).  ``--device-loop`` runs the collocated engine's epochs as a captured
step too.  ``--arch arch5`` (or ``--num-sample-worker N`` with N > 0, as JAX's
command line decides) trains the disaggregated engine
(``DisaggregatedEngine``): N sampler roles (at least 1) feeding
``--num-train-worker`` trainer roles, on every card, sharing them
round-robin where the roles outnumber the cards (``--cpu``: each role on
the CPU).  GAT with more heads than K5's kernel keeps raises
``NotImplementedError`` naming its ROADMAP item, before any data is built.

    python -m xgnn_tpu_torch.examples.train --cpu --synthetic \\
        --synthetic-nodes 20000 --model graphsage --num-epoch 2 \\
        --batch-size 500 --fanout 8 4 --num-hidden 32 --report-acc 1
    python -m xgnn_tpu_torch.examples.train --dataset products \\
        --root-path /data --num-epoch 2
    python -m xgnn_tpu_torch.examples.train --cpu --synthetic \\
        --synthetic-nodes 20000 --arch arch6 --num-worker 2 --part-cache \\
        --use-dist-graph --num-epoch 2 --batch-size 500 --fanout 8 4
    python -m xgnn_tpu_torch.examples.train --cpu --synthetic \\
        --synthetic-nodes 20000 --arch arch6 --num-worker 2 --part-cache \\
        --use-dist-graph --cache-percentage 0.2 --num-epoch 2 \\
        --batch-size 500 --fanout 8 4
    python -m xgnn_tpu_torch.examples.train --cpu --synthetic \\
        --synthetic-nodes 20000 --num-worker 2 --part-cache \\
        --use-dist-graph --dist-graph-percentage 0.85 --num-epoch 2 \\
        --batch-size 500 --fanout 8 4
    python -m xgnn_tpu_torch.examples.train --cpu --synthetic \\
        --synthetic-nodes 20000 --num-worker 4 --num-dcn-groups 2 \\
        --part-cache --use-dist-graph --cache-percentage 0.2 \\
        --num-epoch 2 --batch-size 500 --fanout 8 4
    python -m xgnn_tpu_torch.examples.train --synthetic \\
        --synthetic-nodes 20000 --num-worker 2 --part-cache \\
        --auto-placement --num-epoch 2 --batch-size 500 --fanout 8 4
    python -m xgnn_tpu_torch.examples.train --cpu --synthetic \\
        --synthetic-nodes 20000 --arch arch5 --num-sample-worker 2 \\
        --num-train-worker 2 --num-epoch 2 --batch-size 500 --fanout 8 4
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

FEAT_DIM, NUM_CLASS = 128, 32  # the JAX command line's synthetic graph
WIDE_ROWS = "ROADMAP section 2, K5, 'Wide rows'"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("xgnn_tpu_torch training")
    p.add_argument("--model", default="graphsage",
                   choices=["graphsage", "gcn", "gat", "pinsage", "mlp"])
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--arch", default=None,
                   choices=["arch1", "arch2", "arch3", "arch4", "arch5",
                            "arch6", "arch7", "single", "collocated",
                            "disaggregated"],
                   help="default: collocated (arch6) when --num-worker > 1, "
                   "else single")
    p.add_argument("--root-path", default="/graph-learning/samgraph/")
    p.add_argument("--synthetic", action="store_true",
                   help="the JAX command line's synthetic graph, built on "
                   "the host (no dataset directory)")
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--synthetic-degree", type=int, default=15,
                   help="endpoint draws a node, before symmetrising")
    p.add_argument("--synthetic-signal", type=float, default=1.5,
                   help="planted label signal (0: none)")
    p.add_argument("--synthetic-rmat", action="store_true",
                   help="RMAT endpoint draws instead of power-law ones")
    p.add_argument("--sample-type", default="khop3",
                   choices=["khop0", "khop1", "khop2", "khop3",
                            "weighted_khop", "weighted_khop_prefix",
                            "weighted_khop_hash_dedup", "random_walk"])
    p.add_argument("--fanout", nargs="+", type=int, default=[15, 10, 5])
    p.add_argument("--batch-size", type=int, default=8000)
    p.add_argument("--num-epoch", type=int, default=10)
    p.add_argument("--num-hidden", type=int, default=256)
    p.add_argument("--num-head", type=int, default=1,
                   help="GAT attention heads (hidden layers)")
    p.add_argument("--lr", type=float, default=0.003)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--cache-policy", default="pre_sample",
                   choices=["degree", "heuristic", "pre_sample", "degree_hop",
                            "presample_static", "fake_optimal",
                            "dynamic_cache", "random"])
    p.add_argument("--cache-percentage", type=float, default=0.0)
    p.add_argument("--presample-epoch", type=int, default=1)
    p.add_argument("--num-worker", type=int, default=1)
    p.add_argument("--num-sample-worker", type=int, default=0)
    p.add_argument("--num-train-worker", type=int, default=1)
    p.add_argument("--num-dcn-groups", type=int, default=1,
                   help="DCN groups of the --num-worker ranks: the stores "
                   "partitioned over a group, repeated across groups")
    p.add_argument("--use-dist-graph", action="store_true", default=False)
    p.add_argument("--dist-graph-percentage", type=float, default=1.0)
    p.add_argument("--part-cache", action="store_true", default=False)
    p.add_argument("--auto-placement", action="store_true", default=False)
    p.add_argument("--hbm-budget-gb", type=float, default=None)
    p.add_argument("--pipeline", action="store_true", default=False)
    p.add_argument("--no-pipeline", dest="pipeline", action="store_false")
    p.add_argument("--device-loop", action="store_true", default=False,
                   help="each step one replay of a captured CUDA graph")
    p.add_argument("--report-acc", type=int, default=0)
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=1)
    p.add_argument("--validate-configs", action="store_true",
                   help="exit after printing the resolved config")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("-pl", "--profile-level", type=int, default=0,
                   help="taken as the JAX command line takes it; no level "
                   "changes what is logged")
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--gpu-extract", dest="gpu_extract", action="store_true",
                   default=True)
    p.add_argument("--no-gpu-extract", dest="gpu_extract",
                   action="store_false")
    p.add_argument("--agg-impl", default=None, choices=["loop", "tiled"])
    p.add_argument("--remat", action="store_true", default=False)
    p.add_argument("--feat-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"])
    return p


def arch_of(args):
    """The engine the flags select, as JAX's command line decides it (an
    explicit ``--arch`` wins)."""
    from xgnn_tpu_torch.config import ARCH_ALIASES, RunArch

    if args.arch is not None:
        return ARCH_ALIASES[args.arch]
    if args.num_sample_worker > 0:
        return RunArch.DISAGGREGATED
    return RunArch.COLLOCATED if args.num_worker > 1 else RunArch.SINGLE


def check_ported(args):
    """Refuse the flags of paths the port does not have: GAT with more
    heads than K5 keeps, which its kernel and its plain version refuse
    alike (here before any data is built)."""
    from xgnn_tpu_torch.ops.attend import MAX_HEADS

    if args.model == "gat" and args.num_head > MAX_HEADS:
        raise NotImplementedError(
            f"not ported to xgnn_tpu_torch yet: GAT with {args.num_head} "
            f"heads (--num-head > {MAX_HEADS}): {WIDE_ROWS}")


def synthetic_dataset(num_node: int, avg_degree: int, signal: float,
                      seed: int, rmat: bool = False,
                      sample_type: str = "khop3"):
    """The JAX command line's ``--synthetic`` graph, on the host, with the
    tables that a weighted ``sample_type`` reads."""
    from xgnn_tpu_torch import synthetic

    ds = synthetic.make_synthetic_dataset(
        num_node=num_node, avg_degree=avg_degree, feat_dim=FEAT_DIM,
        num_class=NUM_CLASS, planted_signal=signal,
        power_law="rmat" if rmat else True, seed=seed)
    if sample_type.startswith("weighted"):
        synthetic.build_alias_tables(ds)
    return ds


def load(args, config):
    """The dataset the flags name: the ``--synthetic`` graph, or the
    directory ``config.dataset_path``."""
    if args.synthetic or args.dataset == "synthetic":
        return synthetic_dataset(args.synthetic_nodes, args.synthetic_degree,
                                 args.synthetic_signal, args.seed,
                                 args.synthetic_rmat, args.sample_type)
    from xgnn_tpu_torch import load_dataset

    return load_dataset(config.dataset_path)


def config_of(args):
    from xgnn_tpu_torch import RunConfig

    if args.sample_type == "random_walk" and args.model != "pinsage":
        print("warning: random_walk sampling is the pinsage path; "
              "forcing --model pinsage", file=sys.stderr)
        args.model = "pinsage"
    if args.model == "pinsage":
        args.sample_type = "random_walk"
    extra = {k: v for k, v in (("agg_impl", args.agg_impl),
                               ("feat_dtype", args.feat_dtype),
                               ("compute_dtype", args.compute_dtype))
             if v is not None}
    return RunConfig(
        model=args.model, dataset=args.dataset, root_path=args.root_path,
        **extra, arch=arch_of(args), sample_type=args.sample_type,
        fanout=tuple(args.fanout), num_layer=len(args.fanout),
        batch_size=args.batch_size, num_epoch=args.num_epoch,
        num_worker=args.num_worker, num_dcn_groups=args.num_dcn_groups,
        num_sample_worker=max(args.num_sample_worker, 1),
        num_train_worker=args.num_train_worker,
        part_cache=args.part_cache,
        num_hidden=args.num_hidden, num_head=args.num_head, lr=args.lr,
        dropout=args.dropout, cache_policy=args.cache_policy,
        cache_percentage=args.cache_percentage,
        use_dist_graph=args.use_dist_graph,
        dist_graph_percentage=args.dist_graph_percentage,
        auto_placement=args.auto_placement, hbm_budget_gb=args.hbm_budget_gb,
        presample_epoch=args.presample_epoch, pipeline=args.pipeline,
        gpu_extract=args.gpu_extract, device_loop=args.device_loop,
        remat=args.remat, report_acc=args.report_acc,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, seed=args.seed,
        prefetch_depth=args.prefetch_depth,
    )


def _train(engine, report_acc: int):
    engine.run()
    if report_acc:
        acc = engine.evaluate("test")
        if getattr(engine, "rank", 0) == 0:
            print(f"test_result:test_acc={acc:.4f}")


def _rank_main(mesh, argv):
    """One rank of the multi-card command line: its own dataset and
    engine; returns what it printed (only rank 0 prints)."""
    import contextlib
    import io

    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine

    args = parser().parse_args(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        config = config_of(args)
        engine = MultiChipEngine(load(args, config), config, mesh=mesh)
        _train(engine, args.report_acc)
    return out.getvalue() if mesh.rank == 0 else ""


def main(argv: Optional[Sequence[str]] = None):
    """Train as the flags say; returns the engine after ``run()`` (None
    when the ranks ran in processes of their own)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser().parse_args(argv)
    check_ported(args)
    from xgnn_tpu_torch import Engine
    from xgnn_tpu_torch.config import RunArch

    config = config_of(args)
    config.print_run_config()
    if args.validate_configs:
        return None
    device = "cpu" if args.cpu else None
    if config.arch == RunArch.DISAGGREGATED:
        from xgnn_tpu_torch.engine.disagg_engine import DisaggregatedEngine

        engine = DisaggregatedEngine(load(args, config), config,
                                     device=device)
        try:
            _train(engine, args.report_acc)
        finally:
            engine.close()
        return engine
    if config.arch != RunArch.COLLOCATED:
        engine = Engine(load(args, config), config, device=device)
        _train(engine, args.report_acc)
        return engine
    from xgnn_tpu_torch.engine.multi_engine import MultiChipEngine
    from xgnn_tpu_torch.parallel.mesh import spawn

    if config.num_worker == 1:
        engine = MultiChipEngine(load(args, config), config, device=device)
        try:
            _train(engine, args.report_acc)
        finally:
            engine.close()
        return engine
    outs = spawn(_rank_main, config.num_worker, argv, device=device,
                 timeout=None)
    print(outs[0], end="")
    return None


if __name__ == "__main__":
    main()
