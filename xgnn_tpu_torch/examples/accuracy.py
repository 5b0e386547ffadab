"""Full-graph accuracy of a trained checkpoint: the counterpart of the JAX
package's ``examples/accuracy.py``.

Restores a checkpoint written by ``python -m xgnn_tpu_torch.examples.train
--checkpoint-dir DIR`` and prints the valid and test accuracy of exact
layer-wise full-graph inference (``inference.evaluate_full``) as
``test_result:full_{valid,test}_acc`` lines.  The graph is the dataset
directory ``--root-path``/``--dataset``, or with ``--synthetic`` the JAX
command line's synthetic graph at its defaults (degree 15, planted signal
1.5) with ``--synthetic-nodes`` and ``--seed``, as the JAX package's
``examples/accuracy.py`` builds it: the training run's, where that run
kept those defaults.

    python -m xgnn_tpu_torch.examples.accuracy --cpu --synthetic \\
        --synthetic-nodes 20000 --fanout 8 4 --num-hidden 32 \\
        --checkpoint-dir /path/to/ckpt
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from .train import synthetic_dataset


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser("xgnn_tpu_torch full-graph accuracy")
    p.add_argument("--model", default="graphsage",
                   choices=["graphsage", "gcn", "gat", "pinsage"])
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--root-path", default="/graph-learning/samgraph/")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-nodes", type=int, default=100_000)
    p.add_argument("--num-hidden", type=int, default=256)
    p.add_argument("--num-head", type=int, default=1)
    p.add_argument("--fanout", nargs="+", type=int, default=[15, 10, 5])
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--cpu", action="store_true",
                   help="run the inference on the CPU")
    args = p.parse_args(argv)

    from xgnn_tpu_torch import RunConfig, load_dataset
    from xgnn_tpu_torch.checkpoint import CheckpointManager
    from xgnn_tpu_torch.device import resolve
    from xgnn_tpu_torch.inference import evaluate_full
    from xgnn_tpu_torch.models import build_model
    from xgnn_tpu_torch.train import Adam

    device = resolve("cpu" if args.cpu else None)
    if args.synthetic or args.dataset == "synthetic":
        ds = synthetic_dataset(args.synthetic_nodes, 15, 1.5, args.seed)
    else:
        ds = load_dataset(os.path.join(args.root_path, args.dataset))
    config = RunConfig(model=args.model, num_hidden=args.num_hidden,
                       num_head=args.num_head, num_layer=len(args.fanout),
                       fanout=tuple(args.fanout))
    model = build_model(config, ds.feat_dim, ds.num_class).to(device)
    opt = Adam(list(model.parameters()), config.lr,
               weight_decay=config.weight_decay)
    state, _ = CheckpointManager(args.checkpoint_dir).restore((model, opt))
    if state is None:
        print("no checkpoint found", file=sys.stderr)
        sys.exit(1)
    out = {}
    for split, nodes in (("valid", ds.valid_set), ("test", ds.test_set)):
        if len(nodes) == 0:
            continue
        out[split] = evaluate_full(model, ds.indptr, ds.indices, ds.feat,
                                   ds.label, nodes, device=device)
        print(f"test_result:full_{split}_acc={out[split]:.4f}")
    return out


if __name__ == "__main__":
    main()
