from .gnn import GNN, SAGEConv, build_model  # noqa: F401
