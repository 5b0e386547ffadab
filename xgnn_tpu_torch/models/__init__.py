from .gnn import GNN, GATConv, GCNConv, SAGEConv, build_model  # noqa: F401
