"""Graph container, the sync ELL layout, the bench graph generator and
graph/embedding IO."""

from force2vec_tpu_torch.graphs.csr import EllBucket, Graph, SyncLayout
from force2vec_tpu_torch.graphs.io import (
    load_graph,
    read_binary_csr,
    read_edgelist,
    read_embeddings,
    read_mtx,
    write_embeddings,
)
from force2vec_tpu_torch.graphs.synth import synth_powerlaw_graph

__all__ = [
    "EllBucket",
    "Graph",
    "SyncLayout",
    "synth_powerlaw_graph",
    "load_graph",
    "read_mtx",
    "read_edgelist",
    "read_binary_csr",
    "read_embeddings",
    "write_embeddings",
]
