"""Graph container, the sync ELL layout and the bench graph generator."""

from force2vec_tpu_torch.graphs.csr import EllBucket, Graph, SyncLayout
from force2vec_tpu_torch.graphs.synth import synth_powerlaw_graph

__all__ = ["EllBucket", "Graph", "SyncLayout", "synth_powerlaw_graph"]
