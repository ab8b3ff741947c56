"""Embedding quality evaluation — protocol parity with the reference's
``performancescores/`` scripts (SURVEY.md §2.4), fitted and scored in
torch on the device."""

from force2vec_tpu_torch.eval.linkpred import (link_prediction_scores,
                                               make_link_prediction_data)
from force2vec_tpu_torch.eval.nodeclass import (
    node_classification_scores,
    read_node_labels,
)
from force2vec_tpu_torch.eval.clustering import clustering_scores, modularity

__all__ = [
    "link_prediction_scores",
    "make_link_prediction_data",
    "node_classification_scores",
    "read_node_labels",
    "clustering_scores",
    "modularity",
]
