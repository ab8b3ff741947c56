"""force2vec_tpu_torch — the Force2Vec sync trainer on PyTorch and CUDA.

A port of ``force2vec_tpu`` (JAX, TPU) to PyTorch with hand-written CUDA
kernels for an NVIDIA H100 (sm_90a).  It imports neither JAX nor the JAX
package, which stays beside it as the reference the tests hold it to.

Quick start::

    from force2vec_tpu_torch import SyncForce2Vec, TrainConfig
    from force2vec_tpu_torch.graphs import synth_powerlaw_graph
    cfg = TrainConfig(dim=128, batch_size=256, gather_dtype="bfloat16")
    fv = SyncForce2Vec(synth_powerlaw_graph(), cfg, hub_width=128,
                       device="cuda")
    emb = fv.train(iters=100, seed=1)  # [n, 128] tensor on the card

A graph file in, an ``.embd`` out, scored on the card::

    from force2vec_tpu_torch import load_graph, write_embeddings
    from force2vec_tpu_torch.eval import link_prediction_scores
    g = load_graph("cora.mtx")
    emb = SyncForce2Vec(g, cfg, hub_width=128).train(iters=100)
    write_embeddings("cora.embd", emb)
    print(link_prediction_scores(g, emb))  # accuracy, F1, AUC
"""

from force2vec_tpu_torch.graphs import Graph, SyncLayout, load_graph, read_mtx
from force2vec_tpu_torch.graphs.io import read_embeddings, write_embeddings
from force2vec_tpu_torch.models.forces import get_model
from force2vec_tpu_torch.train.sync import SyncForce2Vec
from force2vec_tpu_torch.train.trainer import TrainConfig

__all__ = [
    "Graph",
    "SyncLayout",
    "load_graph",
    "read_mtx",
    "read_embeddings",
    "write_embeddings",
    "get_model",
    "TrainConfig",
    "SyncForce2Vec",
]
