"""Training: hyperparameters and the epoch-synchronous trainer."""

from force2vec_tpu_torch.train.sync import SyncForce2Vec
from force2vec_tpu_torch.train.trainer import TrainConfig

__all__ = ["SyncForce2Vec", "TrainConfig"]
