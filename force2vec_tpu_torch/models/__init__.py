"""Force models."""

from force2vec_tpu_torch.models.forces import FORCE_MODELS, ForceModel, get_model

__all__ = ["FORCE_MODELS", "ForceModel", "get_model"]
