"""Training hyperparameters, shared with ``force2vec_tpu/train/trainer.py``.

Only ``TrainConfig`` is ported so far; the batch-sequential trainer is not.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from force2vec_tpu_torch.models.forces import ForceModel


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (CLI-flag parity noted per field)."""

    dim: int = 128  # -dim
    batch_size: int = 384  # -batch
    model: str = "tdist"  # -option (see models.forces.OPTION_TO_MODEL)
    ns: int = 5  # -nsamples
    lr: Optional[float] = None  # -lr (None → model default)
    per_vertex_samples: bool = False  # -bs 1
    walk_length: int = 5  # WALKLENGTH (sample/algorithms.cpp:1073)
    edge_chunk: Optional[int] = None  # batch trainer's edge-tile size
    rep_chunk: int = 512  # row-tile for exact O(n²) repulsion
    segment_mode: str = "matmul"  # batch trainer's segment reduction
    dtype: str = "float32"
    # Low-precision replica of X for the neighbour and sample gathers
    # ('bfloat16' halves the gather bytes); the force math and the apply
    # stay in ``dtype``.  None gathers from X itself.
    gather_dtype: Optional[str] = None
    sm_table: bool = False  # sigmoid lookup-table parity mode (not ported)

    def resolve_lr(self, model: ForceModel) -> float:
        return model.default_lr if self.lr is None else self.lr
