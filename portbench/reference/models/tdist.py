"""tForce2Vec (reference option 5, ``model="tdist"``): what the reference
needs of the model, frozen from sample/algorithms.cpp:598-627.

* the default step: 0.02, constant; X's update adds each iteration's
  forces (the generic schedules of ``reference/force2vec.py``);
* the init: X uniform in [-1, 1) (randInitF);
* an edge adds ``-2·step / (1 + |x_i - x_j|²) · (x_i - x_j)``;
* a negative ``s`` adds ``step · clamp(2 / (r (1 + r)) · (x_i - s), ±5)``
  with ``r = |x_i - s|²``, 0 where ``r`` is 0;
* the operations of one force (``work.py``'s count): an edge ``5·dim +
  3`` (difference, squared norm, coefficient, scaled sum), a negative
  ``6·dim + 4`` (with the step and the clamp).
"""

from __future__ import annotations

import torch

DEFAULT_LR = 0.02
# X's element types this reference follows (the program's rounding of a
# 2-byte X is not frozen here)
X_DTYPES = ("float32",)
MAXBOUND = 5.0


def init(n: int, dim: int, generator: torch.Generator, device) -> torch.Tensor:
    """The initial X, ``[n, dim]`` f32 uniform in [-1, 1)."""
    x = torch.rand((n, dim), generator=generator, dtype=torch.float32,
                   device=device)
    return x.mul_(2.0).sub_(1.0)


def edge_force(xi, xj, step):
    diff = xi - xj
    a = (diff * diff).sum(dim=-1, keepdim=True)
    return (-2.0 * step / (1.0 + a)) * diff


def sample_force(xi, s, step):
    diff = xi - s
    r = (diff * diff).sum(dim=-1, keepdim=True)
    d1 = torch.where(r > 0, 2.0 / torch.where(r > 0, r * (1.0 + r), 1.0),
                     0.0)
    return step * torch.clamp(d1 * diff, -MAXBOUND, MAXBOUND)


def edge_ops(dim: int) -> int:
    return 5 * dim + 3


def sample_ops(dim: int) -> int:
    return 6 * dim + 4
