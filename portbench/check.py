"""The comparison that decides ``correct``.

Set-up drives the program through a run's first ``CHECKED`` iterations by
the window's own call (``run_span``, one iteration a call) and keeps X, as
the program returns it (``unpad_embedding``: ``[n, dim]`` in vertex
order), after each.  Once the window has closed and the program's state is
freed, the reference (``reference/force2vec.py``) runs the same
iterations from the same initial X and seed, and each iteration's update
``X_k - X_{k-1}`` of the program is held to the reference's:

* ``upd_err``: ``|dP - dR| / |dR|`` over all of X (Frobenius norms), the
  worst of the iterations;
* ``row_err``: the worst row's ``|dP_r - dR_r|``, over the larger of
  ``|dR_r|`` and the median row's ``|dR|``, the worst of the iterations:
  a fault confined to a few rows (a hub's owner sums, one bucket, one
  group's negatives) shows here where the whole-X norm dilutes it.

Each has its limit in ``cells/<cell>.json``, set from the readings of
sound runs, of the control (the program with X held in bf16) and of the
faults ``calibrate.py`` plants in the program's place.  A
reading that is not a finite number fails.
"""

from __future__ import annotations

import math

import torch

CHECKED = 3
NUMBERS = ("upd_err", "row_err")


def _finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def readings(x0, program: list, reference: list, device) -> list:
    """Per checked iteration, ``{"upd_err": .., "row_err": ..}``; ``x0``
    and the lists' X are host ``[n, dim]`` tensors."""
    out = []
    prev_p = prev_r = x0
    for p, r in zip(program, reference, strict=True):
        dp = p.to(device, torch.float64) - prev_p.to(device, torch.float64)
        dr = r.to(device, torch.float64) - prev_r.to(device, torch.float64)
        gap = torch.linalg.vector_norm(dp - dr, dim=1)
        ref = torch.linalg.vector_norm(dr, dim=1)
        floor = torch.clamp(ref, min=float(ref.median()))
        out.append({
            "upd_err": _finite(float(torch.linalg.vector_norm(gap)
                                     / torch.linalg.vector_norm(ref))),
            "row_err": _finite(float((gap / floor).max())),
        })
        prev_p, prev_r = p, r
    return out


def judge(per_iter: list, limits: dict) -> tuple:
    """``(correct, failed, worst)``: whether every reading is within its
    limit, how many checked iterations had one over, and each number's
    worst reading."""
    worst = {k: max(r[k] for r in per_iter) for k in NUMBERS}
    failed = sum(any(not r[k] <= limits[k] for k in NUMBERS)
                 for r in per_iter)
    return failed == 0 and len(per_iter) == CHECKED, failed, worst
