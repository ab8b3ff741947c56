"""The Force2Vec force-model family on torch tensors.

A port of ``force2vec_tpu/models/forces.py``: the same seven models, the
same metadata, and the same ``(xi, xj, inv_deg, step, rsum, mask)``
contract for every edge and sample force, with the reference citations
kept (sample/algorithms.cpp line numbers).  ``rsum`` reduces over the
embedding dimension (keepdim); ``mask`` zeroes the per-pair scalar
coefficient — a bool mask selects, a float 0/1 mask multiplies.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

# Gradient clamp bound (reference MAXBOUND, sample/algorithms.h:42).
MAXBOUND = 5.0


def _clamp(x):
    return torch.clamp(x, -MAXBOUND, MAXBOUND)


def _local_rsum(v):
    return torch.sum(v, dim=-1, keepdim=True)


def _mask1(coeff, mask):
    """Zero the per-pair scalar coefficient where ``mask`` is False; a zero
    coefficient survives the per-component clamp, so padded slots add
    exactly zero."""
    if mask is None:
        return coeff
    if mask.dtype == torch.bool:
        return torch.where(mask, coeff, 0.0)
    return coeff * mask


# -- edge (attraction) forces: (xi, xj, inv_deg_i, step) -> [.., D] ---------


def _tdist_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # d1 = -2/(1+||xi-xj||²); STEP·d1·diff (algorithms.cpp:598-612).  The
    # reference's clamp never binds on this term: 2|diff_c|/(1+a) ≤ 1.
    diff = xi - xj
    a = rsum(diff * diff)
    d1 = _mask1(step * -2.0 / (1.0 + a), mask)
    return d1 * diff


def _tdist_exact_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # clamp(d1·diff) - clamp(d2·diff) with d2 = 2/(a(1+a))
    # (algorithms.cpp:378-395)
    diff = xi - xj
    a = rsum(diff * diff)
    d1 = _mask1(-2.0 / (1.0 + a), mask)
    d2 = _mask1(2.0 / (a * (1.0 + a)), mask)
    return step * (_clamp(d1 * diff) - _clamp(d2 * diff))


def _sigmoid_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # STEP · degi · (1-σ(xi·xj)) · xj with degi = 1/(deg_i+1)
    # (algorithms.cpp:854-868)
    a = rsum(xi * xj)
    return step * inv_deg * _mask1(1.0 - torch.sigmoid(a), mask) * xj


def _fr_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # diff = xj - xi; w = a + 1/a if a>0 else 0  (algorithms.cpp:196-211)
    diff = xj - xi
    a = rsum(diff * diff)
    w = torch.where(a > 0.0, a + 1.0 / torch.where(a > 0.0, a, 1.0), 0.0)
    return _mask1(w, mask) * diff


def _linlog_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # w = log2(1 + sqrt(a))  (algorithms.cpp:290-303)
    diff = xj - xi
    a = rsum(diff * diff)
    w = torch.log2(1.0 + torch.sqrt(a))
    return _mask1(w, mask) * diff


def _forceatlas_edge(xi, xj, inv_deg, step, rsum=_local_rsum, mask=None):
    # w = sqrt(a) + 1/a if a>0 else 0  (algorithms.cpp:101-115)
    diff = xj - xi
    a = rsum(diff * diff)
    safe = torch.where(a > 0.0, a, 1.0)
    w = torch.where(a > 0.0, torch.sqrt(safe) + 1.0 / safe, 0.0)
    return _mask1(w, mask) * diff


# -- sample (repulsion) forces: (xi, s, step) -> [.., D] ---------------------


def _tdist_rep(xi, s, step, rsum=_local_rsum, mask=None):
    # d1 = 2/(r(1+r)); STEP·clamp(d1·diff)  (algorithms.cpp:614-627).  A
    # sample that coincides with the vertex (r = 0) has no direction, so
    # it adds zero (the reference gets the same from -ffast-math).
    diff = xi - s
    r = rsum(diff * diff)
    d1 = torch.where(r > 0.0, 2.0 / torch.where(r > 0.0, r * (1.0 + r), 1.0),
                     0.0)
    return step * _clamp(_mask1(d1, mask) * diff)


def _sigmoid_rep(xi, s, step, rsum=_local_rsum, mask=None):
    # -STEP·σ(xi·s)·s  (algorithms.cpp:898-911)
    r = rsum(xi * s)
    return -step * _mask1(torch.sigmoid(r), mask) * s


def _layout_rep(xi, s, step, rsum=_local_rsum, mask=None):
    # diff = s - xi; -(1/r)·diff, guarded r>0  (algorithms.cpp:117-128)
    diff = s - xi
    r = rsum(diff * diff)
    inv = torch.where(r > 0.0, 1.0 / torch.where(r > 0.0, r, 1.0), 0.0)
    return -_mask1(inv, mask) * diff


# -- separable edge forces: force = edge_coeff(a, invd, step) ⊗ edge_vec ----
# a is ||xi-xj||² ('dist2') or xi·xj ('dot'); the per-component clamp never
# binds on any edge form, so every edge force is one scalar per pair times
# one vector.  The CUDA edge kernel evaluates exactly this form.


def _tdist_coeff(a, invd, step):
    return step * -2.0 / (1.0 + a)


def _sigmoid_coeff(a, invd, step):
    return step * invd * (1.0 - torch.sigmoid(a))


def _fr_coeff(a, invd, step):
    return torch.where(a > 0.0, a + 1.0 / torch.where(a > 0.0, a, 1.0), 0.0)


def _linlog_coeff(a, invd, step):
    return torch.log2(1.0 + torch.sqrt(torch.clamp(a, min=0.0)))


def _forceatlas_coeff(a, invd, step):
    safe = torch.where(a > 0.0, a, 1.0)
    return torch.where(a > 0.0, torch.sqrt(safe) + 1.0 / safe, 0.0)


@dataclasses.dataclass(frozen=True)
class ForceModel:
    """Declarative description of one Force2Vec variant."""

    name: str
    edge_force: Callable  # (xi, xj, inv_deg_i, step) -> [.., D]
    sample_force: Callable  # (xi, s, step) -> [.., D]
    init: str  # 'uniform01' (randInit) | 'symmetric' (randInitF)
    update: str  # 'add' | 'energy'
    lr_schedule: str  # 'constant' | 'decay999'
    default_lr: float  # STEP at iteration 0
    uses_degree: bool = False
    attraction: str = "csr"  # 'csr' | 'walk'
    repulsion: str = "sampled"  # 'sampled' | 'all'
    neg_range: str = "global"  # 'global': [0, n-1) | 'prefix'
    a_kind: str = "dist2"  # 'dist2': a=||xi-xj||² | 'dot': a=xi·xj
    edge_coeff: Callable = None  # (a, invd, step) -> per-pair scalar
    edge_vec: str = "xi_minus_xj"  # 'xi_minus_xj' | 'xj_minus_xi' | 'xj'


FORCE_MODELS = {
    "tdist": ForceModel(
        name="tdist", edge_force=_tdist_edge, sample_force=_tdist_rep,
        init="symmetric", update="add", lr_schedule="constant",
        default_lr=0.02, a_kind="dist2", edge_coeff=_tdist_coeff,
        edge_vec="xi_minus_xj",
    ),
    "sigmoid": ForceModel(
        name="sigmoid", edge_force=_sigmoid_edge, sample_force=_sigmoid_rep,
        init="uniform01", update="add", lr_schedule="constant",
        default_lr=0.02, uses_degree=True, a_kind="dot",
        edge_coeff=_sigmoid_coeff, edge_vec="xj",
    ),
    "rwalk": ForceModel(
        name="rwalk", edge_force=_sigmoid_edge, sample_force=_sigmoid_rep,
        init="uniform01", update="add", lr_schedule="constant",
        default_lr=0.02, uses_degree=True, attraction="walk",
        neg_range="prefix", a_kind="dot", edge_coeff=_sigmoid_coeff,
        edge_vec="xj",
    ),
    "fr": ForceModel(
        name="fr", edge_force=_fr_edge, sample_force=_layout_rep,
        init="symmetric", update="energy", lr_schedule="decay999",
        default_lr=1.0, a_kind="dist2", edge_coeff=_fr_coeff,
        edge_vec="xj_minus_xi",
    ),
    "linlog": ForceModel(
        name="linlog", edge_force=_linlog_edge, sample_force=_layout_rep,
        init="symmetric", update="energy", lr_schedule="decay999",
        default_lr=1.0, a_kind="dist2", edge_coeff=_linlog_coeff,
        edge_vec="xj_minus_xi",
    ),
    "forceatlas": ForceModel(
        name="forceatlas", edge_force=_forceatlas_edge,
        sample_force=_layout_rep, init="symmetric", update="energy",
        lr_schedule="decay999", default_lr=1.0, a_kind="dist2",
        edge_coeff=_forceatlas_coeff, edge_vec="xj_minus_xi",
    ),
    "tdist_exact": ForceModel(
        name="tdist_exact", edge_force=_tdist_exact_edge,
        sample_force=_tdist_rep, init="symmetric", update="add",
        lr_schedule="decay999", default_lr=1.0, repulsion="all",
    ),
}

# CLI option numbers (Test/Force2Vec.cpp:129-188); 8-11 are the reference's
# AVX512 builds of 5/6/7 and alias them.
OPTION_TO_MODEL = {
    1: "tdist_exact",
    2: "fr",
    3: "linlog",
    4: "forceatlas",
    5: "tdist",
    6: "sigmoid",
    7: "rwalk",
    8: "tdist",
    9: "sigmoid",
    10: "rwalk",
    11: "tdist",
}


def get_model(name_or_option, sm_table: bool = False) -> ForceModel:
    """Look up a model by name or by reference CLI option number."""
    if sm_table:
        raise NotImplementedError("the sigmoid lookup-table mode is not ported")
    if isinstance(name_or_option, int):
        name_or_option = OPTION_TO_MODEL[name_or_option]
    return FORCE_MODELS[name_or_option]
