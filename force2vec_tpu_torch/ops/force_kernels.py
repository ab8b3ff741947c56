"""The force kernels of the sync iteration: CUDA wrappers and plain versions.

The counterpart of ``force2vec_tpu/ops/pallas_force.py``:

* ``ell_edge_force`` (``csrc/ell_edge_force.cu``): the attraction over an
  ELL bucket or over the walk table; it replaces ``ell_force_mxu`` and
  ``ell_force`` with kind ``edge`` (the same function);
* ``grouped_rep_force`` (``csrc/grouped_rep_force.cu``): the repulsion
  from group-shared negatives; it replaces ``grouped_rep_force``;
* ``ell_sample_force`` (``csrc/ell_sample_force.cu``): the repulsion from
  per-row negatives (``-bs 1``); it replaces ``ell_force`` with kind
  ``sample``.

Each kernel has

* a wrapper, which checks its inputs and, for CUDA tensors, launches the
  hand-written kernel from ``csrc/`` (built at first use by ``_build``) and
  raises if the launch fails; for CPU tensors it runs the plain version;
* a plain PyTorch version of the same function, the reference the kernel is
  held against on the card;
* a launch count in ``launch_counts``, raised by one per kernel launch and
  by nothing else.

A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from force2vec_tpu_torch.models import forces
from force2vec_tpu_torch.models.forces import ForceModel
from force2vec_tpu_torch.ops import _build

launch_counts = {"ell_edge_force": 0, "grouped_rep_force": 0,
                 "ell_sample_force": 0}

# model ids of csrc/ell_edge_force.cu (EdgeModel) and of the two repulsion
# kernels (csrc/common.cuh::SampleModel)
_EDGE_MODEL_IDS = {
    forces._tdist_coeff: 0,
    forces._sigmoid_coeff: 1,
    forces._fr_coeff: 2,
    forces._linlog_coeff: 3,
    forces._forceatlas_coeff: 4,
}
_SAMPLE_MODEL_IDS = {
    forces._tdist_rep: 0,
    forces._sigmoid_rep: 1,
    forces._layout_rep: 2,
}
_KERNEL_DIM = 128  # csrc/common.cuh::kDim
_GATHER_DTYPES = (torch.bfloat16, torch.float32)
_MAX_SAMPLE_SMEM = 48 * 1024  # bytes of f32 samples a block may hold


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check(name, t, dtypes, ndim, device):
    _require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _require(t.dtype in dtypes, f"{name}: dtype {t.dtype} not in {dtypes}")
    _require(t.dim() == ndim, f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    _require(t.device == device, f"{name} on {t.device}, expected {device}")
    _require(t.is_contiguous(), f"{name} must be contiguous")


def _check_cuda_operands(dim, *tensors):
    _require(dim == _KERNEL_DIM,
             f"the CUDA kernels take dim {_KERNEL_DIM}, got {dim}")
    for t in tensors:
        # vector loads of whole row pieces need 16-byte aligned row bases
        _require(t.data_ptr() % 16 == 0, "CUDA operands must be 16-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# -- attraction over one ELL bucket ------------------------------------------


def ell_edge_force_terms(model: ForceModel, x, xg, nbr, deg, xi_row, invd,
                         step) -> torch.Tensor:
    """[C, K, D] edge_force(x[i], xg[nbr[r, k]]) per slot, i = xi_row[r], in
    f32 and exactly 0 in the padded slots k ≥ deg[r]."""
    rows = xi_row.long()
    xi = x[rows]
    xj = xg[nbr.long()].float()  # [C, K, D]
    k = nbr.shape[1]
    mask = (torch.arange(k, device=nbr.device)[None, :]
            < deg[:, None])[:, :, None]
    return model.edge_force(xi[:, None, :], xj, invd[rows][:, None, None],
                            step, mask=mask)


def ell_edge_force_plain(model: ForceModel, x, xg, nbr, deg, xi_row, invd,
                         step) -> torch.Tensor:
    """out[r] = Σ_{k<deg[r]} edge_force(x[i], xg[nbr[r, k]]), i = xi_row[r]:
    the gather, the model's edge force in f32 and a masked sum over K."""
    return ell_edge_force_terms(model, x, xg, nbr, deg, xi_row, invd,
                                step).sum(dim=1)


def ell_edge_force(model: ForceModel, x, xg, nbr, deg, xi_row, invd, step,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked edge-force sum over one ELL bucket, gathering in the kernel.

    x [n_pad, D] f32; xg [n_pad, D] bf16 or f32 gather replica of x;
    nbr [C, K] int32 neighbour rows; deg [C] int32 valid slots per row;
    xi_row [C] int32 table row whose x and invd each bucket row uses (the
    bucket's own rows, or the owners of hub virtual rows); invd [n_pad] f32;
    step a float.  Writes into ``out`` [C, D] f32 if given; returns it.
    The kernel does not bounds-check ``nbr`` or ``xi_row``: they must index
    rows of ``x`` (``SyncLayout`` builds them so).
    """
    _require(model.edge_coeff in _EDGE_MODEL_IDS,
             f"{model.name} has no separable edge force")
    dev = x.device
    _check("x", x, (torch.float32,), 2, dev)
    _check("xg", xg, _GATHER_DTYPES, 2, dev)
    _check("nbr", nbr, (torch.int32,), 2, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    _check("xi_row", xi_row, (torch.int32,), 1, dev)
    _check("invd", invd, (torch.float32,), 1, dev)
    n_pad, dim = x.shape
    c, k = nbr.shape
    _require(xg.shape == x.shape, f"xg {tuple(xg.shape)} != x {tuple(x.shape)}")
    _require(deg.shape == (c,) and xi_row.shape == (c,),
             "deg and xi_row must have one entry per bucket row")
    _require(invd.shape == (n_pad,), "invd must have one entry per table row")
    if out is None:
        out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check("out", out, (torch.float32,), 2, dev)
    _require(out.shape == (c, dim), f"out {tuple(out.shape)} != {(c, dim)}")
    if dev.type == "cpu":
        out.copy_(ell_edge_force_plain(model, x, xg, nbr, deg, xi_row, invd,
                                       step))
        return out
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(dim, x, xg, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_ell_edge_force(
            x.data_ptr(), xg.data_ptr(), int(xg.dtype == torch.bfloat16),
            nbr.data_ptr(), deg.data_ptr(), xi_row.data_ptr(),
            invd.data_ptr(), float(step), out.data_ptr(), c, k, dim,
            _EDGE_MODEL_IDS[model.edge_coeff], _stream(dev))
    _build.check(lib, "ell_edge_force", err)
    launch_counts["ell_edge_force"] += 1
    return out


# -- repulsion from group-shared samples ---------------------------------------


def grouped_rep_force_terms(model: ForceModel, group: int, xi, sg,
                            step) -> torch.Tensor:
    """[C, ns, D] sample_force(xi[r], sg[r // group, s]) per sample, in f32."""
    gid = torch.arange(xi.shape[0], device=xi.device) // group
    s = sg[gid].float()  # [C, ns, D]
    return model.sample_force(xi[:, None, :], s, step)


def grouped_rep_force_plain(model: ForceModel, group: int, xi, sg,
                            step) -> torch.Tensor:
    """out[r] = Σ_s sample_force(xi[r], sg[r // group, s]): the group
    expand, the model's sample force in f32 and a sum over ns."""
    return grouped_rep_force_terms(model, group, xi, sg, step).sum(dim=1)


def grouped_rep_force(model: ForceModel, group: int, xi, sg,
                      step) -> torch.Tensor:
    """Grouped-negative repulsion with the group expand kept on chip.

    xi [C, D] f32, row r in group r // group; sg [ng, ns, D] bf16 or f32
    per-group sample rows, ng ≥ ceil(C / group); step a float.
    Returns [C, D] f32.
    """
    _require(model.sample_force in _SAMPLE_MODEL_IDS,
             f"{model.name} has no grouped sample force")
    _require(isinstance(group, int) and group > 0, f"bad group {group!r}")
    dev = xi.device
    _check("xi", xi, (torch.float32,), 2, dev)
    _check("sg", sg, _GATHER_DTYPES, 3, dev)
    c, dim = xi.shape
    ng, ns, sdim = sg.shape
    _require(sdim == dim, f"sg dim {sdim} != xi dim {dim}")
    _require(ng * group >= c, f"{ng} groups of {group} cover fewer than {c} rows")
    if dev.type == "cpu":
        return grouped_rep_force_plain(model, group, xi, sg, step)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(ns > 0 and ns * dim * 4 <= _MAX_SAMPLE_SMEM,
             f"ns={ns} samples of dim {dim} do not fit a block's shared memory")
    out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check_cuda_operands(dim, xi, sg, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_grouped_rep_force(
            xi.data_ptr(), sg.data_ptr(), int(sg.dtype == torch.bfloat16),
            float(step), out.data_ptr(), c, group, ns, dim,
            _SAMPLE_MODEL_IDS[model.sample_force], _stream(dev))
    _build.check(lib, "grouped_rep_force", err)
    launch_counts["grouped_rep_force"] += 1
    return out


# -- repulsion from per-row samples ------------------------------------------


def ell_sample_force_terms(model: ForceModel, x, xg, idx, deg, xi_row,
                           step) -> torch.Tensor:
    """[C, K, D] sample_force(x[i], xg[idx[r, k]]) per slot, i = xi_row[r],
    in f32 and exactly 0 in the padded slots k ≥ deg[r]."""
    xi = x[xi_row.long()]
    s = xg[idx.long()].float()  # [C, K, D]
    k = idx.shape[1]
    mask = (torch.arange(k, device=idx.device)[None, :]
            < deg[:, None])[:, :, None]
    return model.sample_force(xi[:, None, :], s, step, mask=mask)


def ell_sample_force_plain(model: ForceModel, x, xg, idx, deg, xi_row,
                           step) -> torch.Tensor:
    """out[r] = Σ_{k<deg[r]} sample_force(x[i], xg[idx[r, k]]), i =
    xi_row[r]: the gather, the model's sample force in f32 and a masked sum
    over K."""
    return ell_sample_force_terms(model, x, xg, idx, deg, xi_row,
                                  step).sum(dim=1)


def ell_sample_force(model: ForceModel, x, xg, idx, deg, xi_row, step,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked sample-force sum over per-row samples, gathering in the kernel.

    x [n_pad, D] f32; xg [n_pad, D] bf16 or f32 gather replica of x;
    idx [C, K] int32 sample rows; deg [C] int32 valid samples per row;
    xi_row [C] int32 table row whose x each row uses; step a float.
    Writes into ``out`` [C, D] f32 if given; returns it.  The kernel does
    not bounds-check ``idx`` or ``xi_row``: they must index rows of ``x``.
    """
    _require(model.sample_force in _SAMPLE_MODEL_IDS,
             f"{model.name} has no sample force kernel")
    dev = x.device
    _check("x", x, (torch.float32,), 2, dev)
    _check("xg", xg, _GATHER_DTYPES, 2, dev)
    _check("idx", idx, (torch.int32,), 2, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    _check("xi_row", xi_row, (torch.int32,), 1, dev)
    dim = x.shape[1]
    c, k = idx.shape
    _require(xg.shape == x.shape, f"xg {tuple(xg.shape)} != x {tuple(x.shape)}")
    _require(deg.shape == (c,) and xi_row.shape == (c,),
             "deg and xi_row must have one entry per row of idx")
    if out is None:
        out = torch.empty((c, dim), dtype=torch.float32, device=dev)
    _check("out", out, (torch.float32,), 2, dev)
    _require(out.shape == (c, dim), f"out {tuple(out.shape)} != {(c, dim)}")
    if dev.type == "cpu":
        out.copy_(ell_sample_force_plain(model, x, xg, idx, deg, xi_row, step))
        return out
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(dim, x, xg, out)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_ell_sample_force(
            x.data_ptr(), xg.data_ptr(), int(xg.dtype == torch.bfloat16),
            idx.data_ptr(), deg.data_ptr(), xi_row.data_ptr(), float(step),
            out.data_ptr(), c, k, dim, _SAMPLE_MODEL_IDS[model.sample_force],
            _stream(dev))
    _build.check(lib, "ell_sample_force", err)
    launch_counts["ell_sample_force"] += 1
    return out
