"""The force kernels of the sync iteration: CUDA wrappers and plain versions.

The counterpart of ``force2vec_tpu/ops/pallas_force.py``:

* ``ell_edge_force`` (``csrc/ell_edge_force.cu``): the attraction over an
  ELL bucket or over the walk table; it replaces ``ell_force_mxu`` and
  ``ell_force`` with kind ``edge`` (the same function).
  ``ell_edge_force_table`` runs the same kernel over a whole layout's
  buckets (an ``EdgeWorkTable``) in one launch;
* ``grouped_rep_force`` (``csrc/grouped_rep_force.cu``): the repulsion
  from group-shared negatives, stored, added into the update, or applied
  to X with the update in the same pass (``REP_MODES``); it replaces
  ``grouped_rep_force``;
* ``ell_sample_force`` (``csrc/ell_sample_force.cu``): the repulsion from
  per-row negatives (``-bs 1``); it replaces ``ell_force`` with kind
  ``sample``;
* ``ell_edge_apply`` (``csrc/ell_edge_apply.cu``): the sync iteration's
  attraction, repulsion and ``X += update`` in one launch over a work
  table and a flag an entry, which applies or stores (``apply_table``),
  for an f32 X beside a 2-byte replica; the update never goes through
  device memory;
* the two launches that write X (``ell_edge_apply`` and
  ``grouped_rep_force``'s ``apply``) take ``xg_next``: a 2-byte buffer
  into which each row's new X is also written, rounded as ``x.to(dtype)``
  rounds it, so that the next iteration's replica needs no cast of X;
* ``tp_pair_partial`` and ``tp_pair_force`` (``csrc/tp_pair_force.cu``):
  any of those forces with the dim split over tp ranks, in two launches
  around the caller's ``all_reduce`` of the pair scalars; the JAX package
  computes that step in jnp ops (Pallas off at tp > 1).
  ``concat_work_tables`` lays several tables end to end, so that one
  ``tp_pair_partial`` launch covers the attraction's and the repulsion's.
* ``walk_steps`` (``csrc/walk_steps.cu``): the random-walk model's walk
  engine, every row's walk of L steps over the walk tables from the
  caller's draws, in one launch; the JAX package draws them in jnp ops
  (``sync.py::_ell_walks``).

Each kernel has

* a wrapper, which checks its inputs and, for CUDA tensors, launches the
  hand-written kernel from ``csrc/`` (built at first use by ``_build``) and
  raises if the launch fails; for CPU tensors it runs the plain version;
* a plain PyTorch version of the same function, the reference the kernel is
  held against on the card;
* a launch count in ``launch_counts``, raised by one per kernel launch and
  by nothing else.

``launch_counts["tp_all_reduce"]`` counts the sync trainer's NCCL
``all_reduce`` of the tp pair's scalars (``train/sync.py``), so that a
replayed CUDA graph (``train/graph.py``) counts it with the kernels.

The step is a float or a 0-d f32 tensor on the operands' device (a
trainer's step buffer); the kernels read it from device memory, so that
a launch captured in a CUDA graph reads each replay's step.

A CUDA tensor never falls back to the plain version.  Every kernel takes
rows of any multiple of ``ROW_ALIGN`` elements up to ``KERNEL_MAX_DIM``
(under tp, a rank's columns), 16-byte aligned: the trainers hold X at
``padded_dim(dim)`` columns, the padding columns 0, which every force model
leaves 0 (a zero difference, a zero neighbour component).  The plain
versions take any width.  The sigmoid family comes exact or from
the lookup table (``models/forces.py::with_table_sigmoid``): each table
function has its own model id, and its launch gets the device's table.

X, and with it a force's output and ``invd``, is f32, bf16 or f16
(``X_DTYPES``); an f32 X gathers from rows of any of the three
(``_GATHER_DTYPES``), a bf16 or f16 X from rows of its own dtype (its
replica is X itself), and each wrapper refuses any other pair by name.
Kernels and plain versions alike compute every term and sum in f32 from
X's values and round the result to X's dtype once (an f16 past 65,504 to
±inf); adding into ``out`` adds that rounded result (one rounding more,
as ``out.add_`` of the stored result makes).  The JAX package's MXU
kernel rounds the same way (f32 accumulation, cast to ``xi.dtype``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from force2vec_tpu_torch.models import forces
from force2vec_tpu_torch.models.forces import ForceModel
from force2vec_tpu_torch.ops import _build

launch_counts = {"ell_edge_force": 0, "grouped_rep_force": 0,
                 "ell_sample_force": 0, "tp_pair_partial": 0,
                 "tp_pair_force": 0, "tp_all_reduce": 0,
                 "ell_edge_apply": 0, "walk_steps": 0}

# model ids of csrc/common.cuh's EdgeModel and SampleModel
_EDGE_MODEL_IDS = {
    forces._tdist_coeff: 0,
    forces._sigmoid_coeff: 1,
    forces._fr_coeff: 2,
    forces._linlog_coeff: 3,
    forces._forceatlas_coeff: 4,
    forces._sigmoid_table_coeff: 5,
}
_SAMPLE_MODEL_IDS = {
    forces._tdist_rep: 0,
    forces._sigmoid_rep: 1,
    forces._layout_rep: 2,
    forces._sigmoid_table_rep: 3,
}
# the ids whose kernels read the sigmoid table
_TABLE_MODEL_IDS = {forces._sigmoid_table_coeff, forces._sigmoid_table_rep}
# the widest rows the kernels take (csrc/common.cuh::kMaxDim), and the
# multiple of elements a fused kernel's row is (kRowAlign: 16 bytes of
# bf16, 32 of f32)
KERNEL_MAX_DIM = 1024
ROW_ALIGN = 8
_GATHER_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
# X's dtypes the kernels take; the (gather, X) pairs: csrc/common.cuh::
# F2V_DTYPE_PAIRS
X_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the C entry points' dtype codes (csrc/common.cuh::DType)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SHORT = {torch.bfloat16: "bf16", torch.float16: "f16"}
_MAX_ENTRIES = 64  # csrc/common.cuh::kMaxEntries
# shared memory of f32 samples a grouped_rep_force launch holds
# (csrc/grouped_rep_force.cu::kMaxSampleBytes): more take a launch a chunk
_MAX_SAMPLE_BYTES = 48 * 1024
# grouped_rep_force's output modes (csrc/grouped_rep_force.cu::RepMode):
# store rep, add it into out, apply X += upd + rep in place
REP_MODES = ("store", "add", "apply")
# the sample forces whose grouped apply also writes the next replica
# (csrc/grouped_rep_force.cu::kStoresReplica): the sigmoid family's, rwalk's
_NEXT_REP_MODELS = {forces._sigmoid_rep, forces._sigmoid_table_rep}


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


def padded_dim(dim: int) -> int:
    """The row width the trainers hold a ``dim``-wide X at: ``dim``
    rounded up to a multiple of ``ROW_ALIGN``."""
    return -(-dim // ROW_ALIGN) * ROW_ALIGN


def check_kernel_dim(dim: int) -> None:
    """Raise ``ValueError`` unless the kernels take ``dim``: 1 to
    ``KERNEL_MAX_DIM``."""
    _require(1 <= dim <= KERNEL_MAX_DIM,
             f"the CUDA kernels take dims 1 to {KERNEL_MAX_DIM}, got {dim}; "
             "the batch schedule (--schedule batch) trains at any dim")


def check_x_dtype(dtype) -> None:
    """Raise ``ValueError``, naming ``dtype``, unless the kernels take an X
    of that dtype (``X_DTYPES``)."""
    _require(dtype in X_DTYPES,
             f"the CUDA kernels hold X in {X_DTYPES}, not {dtype}")


def _check_x(name, x, xg, ndim, xg_ndim):
    """x in ``X_DTYPES``, xg in ``_GATHER_DTYPES`` on x's device, and the
    two a pair the kernels take (``_build.dtype_pairs``: a bf16 or f16 x
    only with an xg of its own dtype)."""
    _check(name, x, X_DTYPES, ndim, x.device)
    _check("xg" if xg_ndim == 2 else "sg", xg, _GATHER_DTYPES, xg_ndim,
           x.device)
    pairs = _build.dtype_pairs()
    if (_code(xg), _code(x)) not in pairs:
        rows = " or ".join(_SHORT.get(d, "f32") for d in _GATHER_DTYPES
                           if (_code(d), _code(x)) in pairs)
        raise ValueError(f"a {x.dtype} {name} gathers from {rows} rows, not "
                         f"{xg.dtype}")


def _check_next(xg_next, x, reads) -> None:
    """``xg_next``, the replica a launch that writes X also writes: None,
    or a contiguous tensor of x's shape on its device, bf16 or f16 beside
    an f32 x, a buffer of its own: none of ``x`` and the tensors the
    launch ``reads`` (the replica it gathers from, its samples)."""
    if xg_next is None:
        return
    _require(x.dtype == torch.float32,
             f"xg_next is the replica of an f32 X, not of a {x.dtype} one")
    _check("xg_next", xg_next, (torch.bfloat16, torch.float16), 2, x.device)
    _require(xg_next.shape == x.shape,
             f"xg_next {tuple(xg_next.shape)} != x {tuple(x.shape)}")
    _require(all(xg_next.data_ptr() != t.data_ptr() for t in (x, *reads)),
             "xg_next must be a buffer of its own: not x, nor what the "
             "launch reads")


def _code(t) -> int:
    """The DType code of a tensor or a dtype."""
    return _DTYPE_CODES[t if isinstance(t, torch.dtype) else t.dtype]


def _store(dst, s, accumulate: bool):
    """``s`` (f32) rounded to ``dst``'s dtype, written into ``dst`` or
    with ``accumulate`` added to it (``dst.add_`` of the rounded value)."""
    s = s.to(dst.dtype)
    return dst.add_(s) if accumulate else dst.copy_(s)


def _check_cuda_operands(dim, *tensors):
    _require(dim % ROW_ALIGN == 0 and ROW_ALIGN <= dim <= KERNEL_MAX_DIM,
             f"the CUDA kernels take rows of a multiple of {ROW_ALIGN} "
             f"elements up to {KERNEL_MAX_DIM}, got {dim} (hold X at "
             "padded_dim(dim) columns)")
    _check_aligned(*tensors)


def _check_aligned(*tensors):
    for t in tensors:
        # vector loads of whole row pieces need 16-byte aligned row bases
        _require(t.data_ptr() % 16 == 0, "CUDA operands must be 16-byte aligned")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _table_ptr(fn, device):
    """The device's sigmoid table for a table model's kernel, else null."""
    if fn not in _TABLE_MODEL_IDS:
        return None
    return forces.device_sm_table(device).data_ptr()


def _step_scalar(step, device) -> torch.Tensor:
    """The step as the kernels read it, a 0-d f32 tensor on ``device``:
    ``step`` itself when it is one (a trainer's step buffer, whose value a
    captured launch reads at each replay), else the f32 value's scalar,
    made once (``_float_step``) so that a float costs a launch no fill."""
    if isinstance(step, torch.Tensor):
        _require(step.dtype == torch.float32 and step.dim() == 0
                 and step.device == device,
                 f"a tensor step must be a 0-d float32 tensor on {device}, "
                 f"got {step.dtype} {tuple(step.shape)} on {step.device}")
        return step
    return _float_step(device, int(np.float32(step).view(np.uint32)))


@functools.lru_cache(maxsize=64)
def _float_step(device, bits: int) -> torch.Tensor:
    """A 0-d f32 tensor on ``device`` holding the f32 with these bits,
    never written again (a launch may still read an evicted one: its
    memory goes back to its stream, after the launch)."""
    return torch.full((), float(np.uint32(bits).view(np.float32)),
                      dtype=torch.float32, device=device)


def _slot_mask(idx, deg):
    """[C, K, 1] bool: slot k of row r is real (k < deg[r])."""
    k = idx.shape[1]
    return (torch.arange(k, device=idx.device)[None, :]
            < deg[:, None])[:, :, None]


# -- attraction over ELL buckets ---------------------------------------------


def ell_edge_force_terms(model: ForceModel, x, xg, nbr, deg, xi_row, invd,
                         step, rsum=None) -> torch.Tensor:
    """[C, K, D] edge_force(x[i], xg[nbr[r, k]]) per slot, i = xi_row[r], in
    f32 and exactly 0 in the padded slots k ≥ deg[r].  ``rsum``: the
    models' reduction over the dim (``tp_pair_force_plain`` passes one that
    returns the scalars reduced over the tp ranks)."""
    rows = xi_row.long()
    xi = x[rows].float()
    xj = xg[nbr.long()].float()  # [C, K, D]
    kw = {} if rsum is None else {"rsum": rsum}
    return model.edge_force(xi[:, None, :], xj,
                            invd[rows].float()[:, None, None], step,
                            mask=_slot_mask(nbr, deg), **kw)


def ell_edge_force_plain(model: ForceModel, x, xg, nbr, deg, xi_row, invd,
                         step) -> torch.Tensor:
    """out[r] = Σ_{k<deg[r]} edge_force(x[i], xg[nbr[r, k]]), i = xi_row[r]:
    the gather, the model's edge force in f32 and a masked sum over K,
    rounded to X's dtype."""
    return ell_edge_force_terms(model, x, xg, nbr, deg, xi_row, invd,
                                step).sum(dim=1).to(x.dtype)


def _check_edge_operands(model, x, xg, invd):
    _require(model.edge_coeff in _EDGE_MODEL_IDS,
             f"{model.name} has no separable edge force")
    _check_x("x", x, xg, 2, 2)
    _check("invd", invd, (x.dtype,), 1, x.device)
    _require(xg.shape[1] == x.shape[1] and xg.shape[0] >= x.shape[0],
             f"xg {tuple(xg.shape)} must hold x's {tuple(x.shape)} rows "
             "first (x's replica, or [x | more rows])")
    _require(invd.shape == (x.shape[0],), "invd must have one entry per x row")


def _edge_out(out, rows, x):
    if out is None:
        out = torch.empty((rows, x.shape[1]), dtype=x.dtype, device=x.device)
    _check("out", out, (x.dtype,), 2, x.device)
    _require(out.shape == (rows, x.shape[1]),
             f"out {tuple(out.shape)} != {(rows, x.shape[1])}")
    return out


def _launch_edge(model, x, xg, nbr, deg, xi_row, invd, step, out,
                 table: np.ndarray) -> None:
    """One ``ell_edge_force`` launch over ``table`` ([E, 5] int64 entries,
    csrc/common.cuh::ell_plan), on checked operands."""
    dev = x.device
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(x.shape[1], x, xg, out)
    lib = _build.load_library()
    step = _step_scalar(step, dev)
    with torch.cuda.device(dev):
        err = lib.f2v_ell_edge_force(
            x.data_ptr(), xg.data_ptr(), _code(xg), _code(x),
            nbr.data_ptr(), deg.data_ptr(), xi_row.data_ptr(),
            invd.data_ptr(), _table_ptr(model.edge_coeff, dev),
            step.data_ptr(), out.data_ptr(),
            table.ctypes.data, table.shape[0], x.shape[1],
            _EDGE_MODEL_IDS[model.edge_coeff], _stream(dev))
    _build.check(lib, "ell_edge_force", err)
    launch_counts["ell_edge_force"] += 1


def ell_edge_force(model: ForceModel, x, xg, nbr, deg, xi_row, invd, step,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked edge-force sum over one ELL bucket, gathering in the kernel.

    x [n, D] f32, bf16 or f16; xg [m, D] of any of them with an f32 x, else of
    x's dtype, the gather table: x's replica, or x's rows followed by more (a
    shard's ``[x_loc | hot | halo]``, m ≥ n); nbr [C, K] int32 rows of xg; deg
    [C] int32 valid slots per row; xi_row [C] int32 row of x (and invd) each
    bucket row uses (the bucket's own rows, or the owners of hub virtual rows);
    invd [n] in x's dtype; step a float or a 0-d f32 tensor on x's device
    (``_step_scalar``).  Writes into ``out`` [C, D] of x's dtype if given;
    returns it.  The kernel does not bounds-check ``nbr`` or
    ``xi_row`` (``edge_work_table`` checks a table's once).  One launch of the
    table kernel, over a one-entry table.
    """
    _check_edge_operands(model, x, xg, invd)
    dev = x.device
    _check("nbr", nbr, (torch.int32,), 2, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    _check("xi_row", xi_row, (torch.int32,), 1, dev)
    c, k = nbr.shape
    _require(deg.shape == (c,) and xi_row.shape == (c,),
             "deg and xi_row must have one entry per bucket row")
    out = _edge_out(out, c, x)
    if dev.type == "cpu":
        out.copy_(ell_edge_force_plain(model, x, xg, nbr, deg, xi_row, invd,
                                       step))
        return out
    table = np.array([[0, 0, 0, c, k]], dtype=np.int64)
    _launch_edge(model, x, xg, nbr, deg, xi_row, invd, step, out, table)
    return out


@dataclasses.dataclass(frozen=True)
class EdgeWorkTable:
    """Several ELL buckets as one ``ell_edge_force`` launch: their index
    arrays concatenated, one entry per bucket, widest first.  Built and
    checked once by ``edge_work_table``; a launch checks only x, xg, invd
    and out, and that their rows are the ones the table was checked for."""

    nbr: torch.Tensor  # [slots] int32: every entry's [rows, width] ids, flat
    deg: torch.Tensor  # [rows] int32 valid slots per row
    xi_row: torch.Tensor  # [rows] int32 table row whose x and invd a row uses
    # [E, 5] int64 per entry, in launch order: row_begin, nbr_begin,
    # out_begin, rows, width (csrc/common.cuh::ell_plan)
    entries: np.ndarray
    n_pad: int  # rows of x (and invd), which xi_row indexes
    out_rows: int  # output rows
    n_gather: int  # rows of the gather table, which nbr indexes
    # True: the entries write some output rows (each at most once) and
    # leave the others; False: each output row exactly once
    partial: bool = False

    @classmethod
    def single(cls, nbr, deg, xi_row, n_pad: int,
               n_gather: Optional[int] = None) -> "EdgeWorkTable":
        """A one-entry table over ``nbr`` [C, K] (contiguous), writing
        output rows [0, C).  Unchecked, as ``ell_edge_force``'s operands:
        deg must lie in [0, K], xi_row index x's ``n_pad`` rows and the
        real slots the ``n_gather`` rows of the gather table."""
        c, k = nbr.shape
        return cls(nbr=nbr.reshape(-1), deg=deg, xi_row=xi_row,
                   entries=np.array([[0, 0, 0, c, k]], dtype=np.int64),
                   n_pad=n_pad, out_rows=c,
                   n_gather=n_pad if n_gather is None else n_gather)

    def parts(self) -> list:
        """``(nbr [rows, width], deg, xi_row, out_begin)`` per entry, in
        launch order: views of the flat arrays."""
        out = []
        for rb, nb, ob, rows, width in self.entries.tolist():
            out.append((self.nbr[nb: nb + rows * width].view(rows, width),
                        self.deg[rb: rb + rows], self.xi_row[rb: rb + rows],
                        ob))
        return out


def edge_work_table(parts, n_pad: int, out_rows: int, *,
                    n_gather: Optional[int] = None,
                    partial: bool = False) -> EdgeWorkTable:
    """The work table of ``parts``, each ``(nbr [C, K] int32, deg [C] int32,
    xi_row [C] int32, out_begin)``: its C rows write output rows
    ``[out_begin, out_begin + C)``.  Entries run widest first (a stable
    sort), so the longest rows start first.  Checks, once: types,
    shapes, one device; deg in [0, K]; xi_row in [0, n_pad), the rows of x;
    the real slots' ids in [0, n_gather), the rows of the gather table
    (``n_pad`` unless given: x's replica); the parts' output rows tile
    [0, out_rows) exactly, or with ``partial`` lie in it without overlap.
    Parts with no rows are dropped."""
    n_gather = n_pad if n_gather is None else n_gather
    parts = [p for p in parts if p[0].shape[0] > 0]
    _require(0 < len(parts) <= _MAX_ENTRIES,
             f"a work table holds 1 to {_MAX_ENTRIES} non-empty parts, got "
             f"{len(parts)}")
    dev = parts[0][0].device
    for nbr, deg, xi_row, _ in parts:
        _check("nbr", nbr, (torch.int32,), 2, dev)
        _check("deg", deg, (torch.int32,), 1, dev)
        _check("xi_row", xi_row, (torch.int32,), 1, dev)
        c, k = nbr.shape
        _require(deg.shape == (c,) and xi_row.shape == (c,),
                 "deg and xi_row must have one entry per row of nbr")
        _require(bool(((deg >= 0) & (deg <= k)).all()),
                 "deg must lie in [0, width]")
        _require(bool(((xi_row >= 0) & (xi_row < n_pad)).all()),
                 "xi_row must index rows of x")
        real = nbr[_slot_mask(nbr, deg)[:, :, 0]]
        _require(bool(((real >= 0) & (real < n_gather)).all()),
                 "the real slots of nbr must index rows of the gather table")
    covered = 0
    how = "lie in" if partial else "tile"
    for lo, hi in sorted((ob, ob + p[0].shape[0]) for *p, ob in parts):
        _require((lo >= covered if partial else lo == covered)
                 and hi <= out_rows,
                 f"the parts' output rows must {how} [0, {out_rows}) "
                 "without overlap")
        covered = hi
    _require(partial or covered == out_rows,
             f"the parts' output rows must tile [0, {out_rows}) exactly")

    parts = sorted(parts, key=lambda p: -p[0].shape[1])
    entries, row, slot = [], 0, 0
    for nbr, _, _, ob in parts:
        c, k = nbr.shape
        entries.append((row, slot, ob, c, k))
        row, slot = row + c, slot + c * k
    return EdgeWorkTable(
        nbr=torch.cat([p[0].reshape(-1) for p in parts]),
        deg=torch.cat([p[1] for p in parts]),
        xi_row=torch.cat([p[2] for p in parts]),
        entries=np.ascontiguousarray(entries, dtype=np.int64),
        n_pad=n_pad, out_rows=out_rows, n_gather=n_gather, partial=partial)


def ell_edge_force_table_plain(model: ForceModel, x, xg,
                               table: EdgeWorkTable, invd, step,
                               out: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """[out_rows, D]: ``ell_edge_force_plain`` of each entry, in its output
    rows of ``out`` (a new tensor if not given)."""
    if out is None:
        out = torch.empty((table.out_rows, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    for nbr, deg, xi_row, ob in table.parts():
        out[ob: ob + nbr.shape[0]] = ell_edge_force_plain(
            model, x, xg, nbr, deg, xi_row, invd, step)
    return out


def ell_edge_force_table(model: ForceModel, x, xg, table: EdgeWorkTable,
                         invd, step, out: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``ell_edge_force`` over every entry of ``table`` in one launch.

    x [table.n_pad, D] f32, bf16 or f16, xg [table.n_gather, D] of any of them
    with an f32 x, else of x's dtype, the gather table (x's replica unless the
    table was built with ``n_gather``), invd [table.n_pad] in x's dtype, step a
    float or a 0-d f32 tensor on x's device.  Writes into ``out``
    [table.out_rows, D] of x's dtype if given (every row, or with a
    ``partial`` table its entries' rows, which then needs ``out``); returns
    it.
    """
    _check_edge_operands(model, x, xg, invd)
    _require(x.shape[0] == table.n_pad,
             f"x has {x.shape[0]} rows, the table indexes {table.n_pad}")
    _require(xg.shape[0] == table.n_gather,
             f"xg has {xg.shape[0]} rows, the table gathers from "
             f"{table.n_gather}")
    _require(table.nbr.device == x.device,
             f"table on {table.nbr.device}, x on {x.device}")
    _require(out is not None or not table.partial,
             "a partial table needs out")
    out = _edge_out(out, table.out_rows, x)
    if x.device.type == "cpu":
        return ell_edge_force_table_plain(model, x, xg, table, invd, step,
                                          out=out)
    _launch_edge(model, x, xg, table.nbr, table.deg, table.xi_row, invd, step,
                 out, table.entries)
    return out


# -- repulsion from group-shared samples ---------------------------------------


def grouped_rep_force_terms(model: ForceModel, group: int, xi, sg,
                            step) -> torch.Tensor:
    """[C, ns, D] sample_force(xi[r], sg[r // group, s]) per sample, in f32."""
    gid = torch.arange(xi.shape[0], device=xi.device) // group
    s = sg[gid].float()  # [C, ns, D]
    return model.sample_force(xi.float()[:, None, :], s, step)


def _check_rep_mode(model: ForceModel, mode: str, xi, out, upd,
                    xg_next=None, sg=None) -> None:
    """The operands ``mode`` reads: ``out`` for ``add``, ``upd`` for
    ``apply`` (X's update; xi is X itself), each ``[C, D]`` of xi's dtype
    on its device, and neither where the mode does not read it; and
    ``xg_next`` only with ``apply`` (``_check_next``).  ``apply`` is
    refused with an energy model, whose update is normalised between the
    repulsion and X."""
    _require(mode in REP_MODES, f"mode {mode!r} not in {REP_MODES}")
    _require(not (mode == "apply" and model.update == "energy"),
             f"mode 'apply' adds the update into X, but {model.name}'s "
             "energy update normalises it first: use mode 'add'")
    for name, t, reads in (("out", out, mode == "add"),
                           ("upd", upd, mode == "apply")):
        _require((t is not None) == reads,
                 f"mode {mode!r} {'needs' if reads else 'takes no'} {name}")
        if reads:
            _check(name, t, (xi.dtype,), 2, xi.device)
            _require(t.shape == xi.shape,
                     f"{name} {tuple(t.shape)} != xi {tuple(xi.shape)}")
    _require(xg_next is None or mode == "apply",
             f"mode {mode!r} writes no X, so no next replica")
    _require(xg_next is None or model.sample_force in _NEXT_REP_MODELS,
             f"{model.name}'s grouped repulsion writes no next replica (the "
             "sigmoid family's does: csrc/grouped_rep_force.cu::"
             "kStoresReplica)")
    _check_next(xg_next, xi, (sg,) if sg is not None else ())


def grouped_rep_force_plain(model: ForceModel, group: int, xi, sg, step, *,
                            mode: str = "store",
                            out: Optional[torch.Tensor] = None,
                            upd: Optional[torch.Tensor] = None,
                            xg_next: Optional[torch.Tensor] = None):
    """rep[r] = Σ_s sample_force(xi[r], sg[r // group, s]): the group
    expand, the model's sample force in f32 and a sum over ns, rounded to
    xi's dtype.  ``store``: returns rep; ``add``: ``out.add_(rep)``,
    returns out; ``apply``: ``xi.add_(upd + rep)`` in place (xi is X, each
    add rounded to its dtype, as ``upd.add_(rep); x.add_(upd)`` rounds,
    with upd left as it was), and ``xg_next.copy_(xi)`` where given;
    returns xi."""
    _check_rep_mode(model, mode, xi, out, upd, xg_next, sg)
    rep = grouped_rep_force_terms(model, group, xi, sg,
                                  step).sum(dim=1).to(xi.dtype)
    if mode == "store":
        return rep
    if mode == "add":
        return out.add_(rep)
    xi.add_(upd + rep)
    if xg_next is not None:
        xg_next.copy_(xi)
    return xi


def grouped_rep_force(model: ForceModel, group: int, xi, sg, step, *,
                      mode: str = "store", out: Optional[torch.Tensor] = None,
                      upd: Optional[torch.Tensor] = None,
                      xg_next: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-negative repulsion with the group expand kept on chip.

    xi [C, D] f32, bf16 or f16, row r in group r // group; sg [ng, ns, D] of
    any of them with an f32 xi, else of xi's dtype, per-group sample rows, ng ≥
    ceil(C / group); step a float or a 0-d f32 tensor on xi's device.  rep,
    the f32 sum over the samples rounded to xi's dtype, goes out by ``mode``
    (``REP_MODES``):

    * ``store``: returns rep, a new [C, D] tensor of xi's dtype;
    * ``add``: adds rep into ``out`` [C, D] (``out.add_(rep)`` bit for
      bit); returns out;
    * ``apply``: xi is X; X ← X + (upd + rep) in place, ``upd`` [C, D]
      its update (``upd.add_(rep); x.add_(upd)`` bit for bit, upd left as
      it was; refused with an energy model); returns xi.  With an f32 X
      and ``xg_next`` [C, D] bf16 or f16 (``_check_next``), each row's new
      X is also written into it, ``xg_next.copy_(x)`` bit for bit: the
      replica the next iteration gathers from (the sigmoid family's
      repulsion only, ``_NEXT_REP_MODELS``).

    One launch, or one a chunk of samples where ns·D f32 pass
    ``_MAX_SAMPLE_BYTES`` (ns > 12 at D = 1024), the chunks' f32 sums
    passed on in an f32 scratch, so a chunked sum rounds as one launch's.
    """
    _require(model.sample_force in _SAMPLE_MODEL_IDS,
             f"{model.name} has no grouped sample force")
    _require(isinstance(group, int) and group > 0, f"bad group {group!r}")
    dev = xi.device
    _check_x("xi", xi, sg, 2, 3)
    c, dim = xi.shape
    ng, ns, sdim = sg.shape
    _require(sdim == dim, f"sg dim {sdim} != xi dim {dim}")
    _require(ng * group >= c, f"{ng} groups of {group} cover fewer than {c} rows")
    _check_rep_mode(model, mode, xi, out, upd, xg_next, sg)
    if dev.type == "cpu":
        return grouped_rep_force_plain(model, group, xi, sg, step, mode=mode,
                                       out=out, upd=upd, xg_next=xg_next)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(ns > 0, "sg holds no samples")
    if mode == "store":
        out = torch.empty((c, dim), dtype=xi.dtype, device=dev)
    elif mode == "apply":
        out = xi
    _check_cuda_operands(dim, xi, sg, out, *(t for t in (upd, xg_next)
                                              if t is not None))
    chunks = -(-ns // (_MAX_SAMPLE_BYTES // (dim * 4)))
    part = (torch.empty((c, dim), dtype=torch.float32, device=dev)
            if chunks > 1 else None)
    lib = _build.load_library()
    step = _step_scalar(step, dev)
    with torch.cuda.device(dev):
        err = lib.f2v_grouped_rep_force(
            xi.data_ptr(), sg.data_ptr(), _code(sg), _code(xi),
            _table_ptr(model.sample_force, dev), step.data_ptr(),
            out.data_ptr(), None if upd is None else upd.data_ptr(),
            None if part is None else part.data_ptr(),
            None if xg_next is None else xg_next.data_ptr(),
            _code(xg_next) if xg_next is not None else 0,
            REP_MODES.index(mode),
            c, group, ns, dim, _SAMPLE_MODEL_IDS[model.sample_force],
            _stream(dev))
    _build.check(lib, "grouped_rep_force", err)
    launch_counts["grouped_rep_force"] += chunks
    return out


# -- repulsion from per-row samples ------------------------------------------


def ell_sample_force_terms(model: ForceModel, x, xg, idx, deg, xi_row,
                           step, rsum=None) -> torch.Tensor:
    """[C, K, D] sample_force(x[i], xg[idx[r, k]]) per slot, i = xi_row[r],
    in f32 and exactly 0 in the padded slots k ≥ deg[r]; ``rsum`` as
    ``ell_edge_force_terms``'s."""
    xi = x[xi_row.long()].float()
    s = xg[idx.long()].float()  # [C, K, D]
    kw = {} if rsum is None else {"rsum": rsum}
    return model.sample_force(xi[:, None, :], s, step,
                              mask=_slot_mask(idx, deg), **kw)


def ell_sample_force_plain(model: ForceModel, x, xg, idx, deg, xi_row, step,
                           out: Optional[torch.Tensor] = None,
                           accumulate: bool = False) -> torch.Tensor:
    """Σ_{k<deg[r]} sample_force(x[i], xg[idx[r, k]]), i = xi_row[r]: the
    gather, the model's sample force in f32 and a masked sum over K,
    rounded to X's dtype.  Returns it, or writes it into ``out`` (with
    ``accumulate``, adds it: ``out.add_(sum)``) and returns ``out``."""
    s = ell_sample_force_terms(model, x, xg, idx, deg, xi_row,
                               step).sum(dim=1)
    if out is None:
        _require(not accumulate, "accumulate needs out")
        return s.to(x.dtype)
    return _store(out, s, accumulate)


def ell_sample_force(model: ForceModel, x, xg, idx, deg, xi_row, step,
                     out: Optional[torch.Tensor] = None,
                     accumulate: bool = False) -> torch.Tensor:
    """Masked sample-force sum over per-row samples, gathering in the kernel.

    x [n, D] f32, bf16 or f16; xg [m, D] of any of them with an f32 x, else of
    x's dtype, the table the samples come from: x's replica, or other rows (the
    vertex schedule's ``[S, D]`` pool); idx [C, K] int32 rows of xg; deg [C]
    int32 valid samples per row; xi_row [C] int32 row of x each row uses; step
    a float or a 0-d f32 tensor on x's device.  Writes into ``out`` [C, D] of
    x's dtype if given, or with ``accumulate`` adds into it (one add per
    element, as ``out.add_(sum)`` makes); returns ``out``.  The kernel does not bounds-check ``idx`` or
    ``xi_row``: they must index rows of ``xg`` and ``x`` (the callers check
    injected ids where they enter, as ``VertexShardedForce2Vec.run_iteration``
    does).  On the CPU, where it costs no read back from a device, the wrapper
    checks them (``ValueError``).
    """
    _require(model.sample_force in _SAMPLE_MODEL_IDS,
             f"{model.name} has no sample force kernel")
    _require(out is not None or not accumulate, "accumulate needs out")
    dev = x.device
    _check_x("x", x, xg, 2, 2)
    _check("idx", idx, (torch.int32,), 2, dev)
    _check("deg", deg, (torch.int32,), 1, dev)
    _check("xi_row", xi_row, (torch.int32,), 1, dev)
    dim = x.shape[1]
    c, k = idx.shape
    _require(xg.shape[1] == dim, f"xg rows of {xg.shape[1]} != x rows of {dim}")
    _require(deg.shape == (c,) and xi_row.shape == (c,),
             "deg and xi_row must have one entry per row of idx")
    if out is None:
        out = torch.empty((c, dim), dtype=x.dtype, device=dev)
    _check("out", out, (x.dtype,), 2, dev)
    _require(out.shape == (c, dim), f"out {tuple(out.shape)} != {(c, dim)}")
    if dev.type == "cpu":
        real = idx[_slot_mask(idx, deg)[:, :, 0]]
        _require(bool(((xi_row >= 0) & (xi_row < x.shape[0])).all()),
                 "xi_row must index rows of x")
        _require(bool(((real >= 0) & (real < xg.shape[0])).all()),
                 "the real slots of idx must index rows of xg")
        return ell_sample_force_plain(model, x, xg, idx, deg, xi_row, step,
                                      out=out, accumulate=accumulate)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(dim, x, xg, out)
    lib = _build.load_library()
    step = _step_scalar(step, dev)
    with torch.cuda.device(dev):
        err = lib.f2v_ell_sample_force(
            x.data_ptr(), xg.data_ptr(), _code(xg), _code(x),
            idx.data_ptr(), deg.data_ptr(), xi_row.data_ptr(),
            _table_ptr(model.sample_force, dev), step.data_ptr(),
            out.data_ptr(), int(accumulate), c, k, dim,
            _SAMPLE_MODEL_IDS[model.sample_force], _stream(dev))
    _build.check(lib, "ell_sample_force", err)
    launch_counts["ell_sample_force"] += 1
    return out


# -- attraction, repulsion and the update of X in one launch -------------------

# the models csrc/ell_edge_apply.cu takes: those with an add update and a
# CSR attraction (their edge model ids), each with its own sample force
_APPLY_MODELS = {(forces._tdist_coeff, forces._tdist_rep),
                 (forces._sigmoid_coeff, forces._sigmoid_rep),
                 (forces._sigmoid_table_coeff, forces._sigmoid_table_rep)}


def applies(model: ForceModel) -> bool:
    """Whether ``ell_edge_apply`` takes ``model``: an ``add`` update, a CSR
    attraction, and an edge force paired with its own sample force."""
    return (model.update == "add" and model.attraction == "csr"
            and (model.edge_coeff, model.sample_force) in _APPLY_MODELS)


def applied_rows(table: EdgeWorkTable, apply) -> torch.Tensor:
    """The X rows (int64, in launch order, repeats kept) that the entries
    of ``table`` flagged in ``apply`` update."""
    rows = [p[2].long() for p, a in zip(table.parts(), apply) if a]
    return (torch.cat(rows) if rows else
            torch.zeros(0, dtype=torch.long, device=table.deg.device))


def apply_table(table: EdgeWorkTable, apply, entries=None,
                out_rows: Optional[int] = None):
    """``(table, flags)`` for ``ell_edge_apply``: ``table``'s arrays, its
    ``entries`` ([E, 5] int64, default ``table``'s: rows of its arrays) and
    ``out_rows`` rows of output for the storing entries (default
    ``table``'s), beside ``apply`` as a tuple of bools, one an entry in
    launch order: True where the entry's rows update X's rows ``xi_row``
    in place (their output rows index ``upd``, where given), False where
    they store their sums into the output rows.  Checks, once, that each X
    row is applied by at most one entry row and that no storing entry
    reads an applied row's x (the hub's virtual rows read their owners'
    while the launch writes X)."""
    entries = np.ascontiguousarray(table.entries if entries is None
                                   else entries, dtype=np.int64)
    apply = tuple(bool(a) for a in apply)
    _require(len(apply) == entries.shape[0], "one apply flag an entry")
    t = dataclasses.replace(table, entries=entries, partial=True,
                            out_rows=(table.out_rows if out_rows is None
                                      else out_rows))
    parts = t.parts()
    if any(apply):
        applied = torch.bincount(applied_rows(t, apply), minlength=t.n_pad)
        _require(int(applied.max()) <= 1, "an X row applied by two entry rows")
        for (_, _, xi_row, _), a in zip(parts, apply):
            _require(a or not bool(applied[xi_row.long()].any()),
                     "a storing entry reads an X row the launch applies")
    for (nbr, _, _, ob), a in zip(parts, apply):
        _require(a or ob + nbr.shape[0] <= t.out_rows,
                 f"a storing entry writes past the {t.out_rows} output rows")
    return t, apply


def _rep_rows(model: ForceModel, x, xg, negs, group: int, xi_row,
              step) -> torch.Tensor:
    """[C, D] in x's dtype: rows ``xi_row``'s repulsion, Σ_s
    sample_force(x[i], xg[negs[i // group, s]]), in f32 and rounded once:
    the terms and sums of ``grouped_rep_force_plain`` and
    ``ell_sample_force_plain``."""
    rows = xi_row.long()
    s = xg[negs[rows // group].long()].float()  # [C, ns, D]
    terms = model.sample_force(x[rows].float()[:, None, :], s, step)
    return terms.sum(dim=1).to(x.dtype)


def _entry_sums(edge, model: ForceModel, x, xg, table: EdgeWorkTable,
                invd, step) -> torch.Tensor:
    """[rows of ``table``'s arrays, D]: row r of each entry's attraction
    sum in row ``row_begin + r``, from ``edge`` (``ell_edge_force_table`` or
    its plain version) over the entries laid out as one storing table."""
    entries = table.entries.copy()
    entries[:, 2] = entries[:, 0]
    flat = dataclasses.replace(table, entries=entries, partial=True,
                               out_rows=table.deg.shape[0])
    out = torch.zeros((flat.out_rows, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return edge(model, x, xg, flat, invd, step, out=out)


def _apply_plain(edge, model: ForceModel, x, xg, table: EdgeWorkTable,
                 apply, invd, negs, group: int, step, out, upd, xg_next):
    """``ell_edge_apply_plain``, its attraction sums from ``edge``."""
    if out is None and table.out_rows:
        out = torch.empty((table.out_rows, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    sums = (None if upd is not None and all(apply) else
            _entry_sums(edge, model, x, xg, table, invd, step))
    new = []
    for (rb, _, ob, c, _), a, (_, _, xi_row, _) in zip(
            table.entries.tolist(), apply, table.parts()):
        if not a:
            out[ob: ob + c] = sums[rb: rb + c]
            continue
        att = upd[ob: ob + c] if upd is not None else sums[rb: rb + c]
        rep = _rep_rows(model, x, xg, negs, group, xi_row, step)
        rows = xi_row.long()
        new.append((rows, x[rows] + (att + rep)))
    for rows, v in new:
        x[rows] = v
        if xg_next is not None:
            xg_next[rows] = v.to(xg_next.dtype)
    return out


def ell_edge_apply_plain(model: ForceModel, x, xg, table: EdgeWorkTable,
                         apply, invd, negs, group: int, step,
                         out: Optional[torch.Tensor] = None,
                         upd: Optional[torch.Tensor] = None,
                         xg_next: Optional[torch.Tensor] = None):
    """The plain version of ``ell_edge_apply``: each storing entry's
    ``ell_edge_force_table_plain`` sums into its output rows; each
    applying entry's attraction (those sums, or ``upd``'s rows),
    repulsion (``_rep_rows``) and X's rows ``x[i] + (att + rep)``, written
    after every entry has read X (and, cast, into ``xg_next``'s rows where
    given).  Returns ``out``."""
    return _apply_plain(ell_edge_force_table_plain, model, x, xg, table,
                        apply, invd, negs, group, step, out, upd, xg_next)


def ell_edge_apply(model: ForceModel, x, xg, table: EdgeWorkTable, apply,
                   invd, negs, group: int, step,
                   out: Optional[torch.Tensor] = None,
                   upd: Optional[torch.Tensor] = None,
                   xg_next: Optional[torch.Tensor] = None):
    """The sync iteration's forces and update in one launch, in place.

    For each row r of an entry of ``table`` that ``apply`` flags (both
    from ``apply_table``), with i = xi_row[r]: att = Σ_{k<deg[r]}
    edge_force(x[i], xg[nbr[r, k]]) (or ``upd``'s row ``out_begin + r``,
    where ``upd`` is given), rep = Σ_{s<ns} sample_force(x[i],
    xg[negs[i // group, s]]), each summed in
    f32 and rounded to X's dtype, and ``x[i] ← x[i] + (att + rep)``: the
    bits of ``ell_edge_force`` then ``grouped_rep_force``'s ``apply``, or
    ``ell_sample_force`` adding into the update then ``x.add_(upd)``.  A
    storing entry writes its rows' attraction sums into ``out``
    [table.out_rows, D] (a new tensor if not given).  Returns ``out``
    (None for a table with no output rows).

    x [table.n_pad, D] f32; xg [table.n_gather, D] bf16 or f16, its
    replica, a tensor of its own (``_build.apply_pairs``); invd
    [table.n_pad] f32; negs [groups, ns] int32 rows of xg, row i's set
    ``i // group`` (group 1: per-vertex negatives, ``[n_pad, ns]``); the
    model one ``applies`` takes; step a float or a 0-d f32 tensor on x's
    device.  On the card no row of X is read but by its own row, so X
    takes the update while the launch runs.

    ``xg_next`` [table.n_pad, D] of xg's dtype, a buffer of its own (not
    x, not xg, which other rows still gather from): each applied row's new
    X is also written into its row i, rounded as ``x.to(xg.dtype)``
    rounds it; the tables that apply every row of X once
    (``SyncForce2Vec._fused_tables``) write the whole next replica.
    """
    _require(applies(model), f"{model.name} has no fused attraction, "
                             "repulsion and apply")
    _check_edge_operands(model, x, xg, invd)
    dev = x.device
    _require((_code(xg), _code(x)) in _build.apply_pairs(),
             f"the fused launch takes an f32 x beside a bf16 or f16 replica, "
             f"not {x.dtype} beside {xg.dtype}")
    _require(xg.data_ptr() != x.data_ptr(), "xg must be a replica of its own")
    _require(x.shape[0] == table.n_pad and xg.shape[0] == table.n_gather,
             f"x {tuple(x.shape)} and xg {tuple(xg.shape)} != the table's "
             f"{table.n_pad} and {table.n_gather} rows")
    _require(len(apply) == table.entries.shape[0],
             "the table needs an apply flag an entry (apply_table)")
    _require(table.nbr.device == dev, f"table on {table.nbr.device}, x on "
                                      f"{dev}")
    _require(isinstance(group, int) and group > 0, f"bad group {group!r}")
    _check("negs", negs, (torch.int32,), 2, dev)
    _require(negs.shape[1] > 0, "negs holds no samples")
    _require(negs.shape[0] * group >= table.n_pad,
             f"{negs.shape[0]} sets of {group} rows cover fewer than "
             f"{table.n_pad}")
    if table.out_rows:
        out = _edge_out(out, table.out_rows, x)
    _check_next(xg_next, x, (xg,))
    if xg_next is not None:
        _require(xg_next.dtype == xg.dtype, f"xg_next must be of the "
                 f"replica's dtype {xg.dtype}, not {xg_next.dtype}")
    if upd is not None:
        _check("upd", upd, (x.dtype,), 2, dev)
        ends = [ob + rows for (_, _, ob, rows, _), a in
                zip(table.entries.tolist(), apply) if a]
        _require(upd.shape[1] == x.shape[1] and max(ends, default=0)
                 <= upd.shape[0], "upd must hold the applied rows' out rows")
    if dev.type == "cpu":  # the attraction through the edge launch's wrapper
        return _apply_plain(ell_edge_force_table, model, x, xg, table, apply,
                            invd, negs, group, step, out, upd, xg_next)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_cuda_operands(x.shape[1], x, xg,
                         *(t for t in (out, upd, xg_next) if t is not None))
    mask = sum(1 << k for k, a in enumerate(apply) if a)
    lib = _build.load_library()
    step = _step_scalar(step, dev)
    with torch.cuda.device(dev):
        err = lib.f2v_ell_edge_apply(
            x.data_ptr(), xg.data_ptr(), _code(xg), _code(x),
            table.nbr.data_ptr(), table.deg.data_ptr(),
            table.xi_row.data_ptr(), invd.data_ptr(),
            _table_ptr(model.edge_coeff, dev), step.data_ptr(),
            None if out is None else out.data_ptr(), negs.data_ptr(),
            None if upd is None else upd.data_ptr(),
            None if xg_next is None else xg_next.data_ptr(), mask, group,
            negs.shape[1], table.entries.ctypes.data, table.entries.shape[0],
            x.shape[1], _EDGE_MODEL_IDS[model.edge_coeff], _stream(dev))
    _build.check(lib, "ell_edge_apply", err)
    launch_counts["ell_edge_apply"] += 1
    return out


# -- the forces with the dim split over tp ranks --------------------------------


def _tp_kind(model: ForceModel, kind: str):
    """(kernel kind, model id) of ``model``'s edge or sample force."""
    _require(kind in ("edge", "sample"), f"bad force kind {kind!r}")
    fn, ids = ((model.edge_coeff, _EDGE_MODEL_IDS) if kind == "edge"
               else (model.sample_force, _SAMPLE_MODEL_IDS))
    _require(fn in ids, f"{model.name} has no separable {kind} force")
    return int(kind == "sample"), ids[fn]


def _check_tp_operands(x, xg, table: EdgeWorkTable):
    dev = x.device
    _check_x("x", x, xg, 2, 2)
    _require(xg.shape[1] == x.shape[1],
             f"xg rows of {xg.shape[1]} != x rows of {x.shape[1]}")
    _require(x.shape[0] == table.n_pad and xg.shape[0] == table.n_gather,
             f"x {tuple(x.shape)} and xg {tuple(xg.shape)} != the table's "
             f"{table.n_pad} and {table.n_gather} rows")
    _require(table.nbr.device == dev, f"table on {table.nbr.device}, x on "
                                      f"{dev}")
    if dev.type == "cuda":
        _check_cuda_operands(x.shape[1], x, xg)


def concat_work_tables(tables) -> tuple:
    """``(table, views)``: one work table over the entries of ``tables``
    laid end to end (each table's ids, deg and xi_row after those of the
    tables before it, its entries' rows, slots and output rows moved past
    theirs), and each of ``tables`` again as views into the new table's
    arrays, so that writing a view's ids writes the new table's.  The sync
    trainer's tp iteration makes one ``tp_pair_partial`` launch over its
    attraction's and repulsion's tables so, and a ``tp_pair_force`` launch
    for each on its slice of the scalars (a view's slots start at the
    sum of the slots before it).  The tables must index the same x and
    gather table; raises if their entries pass the ``_MAX_ENTRIES`` a
    launch takes, never splitting them."""
    _require(len(tables) > 0, "no tables to lay end to end")
    n_pad, n_gather = tables[0].n_pad, tables[0].n_gather
    _require(all((t.n_pad, t.n_gather) == (n_pad, n_gather) for t in tables),
             "the tables must index the same x and gather table")
    n = sum(t.entries.shape[0] for t in tables)
    _require(n <= _MAX_ENTRIES,
             f"the tables hold {n} entries; one launch takes at most "
             f"{_MAX_ENTRIES} (csrc/common.cuh::kMaxEntries)")
    nbr = torch.cat([t.nbr for t in tables])
    deg = torch.cat([t.deg for t in tables])
    xi_row = torch.cat([t.xi_row for t in tables])
    entries, views, rows, slots, out_rows = [], [], 0, 0, 0
    for t in tables:
        entries.append(t.entries + np.array([rows, slots, out_rows, 0, 0]))
        r, k = t.deg.shape[0], t.nbr.shape[0]
        views.append(dataclasses.replace(
            t, nbr=nbr[slots: slots + k], deg=deg[rows: rows + r],
            xi_row=xi_row[rows: rows + r]))
        rows, slots, out_rows = rows + r, slots + k, out_rows + t.out_rows
    return EdgeWorkTable(
        nbr=nbr, deg=deg, xi_row=xi_row,
        entries=np.ascontiguousarray(np.concatenate(entries), dtype=np.int64),
        n_pad=n_pad, out_rows=out_rows, n_gather=n_gather,
        partial=any(t.partial for t in tables)), views


def tp_pair_partial_plain(model: ForceModel, x, xg,
                          table: EdgeWorkTable) -> torch.Tensor:
    """[slots] f32: each slot's share of its pair's scalar from these
    columns (x_i · xg_j for the dot models, else |x_i - xg_j|²), 0 in the
    padded slots."""
    part = torch.zeros(table.nbr.shape[0], dtype=torch.float32,
                       device=x.device)
    for rb, nb, _, rows, width in table.entries.tolist():
        nbr = table.nbr[nb: nb + rows * width].view(rows, width)
        deg = table.deg[rb: rb + rows]
        xi = x[table.xi_row[rb: rb + rows].long()].float()[:, None, :]
        xj = xg[nbr.long()].float()
        v = xi * xj if model.a_kind == "dot" else (xi - xj) ** 2
        part[nb: nb + rows * width] = torch.where(
            _slot_mask(nbr, deg)[:, :, 0], v.sum(dim=-1), 0.0).reshape(-1)
    return part


def tp_pair_force_plain(model: ForceModel, kind: str, x, xg,
                        table: EdgeWorkTable, a, invd, step,
                        out: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """[out_rows, D]: per entry, the model's ``kind`` force summed over the
    slots (``ell_edge_force_terms`` or ``ell_sample_force_terms``), each
    pair's scalar taken from ``a`` [slots] instead of these columns.
    Writes into ``out`` if given."""
    if out is None:
        out = torch.zeros((table.out_rows, x.shape[1]), dtype=x.dtype,
                          device=x.device)
    for (rb, nb, ob, rows, width), (nbr, deg, xi_row, _) in zip(
            table.entries.tolist(), table.parts()):
        av = a[nb: nb + rows * width].view(rows, width, 1)
        rsum = lambda _v, av=av: av  # noqa: E731 (the reduced scalars)
        terms = (ell_edge_force_terms(model, x, xg, nbr, deg, xi_row, invd,
                                      step, rsum) if kind == "edge" else
                 ell_sample_force_terms(model, x, xg, nbr, deg, xi_row, step,
                                        rsum))
        out[ob: ob + rows] = terms.sum(dim=1)
    return out


def tp_pair_partial(model: ForceModel, x, xg,
                    table: EdgeWorkTable) -> torch.Tensor:
    """This rank's share of every slot's pair scalar, for forces whose dim
    is split over tp ranks: [slots] f32, to be summed over the ranks (an
    ``all_reduce``) and passed to ``tp_pair_force``.

    x [table.n_pad, d] f32, bf16 or f16 and xg [table.n_gather, d] (of
    any of them with an f32 x, else of x's dtype; the gather table) hold
    this rank's d columns.  The scalars depend on the model's ``a_kind``
    alone, so one table may hold the entries of several forces
    (``concat_work_tables``).
    """
    _check_tp_operands(x, xg, table)
    if x.device.type == "cpu":
        return tp_pair_partial_plain(model, x, xg, table)
    dev = x.device
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    part = torch.empty(table.nbr.shape[0], dtype=torch.float32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_tp_pair_partial(
            x.data_ptr(), xg.data_ptr(), _code(xg), _code(x),
            table.nbr.data_ptr(), table.deg.data_ptr(),
            table.xi_row.data_ptr(), part.data_ptr(), table.entries.ctypes.data,
            table.entries.shape[0], x.shape[1], int(model.a_kind == "dot"),
            _stream(dev))
    _build.check(lib, "tp_pair_partial", err)
    launch_counts["tp_pair_partial"] += 1
    return part


def tp_pair_force(model: ForceModel, kind: str, x, xg, table: EdgeWorkTable,
                  a, invd, step, out: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The ``kind`` force over ``table`` on this rank's columns, from the
    pair scalars ``a`` [slots] f32 reduced over the tp ranks
    (``tp_pair_partial``'s, summed; f32 whatever X's dtype).  invd
    [table.n_pad] in x's dtype (read by the sigmoid edge forces).  Writes
    into ``out`` [table.out_rows, d] of x's dtype if given; returns it.
    """
    k, mid = _tp_kind(model, kind)
    _check_tp_operands(x, xg, table)
    dev = x.device
    _check("a", a, (torch.float32,), 1, dev)
    _check("invd", invd, (x.dtype,), 1, dev)
    _require(a.shape[0] == table.nbr.shape[0], "a must hold one scalar per "
                                               "slot of the table")
    _require(invd.shape == (x.shape[0],), "invd must have one entry per x row")
    _require(out is not None or not table.partial,
             "a partial table needs out")
    out = _edge_out(out, table.out_rows, x)
    if dev.type == "cpu":
        return tp_pair_force_plain(model, kind, x, xg, table, a, invd, step,
                                   out=out)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _check_aligned(out)
    fn = model.edge_coeff if kind == "edge" else model.sample_force
    lib = _build.load_library()
    step = _step_scalar(step, dev)
    with torch.cuda.device(dev):
        err = lib.f2v_tp_pair_force(
            x.data_ptr(), xg.data_ptr(), _code(xg), _code(x),
            table.nbr.data_ptr(), table.deg.data_ptr(),
            table.xi_row.data_ptr(), invd.data_ptr(), _table_ptr(fn, dev),
            a.data_ptr(), step.data_ptr(), out.data_ptr(),
            table.entries.ctypes.data, table.entries.shape[0], x.shape[1],
            k, mid, _stream(dev))
    _build.check(lib, "tp_pair_force", err)
    launch_counts["tp_pair_force"] += 1
    return out


# -- the walk engine -----------------------------------------------------------


def walk_steps_plain(r, walk_db, walk_pool) -> torch.Tensor:
    """[rows, L] int32: ``walk_steps`` in torch ops (the sync trainer's
    engine loop before the kernel).  Row i's walk starts at i; step k
    fetches the current rows' (deg, base) with one row gather and moves to
    ``walk_pool[base + r[k, i] % max(deg, 1)]``, or stays put where deg is
    0."""
    cur = torch.arange(r.shape[1], dtype=torch.int32, device=r.device)
    steps = []
    for rk in r:
        db = walk_db.index_select(0, cur)
        d, base = db[:, 0], db[:, 1]
        nxt = walk_pool.index_select(0, base + rk % d.clamp(min=1))
        cur = torch.where(d > 0, nxt, cur)
        steps.append(cur)
    return torch.stack(steps, dim=1)


def walk_steps(r, walk_db, walk_pool) -> torch.Tensor:
    """Every row's uniform walk of L steps, in one launch
    (``csrc/walk_steps.cu``): [rows, L] int32, the ids of
    ``walk_steps_plain`` bit for bit (integer arithmetic alone).

    r [L, rows] int32, the steps' draws in [0, 2**31 - 1) (one torch draw
    a step, so that the walks follow the caller's generator); walk_db
    [rows, 2] int32, each row's (deg, base); walk_pool [slots] int32, the
    neighbour slots, row v's at ``base[v] + [0, deg[v])`` (``train/sync.py::
    build_walk_tables``).  The kernel does not bounds-check the tables'
    ids."""
    dev = r.device
    _check("r", r, (torch.int32,), 2, dev)
    _check("walk_db", walk_db, (torch.int32,), 2, dev)
    _check("walk_pool", walk_pool, (torch.int32,), 1, dev)
    steps, rows = r.shape
    _require(steps >= 1, "a walk takes at least one step")
    _require(walk_db.shape == (rows, 2),
             f"walk_db {tuple(walk_db.shape)} != {(rows, 2)}: one (deg, "
             "base) a row of r")
    if dev.type == "cpu":
        return walk_steps_plain(r, walk_db, walk_pool)
    _require(dev.type == "cuda", f"no kernel for device {dev}")
    _require(walk_db.data_ptr() % 8 == 0, "walk_db must be 8-byte aligned")
    walks = torch.empty((rows, steps), dtype=torch.int32, device=dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        err = lib.f2v_walk_steps(r.data_ptr(), walk_db.data_ptr(),
                                 walk_pool.data_ptr(), walks.data_ptr(),
                                 rows, steps, _stream(dev))
    _build.check(lib, "walk_steps", err)
    launch_counts["walk_steps"] += 1
    return walks
