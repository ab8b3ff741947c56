"""Force2Vec's iterations in plain PyTorch: the reference the benchmark
judges the program by.

It imports nothing of the program.  It works each iteration out again
from the benchmark's own CSR graph (``graphgen.csr``), initial X and
seed, with frozen copies of the rules that decide what an iteration
computes:

* the model's part, in ``models/<model>.py`` (found by the
  configuration's ``model``; a model with no file there is refused): its
  default step, its init, its edge and sample forces, the element types of
  X it follows, and the operations of a force; a model whose update is not
  the additive one below (the energy update, a decaying step) defines its
  own ``Reference`` there;
* the draw rule: iteration ``it`` of a run seeded ``seed`` draws its
  negative ids with ``torch.randint(0, n - 1, shape, dtype=int32)`` from a
  generator on X's device seeded ``iteration_seed(seed, it)``; the shape
  is ``[ceil(n_pad / batch), ns]`` (one set a ``batch``-row group) or
  ``[n_pad, ns]`` (one set a row, ``-bs 1``) on the sync schedule and
  ``[ceil(n / batch), ns]`` (one set a batch) on the batch schedule;
* the sync schedule's row order: rows sorted by degree, ascending and
  stable; ids and groups are in that order; ``n_pad`` covers ``n`` and
  every width bucket's rows, each bucket rounded up to 8 rows (widths 8 to
  256 in the ``mult8`` ladder);
* the schedules, with a constant step and X's update the sum of the
  iteration's forces: sync reads every neighbour and negative from the
  iteration's replica of X (X cast to bf16 when the cell names a bf16
  gather dtype), x_i from X, and adds the whole update once; batch takes
  batches of ``batch`` rows in id order, each reading the X its
  predecessors left, and adds its rows' update at its end.

Everything is float32, as the configuration states, with TF32 off.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

_MODEL_DIR = Path(__file__).resolve().parent / "models"
_MODELS: dict = {}
# the sync layout's bucket widths: 8 up to the hub width 256 by quarter
# octaves kept to multiples of 8, each bucket's rows rounded up to 8
_MIN_WIDTH, _HUB_WIDTH, _ROW_ALIGN = 8, 256, 8
# edges a chunk of the attraction holds ([E, D] f32 temporaries)
_CHUNK_EDGES = 1 << 20


def iteration_seed(seed: int, it: int) -> int:
    """The seed of iteration ``it``'s draws in a run seeded ``seed``."""
    state = np.random.SeedSequence((seed % 2**64, it)).generate_state(
        2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


def draw(seed: int, it: int, shape: tuple, n: int, device) -> torch.Tensor:
    """Iteration ``it``'s negative ids, ``shape`` int32 in ``[0, n - 1)``."""
    gen = torch.Generator(device=device).manual_seed(iteration_seed(seed, it))
    return torch.randint(0, max(n - 1, 1), shape, generator=gen,
                         dtype=torch.int32, device=device)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _widths() -> list:
    widths, w = [], _MIN_WIDTH
    while w < _HUB_WIDTH:
        widths.append(w)
        w += max(8, (w // 4 // 8) * 8)
    return widths + [_HUB_WIDTH]


def sync_order(deg: np.ndarray) -> tuple:
    """``(perm, n_pad)``: the sync schedule's rows in order (``perm[r]`` is
    row r's vertex) and its padded row count."""
    n = len(deg)
    perm = np.argsort(deg, kind="stable")
    deg_sorted = deg[perm]
    extent, i = n, 0
    for w in _widths():
        j = int(np.searchsorted(deg_sorted, w, side="right"))
        if j > i:
            extent = max(extent, i + _round_up(j - i, _ROW_ALIGN))
            i = j
    return perm, _round_up(extent, _ROW_ALIGN)


def model(name: str):
    """The module ``models/<name>.py``; ``KeyError`` where the reference
    has no such model."""
    if name not in _MODELS:
        path = _MODEL_DIR / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"the reference has no model {name!r}: add "
                           f"portbench/reference/models/{name}.py")
        spec = importlib.util.spec_from_file_location(
            "portbench_reference_model_" + name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODELS[name] = module
    return _MODELS[name]


def build(rowptr, colids, config: dict, traffic: dict, device):
    """The reference for ``config["model"]``: its module's own
    ``Reference`` where it defines one, else the generic schedules below
    with its forces."""
    cls = getattr(model(config["model"]), "Reference", Reference)
    return cls(rowptr, colids, config, traffic, device)


class Reference:
    """The reference on ``device`` for one graph and configuration.

    ``rowptr`` ``[n + 1]``, ``colids`` ``[nnz]``: the benchmark's CSR (each
    undirected edge both ways, rows sorted); ``config``: ``model``,
    ``ns``, ``batch`` and ``lr``; ``traffic``: ``schedule``, ``bs``,
    ``gather_dtype`` and ``x_dtype`` (float32 where it is absent)."""

    def __init__(self, rowptr: np.ndarray, colids: np.ndarray, config: dict,
                 traffic: dict, device):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.n = len(rowptr) - 1
        self.rowptr = np.asarray(rowptr, dtype=np.int64)
        deg = np.diff(self.rowptr)
        m = model(config["model"])
        x_dtype = traffic.get("x_dtype", "float32")
        if x_dtype not in m.X_DTYPES:
            raise NotImplementedError(
                f"the reference of {config['model']!r} follows X in "
                f"{', '.join(m.X_DTYPES)}, not {x_dtype}")
        self.edge_force, self.repulsion = m.edge_force, m.sample_force
        self.ns, self.batch = int(config["ns"]), int(config["batch"])
        lr = m.DEFAULT_LR if config["lr"] is None else float(config["lr"])
        self.step = float(np.float32(lr))
        self.schedule = traffic["schedule"]
        self.per_vertex = int(traffic["bs"]) == 1
        gd = traffic["gather_dtype"]
        self.gather_dtype = None if gd is None else getattr(torch, gd)
        dev = self.device
        self.colids = torch.as_tensor(np.asarray(colids, dtype=np.int64),
                                      device=dev)
        self.deg = torch.as_tensor(deg, device=dev)
        self.src = torch.repeat_interleave(
            torch.arange(self.n, device=dev), self.deg)
        # row chunks of about _CHUNK_EDGES edges each
        cuts = np.unique(np.concatenate([
            [0], np.searchsorted(self.rowptr, np.arange(
                0, self.rowptr[-1], _CHUNK_EDGES), side="right") - 1,
            [self.n]]))
        self.chunks = list(zip(cuts[:-1].tolist(), cuts[1:].tolist()))
        if self.schedule == "sync":
            perm, n_pad = sync_order(deg)
            self.n_pad = n_pad
            self.perm = torch.as_tensor(perm, device=dev)
            inv = np.empty(self.n, dtype=np.int64)
            inv[perm] = np.arange(self.n)
            self.row_of = torch.as_tensor(inv, device=dev)
            self.neg_shape = ((n_pad, self.ns) if self.per_vertex
                              else (-(-n_pad // self.batch), self.ns))
        elif self.schedule == "batch":
            self.neg_shape = (-(-self.n // self.batch), self.ns)
        else:
            raise ValueError(f"unknown schedule {self.schedule!r}")

    def run(self, x0: torch.Tensor, seed: int, iters: int) -> list:
        """X after each of the first ``iters`` iterations of a run seeded
        ``seed`` from ``x0`` (``[n, dim]``), as host f32 tensors."""
        x = x0.to(self.device, torch.float32).clone()
        out = []
        for it in range(iters):
            negs = draw(seed, it, self.neg_shape, self.n, self.device)
            if self.schedule == "sync":
                self._sync(x, negs)
            else:
                self._batch(x, negs)
            out.append(x.to("cpu", copy=True))
        return out

    def _attraction(self, x, xg, r0: int, r1: int) -> torch.Tensor:
        """Rows ``[r0, r1)``'s summed edge forces, x_i from ``x`` and x_j
        from ``xg``."""
        e0, e1 = int(self.rowptr[r0]), int(self.rowptr[r1])
        f = self.edge_force(x[self.src[e0:e1]], xg[self.colids[e0:e1]],
                            self.step)
        return torch.segment_reduce(f, "sum", lengths=self.deg[r0:r1],
                                    axis=0)

    def _sync(self, x: torch.Tensor, negs: torch.Tensor) -> None:
        xg = (x if self.gather_dtype is None
              else x.to(self.gather_dtype).float())
        upd = torch.empty_like(x)
        for r0, r1 in self.chunks:
            upd[r0:r1] = self._attraction(x, xg, r0, r1)
        # each vertex's negatives, as vertex ids: its row's set, or its
        # group's
        sets = self.row_of if self.per_vertex else self.row_of // self.batch
        for r0, r1 in self.chunks:
            ids = self.perm[negs[sets[r0:r1]].long()]  # [R, ns]
            upd[r0:r1] += self.repulsion(x[r0:r1, None, :], xg[ids],
                                         self.step).sum(dim=1)
        x.add_(upd)

    def _batch(self, x: torch.Tensor, negs: torch.Tensor) -> None:
        b = self.batch
        for k in range(-(-self.n // b)):
            r0, r1 = k * b, min(self.n, (k + 1) * b)
            e0, e1 = int(self.rowptr[r0]), int(self.rowptr[r1])
            xr = x[r0:r1]
            if e1 > e0:
                f = self.edge_force(xr[self.src[e0:e1] - r0],
                               x[self.colids[e0:e1]], self.step)
                acc = torch.segment_reduce(f, "sum",
                                           lengths=self.deg[r0:r1], axis=0)
            else:
                acc = torch.zeros_like(xr)
            s = x[negs[k].long()]  # [ns, D]
            acc += self.repulsion(xr[:, None, :], s[None],
                                  self.step).sum(dim=1)
            xr.add_(acc)
