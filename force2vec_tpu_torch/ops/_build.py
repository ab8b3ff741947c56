"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc, all at once (the
force sources once per element-type pair, ``splits``), and linked into
one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes).
The library lands in ``ops/build/`` under a name keyed by a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
loaded as is.  ``nvcc`` is ``$CUDA_HOME/bin/nvcc``, else
``/usr/local/cuda/bin/nvcc``, else the one on ``PATH``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from force2vec_tpu_torch.utils.profiling import counter, span

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# The force sources hold hundreds of kernel instances each.  Each is
# compiled once per (gather, X) element-type pair its kernels take
# (dtype_pairs; -DF2V_GATHER and -DF2V_X name the pair), an object each,
# and once with neither for its C entry point, so that no nvcc job holds
# more than one pair's instances: one nvcc a source takes twice the wall
# time (scripts/time_kernel_build.py).  grouped_rep_force.cu's sample type
# is a runtime code, so it is compiled once per X type.  ell_edge_apply.cu
# takes only the pairs of an f32 X beside a 2-byte replica (apply_pairs).
_PAIR_SOURCES = ("ell_edge_force.cu", "ell_sample_force.cu",
                 "tp_pair_force.cu")
_X_SOURCES = ("grouped_rep_force.cu",)
_APPLY_SOURCES = ("ell_edge_apply.cu",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    # x, xg, xg_dtype, x_dtype (DType codes; x, invd and out in x's),
    # nbr, deg, xi_row, invd, sm_table, step (a device f32 scalar), out,
    # table (host [n_entries, 5] int64), n_entries, dim, model, stream
    "f2v_ell_edge_force": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _P),
    # xi, sg, sg_dtype, xi_dtype (xi, out and upd in xi's), sm_table,
    # step (a device f32 scalar), out, upd, part (f32 scratch of a chunked
    # sum), xg_next (apply: the next replica, or null), xg_next_dtype, mode
    # (0 store, 1 add, 2 apply), rows, group, ns, dim, model, stream
    "f2v_grouped_rep_force": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _I, _P),
    # x, xg, xg_dtype, x_dtype (a pair of apply_pairs), nbr, deg, xi_row,
    # invd, sm_table, step (a device f32 scalar), out, negs, upd, xg_next
    # (the next replica, or null), apply_mask, group, ns, table (host
    # [n_entries, 5] int64), n_entries, dim, model, stream
    "f2v_ell_edge_apply": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, ctypes.c_uint64, _I, _I, _P, _I, _I, _I,
                           _P),
    # x, xg, xg_dtype, x_dtype (x and out in x's), idx, deg, xi_row,
    # sm_table, step (a device f32 scalar), out, accumulate, rows, width,
    # dim, model, stream
    "f2v_ell_sample_force": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _P),
    # x, xg, xg_dtype, x_dtype, nbr, deg, xi_row, part, table (host
    # [n_entries, 5] int64), n_entries, dim, dot, stream
    "f2v_tp_pair_partial": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
                            _P),
    # x, xg, xg_dtype, x_dtype (x, invd and out in x's), nbr, deg,
    # xi_row, invd, sm_table, a, step (a device f32 scalar), out, table,
    # n_entries, dim, kind, model, stream
    "f2v_tp_pair_force": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _P),
    # r, db, pool, walks, rows, steps, stream
    "f2v_walk_steps": (_P, _P, _P, _P, _I, _I, _P),
    # the benchmark probes (probe_kernels.py)
    # tbl, tbl_is_bf16, idx, out, rows, k, dim, stages, stream
    "f2v_take_sum": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    # tbl_is_bf16, stages, res (int[2]: shared memory bytes per block,
    # blocks per SM)
    "f2v_take_sum_occupancy": (_I, _I, _P),
    # tbl, idx, out, rows, row_bytes, stream
    "f2v_resident_gather": (_P, _P, _P, _I, _I, _P),
    # tile, tile_is_bf16, partial, out, rows, dim, blocks, rows_per_block,
    # stream
    "f2v_read_sum": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    # table (host [n_entries, 6] int64), n_entries, xj_is_bf16, step, out,
    # dim, stream
    "f2v_tile_force_tc": (_P, _I, _I, _F, _P, _I, _P),
    # xj_is_bf16, res (int[2], as for take_sum)
    "f2v_tile_force_tc_occupancy": (_I, _P),
}


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def _pairs(macro: str) -> tuple:
    """The (gather, X) DType code pairs that csrc/common.cuh's ``macro``
    lists."""
    text = (CSRC_DIR / "common.cuh").read_text()
    line = re.search(rf"^#define {macro}\(PAIR\) (.*)$", text, re.M)
    return tuple((int(g), int(x))
                 for g, x in re.findall(r"PAIR\((\d+), (\d+)\)", line[1]))


@functools.lru_cache(maxsize=None)
def dtype_pairs() -> tuple:
    """The (gather, X) DType code pairs the force kernels take (0 f32,
    1 bf16, 2 f16): csrc/common.cuh::F2V_DTYPE_PAIRS, the one list."""
    return _pairs("F2V_DTYPE_PAIRS")


@functools.lru_cache(maxsize=None)
def apply_pairs() -> tuple:
    """The pairs the fused launch (``ell_edge_apply``) takes: an f32 X
    beside a bf16 or f16 replica, csrc/common.cuh::F2V_APPLY_PAIRS."""
    return _pairs("F2V_APPLY_PAIRS")


def splits(name: str) -> tuple:
    """The define sets a force source is compiled with, one object each
    (none for a source compiled once)."""
    pairs = dtype_pairs()
    if name in _PAIR_SOURCES:
        return tuple((f"-DF2V_GATHER={g}", f"-DF2V_X={x}") for g, x in pairs)
    if name in _X_SOURCES:
        return tuple((f"-DF2V_X={x}",) for x in sorted({x for _, x in pairs}))
    if name in _APPLY_SOURCES:
        return tuple((f"-DF2V_GATHER={g}", f"-DF2V_X={x}")
                     for g, x in apply_pairs())
    return ()


def jobs() -> list:
    """``(source, defines, object stem)`` of each nvcc job: every source
    once, and the force sources once more per define set (``splits``)."""
    out = []
    for src in sources():
        out.append((src, (), src.stem))
        out += [(src, d, f"{src.stem}_{k}")
                for k, d in enumerate(splits(src.name))]
    return out


def library_path() -> Path:
    """Where the library for the current sources, headers, flags and
    jobs lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr([(s.name, d) for s, d, _ in jobs()]).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libf2v_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return nvcc


def _run(cmds) -> str:
    """Start every command at once and wait for all of them; raise if one
    failed; return their output, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (_, stderr) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stderr}")
    return "".join(stdout + stderr for stdout, stderr in outs)


def build() -> Path:
    """Compile the kernels unless the library for these sources exists:
    one nvcc per job (``jobs``), all at once, then one link.  Returns the
    library's path.  The compilers' output goes to a ``.log`` beside it
    (``-Xptxas=-v``: registers, shared memory and spills per kernel).  The
    counter ``kernels.nvcc_jobs`` gains the compile jobs run (0 where the
    library was there; the link is not counted)."""
    lib = library_path()
    if lib.exists():
        counter("kernels.nvcc_jobs", 0)
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory and rename, so a concurrent or cut-off
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, cmds = [], []
        for src, defines, stem in jobs():
            objs.append(os.path.join(tmp, stem + ".o"))
            cmds.append([nvcc, *NVCC_FLAGS, *defines, "-c", "-o", objs[-1],
                         str(src)])
        counter("kernels.nvcc_jobs", len(cmds))
        log = _run(cmds)
        so = os.path.join(tmp, lib.name)
        _run([[nvcc, "-shared", "-o", so, *objs]])
        lib.with_suffix(".log").write_text(log)
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
@span("kernels.load")
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature
    (the span ``kernels.load``: the sources' hash, a build, the load)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.f2v_error_string.argtypes = [ctypes.c_int]
    lib.f2v_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.f2v_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
