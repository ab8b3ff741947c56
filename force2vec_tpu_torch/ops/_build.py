"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own nvcc, all at once, and
linked into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes).
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
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    # x, xg, xg_is_bf16, nbr, deg, xi_row, invd, step, out, table (host
    # [n_entries, 5] int64), n_entries, dim, model, stream
    "f2v_ell_edge_force": (_P, _P, _I, _P, _P, _P, _P, _F, _P, _P, _I, _I,
                           _I, _P),
    # xi, sg, sg_is_bf16, step, out, rows, group, ns, dim, model, stream
    "f2v_grouped_rep_force": (_P, _P, _I, _F, _P, _I, _I, _I, _I, _I, _P),
    # x, xg, xg_is_bf16, idx, deg, xi_row, step, out, accumulate, rows,
    # width, dim, model, stream
    "f2v_ell_sample_force": (_P, _P, _I, _P, _P, _P, _F, _P, _I, _I, _I, _I,
                             _I, _P),
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


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
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
    one nvcc per source, all at once, then one link.  Returns the library's
    path.  The compilers' output goes to a ``.log`` beside it
    (``-Xptxas=-v``: registers, shared memory and spills per kernel)."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a temporary directory and rename, so a concurrent or cut-off
    # build never leaves a half-written library under the final name
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(sources(), objs)])
        so = os.path.join(tmp, lib.name)
        _run([[nvcc, "-shared", "-o", so, *objs]])
        lib.with_suffix(".log").write_text(log)
        os.replace(so, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
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
