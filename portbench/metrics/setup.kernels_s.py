"""setup.kernels_s: host seconds of the kernel library's load
(``ops/_build.py::load_library``: the sources' hash, a build where the
library is stale, ``dlopen`` and the signatures), the total time of the
program's span ``kernels.load``; nothing where the program records no
such span or loads no kernels."""


def read(ctx):
    try:
        from force2vec_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    span = snapshot()["spans"].get("kernels.load")
    return None if span is None else span["total_s"]
