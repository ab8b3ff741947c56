"""setup.warmup_s: host seconds of the eager iteration before the
iteration's CUDA-graph capture (its first launch of each kernel), the self
time of the program's span ``span.warmup``: the kernel library's load
inside it is left out (``setup.kernels_s``); nothing where the program
records no such span."""


def read(ctx):
    try:
        from force2vec_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    span = snapshot()["spans"].get("span.warmup")
    return None if span is None else span["self_s"]
