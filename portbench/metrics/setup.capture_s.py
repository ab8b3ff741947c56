"""setup.capture_s: host seconds of the iteration's CUDA-graph capture and
instantiation, the program's counter ``IterationGraph.capture_seconds``;
nothing where the run captured no graph."""


def read(ctx):
    return ctx["counters"].get("capture_seconds")
