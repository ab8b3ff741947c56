"""setup.graph_s: host seconds of the program's ``Graph.from_coo`` on the
generated edges (the sort into CSR order and the row offsets), the self
time of its span ``graph.from_coo``; nothing where the program records no
such span."""


def read(ctx):
    try:
        from force2vec_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    span = snapshot()["spans"].get("graph.from_coo")
    return None if span is None else span["self_s"]
