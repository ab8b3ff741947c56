"""setup.layout_s: host seconds of the runner's layout on the host
(``SyncLayout.build`` or ``DeviceGraph.build``), the self time of the
program's span ``trainer.layout``; nothing where the program records no
such span."""


def read(ctx):
    try:
        from force2vec_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    span = snapshot()["spans"].get("trainer.layout")
    return None if span is None else span["self_s"]
