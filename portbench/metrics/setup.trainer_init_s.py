"""setup.trainer_init_s: host seconds of the runner's constructor, the
total time of the program's span ``trainer.init`` (the layout, the device
tables, and whatever CUDA set-up it triggers): the inside twin of the
harness's ``setup.trainer_s``; nothing where the program records no such
span."""


def read(ctx):
    try:
        from force2vec_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    span = snapshot()["spans"].get("trainer.init")
    return None if span is None else span["total_s"]
