"""replay.host_us: host microseconds a replayed iteration (the step's and
the draws' preparation, the graph's launch, the launch counts), the total
time of the program's span ``span.replay`` over its counter
``span.replays``, over every replay of the run (set-up's, the untimed
lead's and the traced window's); nothing where the program records no
such span."""


def read(ctx):
    try:
        from force2vec_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    snap = snapshot()
    span = snap["spans"].get("span.replay")
    replays = snap["counters"].get("span.replays")
    if span is None or not replays:
        return None
    return 1e6 * span["total_s"] / replays
