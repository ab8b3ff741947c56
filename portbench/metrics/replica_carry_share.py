"""replica_carry_share: the share of the sync iteration's gathers that read
a replica the previous iteration's launches wrote, against those whose
replica was cast from X first (the program's counters ``replica.carried``
and ``replica.casts``), over the run, in percent: 100 x carried /
(carried + casts); nothing where the program counts neither."""


def read(ctx):
    try:
        from force2vec_tpu_torch.utils.profiling import snapshot
    except ImportError:
        return None
    counters = snapshot()["counters"]
    carried = counters.get("replica.carried")
    casts = counters.get("replica.casts")
    if carried is None and casts is None:
        return None
    total = (carried or 0) + (casts or 0)
    return 100.0 * (carried or 0) / total if total else None
