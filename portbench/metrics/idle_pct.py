"""idle_pct: the share of the traced window in which no operation ran on
the card, 100 · (1 - busy / window)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["device_ops"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
