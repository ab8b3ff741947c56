"""device_ops_per_iter: operations the card ran in the traced window
(kernels, copies and fills, those of each graph replay one by one), per
iteration."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["device_ops"] == 0:
        return None
    return tr["device_ops"] / tr["iterations"]
