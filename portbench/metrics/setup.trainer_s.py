"""setup.trainer_s: host seconds of the runner's constructor (the sync
layout or the batch layout, and the device tables), from the harness's
span around it."""


def read(ctx):
    return ctx["spans"].get("setup.trainer")
