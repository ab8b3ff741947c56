"""A profiled window reduced to what the per-layer metrics read.

``summarize`` takes the events of a ``torch.profiler`` run in which the
harness marked its window with a ``record_function`` span: the device
operations inside the span (kernels, copies and fills, each replay's
kernels among them), the union of their intervals (busy time), their
count, their time by name, and the idle gaps between them labelled by
what the host was doing when each began (the innermost host event open
then, or ``python`` outside any).
"""

from __future__ import annotations

import bisect
import collections

WINDOW = "portbench.window"
# host events searched back from a gap for one still open (the harness
# opens no span inside its window, so the open one is among the last)
_LOOK_BACK = 64


def _union(intervals: list) -> tuple:
    """``(busy, gaps)`` of sorted ``(start, end)`` intervals: the length
    of their union and the gaps between its pieces."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _label(host: list, starts: list, t: float) -> str:
    """The innermost host event open at ``t``: the latest-started one that
    has not ended, among the ``_LOOK_BACK`` that began last (``host``
    sorted by start, ``starts`` its starts)."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - _LOOK_BACK, -1), -1):
        if host[j][1] > t:
            return host[j][2]
    return "python"


def short_name(name: str) -> str:
    """A device operation's name without its argument list and return
    type, at most 160 characters."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0][:160]


def summarize(device: list, host: list) -> dict:
    """``device``: ``(start, end, name)`` of every device-side event;
    ``host``: ``(start, end, name)`` of every host event, the harness's
    window span among them (seconds, one clock).  A device-side event that
    bears a host event's name is that span's mirror on the device timeline
    (a ``record_function`` annotation) and no operation.  Returns
    ``window_s``, ``busy_s``, ``device_ops`` (operations that began in the
    window), ``by_name`` (device seconds a short name, clipped to the
    window) and ``gaps`` (idle seconds by host label)."""
    win = [(s, e) for s, e, name in host if name == WINDOW]
    if len(win) != 1:
        raise ValueError(f"{len(win)} {WINDOW!r} spans in the trace")
    w0, w1 = win[0]
    spans = {name for _, _, name in host}
    ops = sorted((max(s, w0), min(e, w1), short_name(name))
                 for s, e, name in device
                 if w0 <= s < w1 and name not in spans)
    by_name = collections.Counter()
    for s, e, name in ops:
        by_name[name] += e - s
    busy, gaps = _union([(s, e) for s, e, _ in ops])
    if ops:  # the window's idle edges
        gaps = [(w0, ops[0][0])] + gaps + [(max(e for _, e, _ in ops), w1)]
    inner = sorted((s, e, name) for s, e, name in host if name != WINDOW)
    starts = [s for s, _, _ in inner]
    idle = collections.Counter()
    for g0, g1 in gaps:
        if g1 > g0:
            idle[_label(inner, starts, g0)] += g1 - g0
    return {"window_s": w1 - w0, "busy_s": busy, "device_ops": len(ops),
            "by_name": by_name, "gaps": idle}


def profiler_events(prof) -> tuple:
    """``(device, host)`` event lists, in seconds, of a finished
    ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        item = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
        if e.device_type == DeviceType.CUDA:
            device.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    return device, host
