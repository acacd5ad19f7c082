"""device_idle_pct (%, device trace): the share of the traced window in which
the card ran neither a kernel nor a copy nor a set (the union of the
profiler's device intervals). None without device entries."""


def read(rec):
    tl = rec.timeline
    if tl is None or not tl.ops or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s() / tl.window_s)
