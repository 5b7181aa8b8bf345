"""device_idle_pct (device trace, device): the share of the traced slice in
which no operation ran on the card (the union of the profiler's device
intervals against the slice's length)."""


def read(run):
    s = run.summary
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
