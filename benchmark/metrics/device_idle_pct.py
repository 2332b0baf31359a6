"""device_idle_pct: 100 x (1 - the union of the device operations'
intervals over the traced frames' span) (benchmark/trace.py)."""


def read(window, cvo):
    t = window.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
