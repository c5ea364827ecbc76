"""train.idle_pct: the share of the traced training window in which the
card ran no operation, 100 * (1 - busy / window)."""


def read(t):
    if "crops" not in t.counters or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
