"""The share of the traced stretch in which no operation ran on the
device: one less the union of device-op intervals over the stretch."""


def read(rec):
    t = rec["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
