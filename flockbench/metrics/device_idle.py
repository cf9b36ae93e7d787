"""The share of the profiled stretch in which the card runs no operation
(%): one minus the union of the device operations' intervals over the
stretch's length."""


def read(rec):
    p = rec.profile
    if not p or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
