"""The window's kernels against the card's memory bandwidth (%): the least
bytes the window's operators need (the query's reference module counts
them from the window's shapes) over the card's peak bandwidth, divided by
the summed device time of the window's kernels in the profiled stretch
(copies and sets excluded).  No kernel is named, so a change that fuses
or replaces kernels moves the time and not the count.  None where the
card is not in ``peaks.json`` or the trace holds no kernel."""


def read(rec):
    p = rec.profile
    if not p or not rec.peaks or not p["kernel_s"] or not rec.least_bytes:
        return None
    least_s = rec.least_bytes / rec.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (p["kernel_s"] / rec.profile_windows)
