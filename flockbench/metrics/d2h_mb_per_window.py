"""Bytes copied from the card to the host per window (MB, 10^6 bytes), in
the profiled stretch: what the window's emission reads back, padding
included."""


def read(rec):
    p = rec.profile
    if not p or not rec.profile_windows:
        return None
    return p["d2h_bytes"] / rec.profile_windows / 1e6
