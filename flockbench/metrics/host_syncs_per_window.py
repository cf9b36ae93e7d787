"""The executor's reads of window flags on the host
(``LocalExecutor.host_syncs``), per window of the timed window: exact."""


def read(rec):
    if not rec.windows:
        return None
    return rec.counters["host_syncs"] / rec.windows
