"""YSB: the views per campaign in the window.

    SELECT campaign_id, count(*) FROM ad_event JOIN campaign
    ON ad_id = c_ad_id WHERE event_type = 'view' GROUP BY campaign_id

``event_type`` 0 is 'view'.
"""

import numpy as np

VIEW = 0


def _campaign_of(tables):
    """ad id -> campaign id from the window's campaign table (-1: none)."""
    camp = tables["campaign"]
    lut = np.full(int(camp["c_ad_id"].max()) + 1, -1, np.int64)
    lut[camp["c_ad_id"]] = camp["campaign_id"]
    return lut


def reference(tables, config):
    ev = tables["ad_event"]
    lut = _campaign_of(tables)
    ad = ev["ad_id"][ev["event_type"] == VIEW].astype(np.int64)
    ad = ad[(ad >= 0) & (ad < len(lut))]
    camp = lut[ad]
    counts = np.bincount(camp[camp >= 0])
    hit = np.flatnonzero(counts)
    return {"campaign_id": hit.astype(np.int64), "count": counts[hit]}


def least_bytes(tables, config, out):
    """The event type and ad id columns read once, the campaign table read
    once, the count table (one int32 slot a campaign) and the result rows
    written once."""
    n = len(tables["ad_event"]["ad_id"])
    camp = len(tables["campaign"]["c_ad_id"])
    rows = len(out["campaign_id"])
    return 8 * n + 8 * camp + 4 * config["generator"]["campaigns"] + 16 * rows
