"""NEXMark q5, hot items: the auctions with the most bids in the window.

    SELECT auction, num FROM (SELECT auction, count(*) AS num FROM bid
    GROUP BY auction) WHERE num >= (SELECT max(num) FROM ...)
"""

import numpy as np


def reference(tables, config):
    auction = tables["bid"]["auction"].astype(np.int64)
    if not len(auction):
        return {"auction": np.empty(0, np.int64), "num": np.empty(0, np.int64)}
    lo = auction.min()
    counts = np.bincount(auction - lo)
    top = counts.max()
    hot = np.flatnonzero(counts == top)
    return {"auction": hot + lo, "num": np.full(len(hot), top, np.int64)}


def least_bytes(tables, config, out):
    """The auction column read once, the count table over the auctions'
    id span written once (int32 counts), the result rows written once."""
    auction = tables["bid"]["auction"]
    if not len(auction):
        return 0
    span = int(auction.max()) - int(auction.min()) + 1
    rows = len(out["auction"])
    return 4 * len(auction) + 4 * span + 8 * rows
