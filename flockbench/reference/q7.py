"""NEXMark q7, highest bid: the bids at the window's highest price.

    SELECT auction, price, bidder, b_date_time FROM bid
    WHERE price = (SELECT max(price) FROM bid)
"""

import numpy as np

_COLS = ("auction", "price", "bidder", "b_date_time")


def reference(tables, config):
    bid = tables["bid"]
    price = bid["price"]
    if not len(price):
        return {c: np.empty(0, np.int64) for c in _COLS}
    top = np.flatnonzero(price == price.max())
    return {c: bid[c][top].astype(np.int64) for c in _COLS}


def least_bytes(tables, config, out):
    """The price column read once for the maximum; the result rows' four
    columns read and written once."""
    rows = len(out["price"])
    return 4 * len(tables["bid"]["price"]) + 2 * 16 * rows
