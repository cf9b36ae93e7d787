"""NEXMark q4, average price per category: the average winning price of
the window's auctions, per category, where an auction's winning price is
its highest bid placed between its start and its expiry.

    SELECT category, avg(final) FROM (
        SELECT max(price) AS final, category
        FROM auction JOIN bid ON a_id = auction
        WHERE b_date_time BETWEEN a_date_time AND expires
        GROUP BY a_id, category) AS Q
    GROUP BY category

Where this departs from the SQL:

* ``avg`` is the exact integer sum of the winning prices over their exact
  count, divided once in f64, as the program's sink divides it; so the
  comparison holds the average to its last bit.
* The inner grouping is by ``(a_id, category)``, as in the SQL; an auction
  id that repeats in a window with another category forms groups of its
  own, and every auction row with a matching id joins each bid.
"""

import numpy as np


def _empty():
    return {"category": np.empty(0, np.int64),
            "avg_final": np.empty(0, np.float64)}


def _join(a_id, auction):
    """(auction row, bid row) of every pair with ``a_id == auction``."""
    order = np.argsort(a_id, kind="stable")
    ids = a_id[order]
    lo = np.searchsorted(ids, auction, "left")
    hi = np.searchsorted(ids, auction, "right")
    n = hi - lo
    bid_row = np.repeat(np.arange(len(auction)), n)
    first = np.repeat(np.cumsum(n) - n, n)
    return order[np.repeat(lo, n) + np.arange(len(bid_row)) - first], bid_row


def _sums(tables):
    """(category, exact sum of its winning prices, their count), per
    category with a winner, or None where the window has none."""
    auc, bid = tables.get("auction"), tables.get("bid")
    if auc is None or bid is None or not len(auc["a_id"]) \
            or not len(bid["auction"]):
        return None
    a_row, b_row = _join(auc["a_id"].astype(np.int64),
                         bid["auction"].astype(np.int64))
    t = bid["b_date_time"][b_row]
    keep = (auc["a_date_time"][a_row] <= t) & (t <= auc["expires"][a_row])
    a_row, b_row = a_row[keep], b_row[keep]
    if not len(a_row):
        return None
    # max(price) per (a_id, category): the last of each group in
    # (a_id, category, price) order
    a_id = auc["a_id"][a_row].astype(np.int64)
    cat = auc["category"][a_row].astype(np.int64)
    price = bid["price"][b_row].astype(np.int64)
    o = np.lexsort((price, cat, a_id))
    a_id, cat, price = a_id[o], cat[o], price[o]
    last = np.flatnonzero(np.r_[(a_id[1:] != a_id[:-1])
                                | (cat[1:] != cat[:-1]), True])
    final, fcat = price[last], cat[last]
    # per category: the exact sum and count, then one f64 division
    o = np.argsort(fcat, kind="stable")
    final, fcat = final[o], fcat[o]
    start = np.flatnonzero(np.r_[True, fcat[1:] != fcat[:-1]])
    return (fcat[start], np.add.reduceat(final, start),
            np.diff(np.r_[start, len(fcat)]))


def reference(tables, config):
    got = _sums(tables)
    if got is None:
        return _empty()
    cat, total, count = got
    return {"category": cat,
            "avg_final": total.astype(np.float64) / count.astype(np.float64)}


def control(tables, config):
    """The reference with its average divided in f32, the next precision
    below the f64 the configuration's exact results state (a replay of
    the window's events leaves q4's maxima, and so its answer, as they
    were)."""
    got = _sums(tables)
    if got is None:
        return _empty()
    cat, total, count = got
    avg = total.astype(np.float32) / count.astype(np.float32)
    return {"category": cat, "avg_final": avg.astype(np.float64)}


def least_bytes(tables, config, out):
    """The columns q4 reads, read once (an auction's id, start, expiry and
    category: 24 bytes; a bid's auction, price and time: 16 bytes), one
    winning price per auction written once (int32), and the result rows
    written once (category and average: 16 bytes)."""
    auctions = len(tables["auction"]["a_id"]) if "auction" in tables else 0
    bids = len(tables["bid"]["auction"]) if "bid" in tables else 0
    return 24 * auctions + 16 * bids + 4 * auctions \
        + 16 * len(out["category"])
