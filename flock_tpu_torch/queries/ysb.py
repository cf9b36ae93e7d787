"""YSB query plan: campaign view counts over tumbling 10 s windows — a copy
of ``ysb_query``, ``campaign_table``, ``generate_ysb_epochs`` and
``run_ysb`` from ``flock_tpu/queries/ysb.py``, with torch expressions.

The reference engine's ysb.sql:
  SELECT campaign_id, Count(*) FROM ad_event INNER JOIN campaign
  ON ad_id = c_ad_id WHERE event_type = 'view' GROUP BY campaign_id
with Window::Tumbling(10s) (benchmarks/src/ysb/main.rs:91).

Columns are dictionary codes (see ``datagen/ysb.py``): event_type 'view' is
0; the campaign table is (c_ad_id, campaign_id) with deterministic integer
ids.  On the card K2 slots the campaign table, K3 gathers ``campaign_id``
to every view and K2 counts per campaign.
"""

from __future__ import annotations

import numpy as np

from flock_tpu_torch.batch import Schema, round_up
from flock_tpu_torch.datagen.ysb import (EVENT_TYPE_VIEW, YsbConfig,
                                         generate_partition)
from flock_tpu_torch.plan import Aggregate, Filter, Join, Scan
from flock_tpu_torch.queries.nexmark import QuerySpec
from flock_tpu_torch.runtime.executor import LocalExecutor
from flock_tpu_torch.runtime.stream import WindowResult


def ysb_query() -> QuerySpec:
    views = Filter(Scan("ad_event"),
                   lambda c: c["event_type"] == EVENT_TYPE_VIEW,
                   "event_type='view'")
    joined = Join(build=Scan("campaign"), probe=views,
                  build_key="c_ad_id", probe_key="ad_id",
                  take=(("campaign_id", "campaign_id"),),
                  unique_build=True)  # campaign ids are a generated range
    plan = Aggregate(joined, group_keys=("campaign_id",),
                     aggs=((None, "count", "count"),), out_capacity=128)
    return QuerySpec(
        number=-1,  # YSB
        plan=plan,
        window=("tumbling", 10),
        relations=("ad_event", "campaign"),
        schema=Schema(["campaign_id", "count"]),
    )


def campaign_table(cfg: YsbConfig) -> dict[str, np.ndarray]:
    ad = np.arange(cfg.num_ads, dtype=np.int32)
    return {"c_ad_id": ad, "campaign_id": ad // cfg.ads_per_campaign}


def generate_ysb_epochs(cfg: YsbConfig) -> list[dict]:
    """Per-epoch ad_event tables, merged across generator partitions."""
    per_epoch: dict[int, list] = {}
    for idx in range(cfg.threads):
        d = generate_partition(cfg, idx)
        tags = d.pop("epoch")
        for e in np.unique(tags).tolist():
            m = tags == e
            per_epoch.setdefault(int(e), []).append(
                {k: v[m] for k, v in d.items()})
    epochs = []
    for t in range(cfg.seconds):
        parts = per_epoch.get(t, [])
        if parts:
            cols = {k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]}
        else:
            cols = {k: np.array([], np.int32)
                    for k in ("ad_id", "ad_type", "event_type")}
            cols["event_time"] = np.array([], np.int64)
        epochs.append({"ad_event": cols})
    return epochs


def ysb_capacities(cfg: YsbConfig, w: int) -> dict[str, int]:
    """The reference's per-window capacities: a window's events (plus 64)
    and the campaign table, each rounded up."""
    return {"ad_event": max(round_up(w * cfg.events_per_second + 64), 128),
            "campaign": max(round_up(cfg.num_ads), 128)}


def run_ysb(cfg: YsbConfig, device=None):
    """End to end: generate → tumbling windows → execute → materialize, on
    ``device`` (``None`` → ``cuda``)."""
    spec = ysb_query()
    epochs = generate_ysb_epochs(cfg)
    camp = campaign_table(cfg)
    executor = LocalExecutor(spec, device=device)
    w = spec.window[1]
    caps = ysb_capacities(cfg, w)
    results = []
    for k in range(cfg.seconds // w):
        chunk = epochs[k * w:(k + 1) * w]
        cols = {key: np.concatenate([c["ad_event"][key] for c in chunk])
                for key in chunk[0]["ad_event"]}
        out = executor.execute_window({"ad_event": cols, "campaign": camp},
                                      caps)
        results.append(WindowResult(("win", k * w, k * w + w),
                                    executor.materialize(out)))
    return results
