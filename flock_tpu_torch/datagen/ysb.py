"""YSB (Yahoo Streaming Benchmark) source — a copy of ``YsbConfig``,
``AD_TYPES``, ``EVENT_TYPES``, ``EVENT_TYPE_VIEW``,
``scalar_generate_partition`` and ``generate_partition`` from
``flock_tpu/datagen/ysb.py``.

The reference engine generates ad events at a fixed timestep with a
per-epoch seeded RNG over a campaign map of 100 campaigns x 10 ads keyed by
random v4 UUIDs (ysb.rs, generator.rs, event.rs).  As in the JAX package,
ids are deterministic integers here: ad ids are ``0..campaigns*ads`` and
``campaign(ad) = ad // ads``; the per-epoch draw sequence (uniform ad pick,
ad_type(5) and event_type(3) choices from an RNG seeded 0xDEAD every epoch)
and the timestep ``1000*threads/eps`` ms are the reference's.

``generate_partition`` runs the native generator and raises when it cannot
be built or run; the scalar version stays as the tests' second opinion.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from flock_tpu_torch.utils.rng import SmallRng

AD_TYPES = ["banner", "modal", "sponsored-search", "mail", "mobile"]
EVENT_TYPES = ["view", "click", "purchase"]
EVENT_TYPE_VIEW = 0


@dataclass
class YsbConfig:
    seconds: int = 10
    events_per_second: int = 1000
    threads: int = 1
    campaigns: int = 100
    ads_per_campaign: int = 10

    @property
    def num_ads(self) -> int:
        return self.campaigns * self.ads_per_campaign


def scalar_generate_partition(cfg: YsbConfig, index: int) -> dict:
    """Pure-Python replica of the native ``fg_ysb_generate``."""
    timestep = (1000 * cfg.threads) / cfg.events_per_second
    time = 1.0 + (index * 1000 // cfg.threads)
    max_time = cfg.seconds * 1000
    ad_id, ad_type, event_type, event_time, epoch_tag = [], [], [], [], []
    while time < max_time:
        epoch = int(time) // 1000
        rng = SmallRng(0xDEAD)
        while time < (epoch + 1) * 1000 and time < max_time:
            ad_id.append(rng.gen_range_u64(cfg.num_ads))
            ad_type.append(rng.gen_range_u32(len(AD_TYPES)))
            event_type.append(rng.gen_range_u32(len(EVENT_TYPES)))
            event_time.append(int(time))
            epoch_tag.append(epoch)
            time += timestep
    return {
        "ad_id": np.array(ad_id, np.int32),
        "ad_type": np.array(ad_type, np.int32),
        "event_type": np.array(event_type, np.int32),
        "event_time": np.array(event_time, np.int64),
        "epoch": np.array(epoch_tag, np.int32),
    }


def generate_partition(cfg: YsbConfig, index: int) -> dict:
    """One partition's ad events from the native generator."""
    from flock_tpu_torch.datagen.native_gen import ysb_generate_partition

    return ysb_generate_partition(
        cfg.seconds, cfg.events_per_second, cfg.threads, index,
        cfg.campaigns, cfg.ads_per_campaign)
