"""Engine configuration — copy of ``flock_tpu/config.py`` for the port.

The fields the port reads so far (``target_partitions``,
``agg_span_margin``, ``join_span_margin``, ``capacity_round`` and
``state_dir``), with the reference's names; the
sizes keep its defaults so that both engines size their buffers alike.
``state_dir`` defaults to a directory of the port's own
(``flock_tpu_torch/state``, beside its build directory), so the two
engines' checkpoints never mix by accident.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

_PACKAGE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class EngineConfig:
    target_partitions: int = 8        # default mesh width (flock.toml:113)
    agg_span_margin: int = 8_192      # dense-key span headroom (generator striping)
    join_span_margin: int = 8_192
    capacity_round: int = 128         # batch capacity rounding
    # checkpoints (FileStateBackend's default root)
    state_dir: str = os.path.join(_PACKAGE, "state")


CONFIG = EngineConfig()
