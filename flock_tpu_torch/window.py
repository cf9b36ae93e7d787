"""Stream window + schedule model — a copy of ``flock_tpu/window.py``
(``Schedule``, ``Window`` with ``to_spec``, and the ``*_window``
constructors), pure Python.

The reference engine's counterpart is window.rs:39-115: it declares
``Window::{Tumbling,Hopping,Sliding,Session,Global,Stagger,ElementWise}``
over ``Schedule::{Rate,Seconds,Cron,Rows}``.  The port's ``StreamDriver``
executes the element-wise, tumbling, hopping, sliding and stagger kinds
and row-count windows; session and global windows raise until their slices
land.

Semantics of the two kinds the reference declares but never drives:

* **Sliding(window, slide)** — like hopping, but emits *leading partial
  windows* as soon as the first slide boundary passes (the Azure
  Stream-Analytics semantics window.rs cites: a result for every slide point
  covering the trailing ``window`` seconds, clamped at stream start).
* **Stagger(window)** — first-event-anchored windows (the AWS Kinesis
  Analytics semantics window.rs's doc comment describes): a window opens at
  the first epoch carrying data while no window is open and spans
  ``window`` seconds from that anchor; the next window opens at the next
  data-carrying epoch after it closes.

``Schedule`` drives epoch sizing:

* ``Rate("rate(N unit)")`` / ``Seconds(n)`` — window sizes in seconds
  (epochs).
* ``Rows(n)`` — row-count windows: the driving relation's rows are packed
  into consecutive windows of exactly ``n`` rows (remainder flushes at
  stream end).
* ``Cron`` — parsed and representable (plan metadata parity) but not
  executable; the reference never drives Cron windows either.

The stream drivers consume the lowered tuple form (``to_spec``); QuerySpec
stores that tuple so plans stay hashable.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_RATE_RE = re.compile(r"rate\((\d+)\s+(second|minute|hour|day)s?\)")
_UNIT_S = {"second": 1, "minute": 60, "hour": 3600, "day": 86400}


@dataclass(frozen=True)
class Schedule:
    """window.rs:39-77 — Rate/Seconds/Cron/Rows."""

    kind: str       # "rate" | "seconds" | "cron" | "rows"
    value: object   # str for rate/cron, int for seconds/rows

    @staticmethod
    def rate(expr: str) -> "Schedule":
        return Schedule("rate", expr)

    @staticmethod
    def seconds(n: int) -> "Schedule":
        return Schedule("seconds", int(n))

    @staticmethod
    def cron(expr: str) -> "Schedule":
        return Schedule("cron", expr)

    @staticmethod
    def rows(n: int) -> "Schedule":
        return Schedule("rows", int(n))

    def to_seconds(self) -> int:
        """Resolve a time-based schedule to whole seconds (epoch units)."""
        if self.kind == "seconds":
            return int(self.value)
        if self.kind == "rate":
            m = _RATE_RE.fullmatch(str(self.value).strip().lower())
            if not m:
                raise ValueError(f"bad rate expression: {self.value!r}")
            return int(m.group(1)) * _UNIT_S[m.group(2)]
        if self.kind == "cron":
            raise NotImplementedError(
                "cron schedules are representable but not executable "
                "(the reference never drives them either, window.rs:58-74)")
        raise ValueError(f"schedule {self.kind} is not time-based")


@dataclass(frozen=True)
class Window:
    """window.rs:80-115 — the seven window kinds."""

    kind: str                   # tumbling|hopping|sliding|session|global|
    #                             stagger|elementwise
    schedule: Schedule | None = None
    aux: int | None = None      # hop (hopping) / slide (sliding)

    def to_spec(self) -> tuple:
        """Lower to the stream drivers' tuple form."""
        k = self.kind
        if k == "elementwise":
            return ("elementwise",)
        if k == "stagger":
            return ("stagger", self.schedule.to_seconds())
        if k in ("hopping", "sliding"):
            return (k, self.schedule.to_seconds(), int(self.aux))
        # tumbling/session/global accept Rows schedules → row-count windows
        if self.schedule.kind == "rows":
            if k != "tumbling":
                raise NotImplementedError(
                    f"rows schedule on {k} windows is not supported")
            return ("rows", int(self.schedule.value))
        return (k, self.schedule.to_seconds())


def tumbling_window(sched: Schedule | int) -> Window:
    return Window("tumbling", _sched(sched))


def hopping_window(sec: int, hop: int) -> Window:
    return Window("hopping", Schedule.seconds(sec), aux=hop)


def sliding_window(sec: int, slide: int) -> Window:
    return Window("sliding", Schedule.seconds(sec), aux=slide)


def session_window(sched: Schedule | int) -> Window:
    return Window("session", _sched(sched))


def global_window(sched: Schedule | int) -> Window:
    return Window("global", _sched(sched))


def stagger_window(sec: int) -> Window:
    return Window("stagger", Schedule.seconds(sec))


def element_wise_window() -> Window:
    return Window("elementwise")


def _sched(s: Schedule | int) -> Schedule:
    return s if isinstance(s, Schedule) else Schedule.seconds(s)
