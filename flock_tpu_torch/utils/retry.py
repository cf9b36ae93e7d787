"""Retry with linear-random backoff — the invoke-retry analogue (copy of
``flock_tpu/utils/retry.py``: ``with_retry`` and ``RetryBudgetExceeded``).

Reference: flock/src/aws/lambda.rs:104-152 — sync invoke retries up to 200
times with ``sleep(2 * iter + rand(0..1000ms))`` against throttling/transient
faults.  The engine applies the same policy to transient faults; the file state
backend retries its reads and writes with it.
"""

from __future__ import annotations

import random
import time
from typing import Callable, TypeVar

T = TypeVar("T")


class RetryBudgetExceeded(RuntimeError):
    pass


def with_retry(fn: Callable[[], T], max_retries: int = 200,
               base_ms: int = 2, max_jitter_ms: int = 1000,
               retryable: tuple = (Exception,),
               sleep=time.sleep) -> T:
    """Run ``fn`` with the reference's linear-random backoff policy."""
    last: Exception | None = None
    for attempt in range(max_retries):
        try:
            return fn()
        except retryable as e:  # noqa: PERF203
            last = e
            sleep((base_ms * attempt + random.randint(0, max_jitter_ms)) / 1000)
    raise RetryBudgetExceeded(
        f"gave up after {max_retries} retries: {last!r}") from last
