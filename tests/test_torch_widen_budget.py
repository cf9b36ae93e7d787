"""One widening budget for every driver: ``runtime.stream._WIDENS``, read
when a loop runs.  Each widen-and-retry loop of the single-card and the
sharded drivers meets an overflow on every attempt, forced by a stub of the
call it retries, and gives up after ``_WIDENS`` widens, however the budget
is patched (PyTorch port, CPU)."""

import dataclasses

import pytest
import torch

from flock_tpu_torch.parallel import stream as pstream
from flock_tpu_torch.parallel.executor import DistributedExecutor
from flock_tpu_torch.parallel.stream import DistStreamDriver
from flock_tpu_torch.queries.nexmark import get_query
from flock_tpu_torch.runtime import device_session, stream
from flock_tpu_torch.runtime.executor import LocalExecutor, OverflowError
from flock_tpu_torch.runtime.stream import (StreamDriver, generate_epoch_parts,
                                            generate_epochs)

torch.set_num_threads(1)

SECONDS, EPS, SHARDS = 3, 300, 2


def _local(q, window=None):
    spec = get_query(q)
    if window is not None:
        spec = dataclasses.replace(spec, window=window)
    return StreamDriver(spec, SECONDS, device="cpu"), \
        generate_epochs(SECONDS, EPS)


def _sharded(q):
    return DistStreamDriver(get_query(q), SECONDS, SHARDS, device="cpu"), \
        generate_epoch_parts(SECONDS, EPS, SHARDS)


# path → (its driver and input, whether q11 takes the generic session tier,
# the owner and name of the call its loop retries, the error it gives up
# with)
PATHS = {
    "range windows": (lambda: _local(4), False, LocalExecutor,
                      "execute_epochs", OverflowError),
    "row windows": (lambda: _local(0, ("rows", 200)), False, LocalExecutor,
                    "execute_window", OverflowError),
    "processing-time windows": (lambda: _local(12), False, LocalExecutor,
                                "execute_consts", OverflowError),
    "generic session emissions": (lambda: _local(11), True, LocalExecutor,
                                  "execute_session_tables", OverflowError),
    "execute_widening": (lambda: _sharded(4), False, DistributedExecutor,
                         "execute_staged", OverflowError),
    "sharded session-table emissions": (lambda: _sharded(11), True, pstream,
                                        "_dist_session_exec", OverflowError),
    "sharded session spans": (lambda: _sharded(11), False, DistStreamDriver,
                              "_session_device_once", RuntimeError),
}


@pytest.mark.parametrize("widens", [0, 2])
@pytest.mark.parametrize("path", list(PATHS))
def test_every_widen_loop_reads_the_one_budget(path, widens, monkeypatch):
    """With ``_WIDENS`` patched, a path that overflows on every attempt
    makes ``_WIDENS`` + 1 attempts and raises: on its first attempt at a
    budget of 0.  (The sharded session span's restart gives up with a
    RuntimeError, and its stub returns None: the span was too small.)"""
    make, generic, owner, name, error = PATHS[path]
    if generic:
        monkeypatch.setattr(device_session, "session_fast_spec",
                            lambda *a, **kw: None)
    driver, data = make()
    monkeypatch.setattr(stream, "_WIDENS", widens)
    attempts = []

    def overflow(*a, **k):
        attempts.append(1)
        if error is RuntimeError:
            return None
        raise OverflowError("forced")

    monkeypatch.setattr(owner, name, overflow)
    with pytest.raises(error):
        driver.run(data)
    assert len(attempts) == widens + 1
