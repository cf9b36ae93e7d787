"""Staging per epoch (ms): the program's always-on timer ``stage.epoch_s``
over its counter ``stage.epochs`` (``StreamDriver.stage_epochs``: each
epoch's columns staged into pinned buffers and queued to the card), in
set-up."""

from flockbench import spans


def read(rec):
    return spans.stage_ms_per_epoch(rec)
