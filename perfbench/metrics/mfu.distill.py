"""Model FLOPs (``perfbench/counts``, from shapes) of the work completed
in the window outside its traced slice, over the time outside it, as a
share (%) of the card's dense bf16 peak."""

from perfbench.metrics.common import mfu


def read(record):
    return mfu(record)
