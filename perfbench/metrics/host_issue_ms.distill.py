"""The host's time a train step (ms): the median ``train.step`` span over
the window outside its traced slice, where the profiler does not slow the
host. It holds the step's issue and whatever holds the host inside the
step: a full launch queue behind the card, or the interpreter lock that
another thread holds."""

import statistics

from perfbench.metrics.spans import untraced


def read(record):
    steps = untraced(record, "train.step")
    return 1e3 * statistics.median(steps) if steps else None
