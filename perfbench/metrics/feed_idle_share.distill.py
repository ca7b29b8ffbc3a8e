"""The share (%) of the traced slice's idle device time during which the
training loop was waiting on the host feed (its ``train.feed_wait``
spans, ``spans.join``)."""

from perfbench.metrics.spans import share


def read(record):
    return share(record, "idle", ("train.feed_wait",))
