"""The share (%) of the traced slice's idle device time during which the
dense pass was waiting on the face decoder (its ``visual.decode_wait``
spans, ``spans.join``)."""

from perfbench.metrics.spans import share


def read(record):
    return share(record, "idle", ("visual.decode_wait",))
