"""The share (%) of the traced slice's idle device time during which the
dense pass was copying a batch in, issuing the teacher's forward or
reading its logits back (its ``visual.h2d``, ``visual.forward`` and
``visual.read`` spans, ``spans.join``)."""

from perfbench.metrics.spans import share


def read(record):
    return share(record, "idle", ("visual.h2d", "visual.forward", "visual.read"))
