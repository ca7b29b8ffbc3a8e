"""The share of the window outside its traced slice that the dense pass
spent waiting on the face decoder's prefetch (its ``visual.decode_wait``
spans), over that time."""

from perfbench.metrics.spans import untraced


def read(record):
    waits = untraced(record, "visual.decode_wait")
    if waits is None or record.get("untraced_s", 0) <= 0:
        return None
    return sum(waits) / record["untraced_s"]
