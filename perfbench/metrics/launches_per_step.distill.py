"""Device operations launched a train step in the traced slice: those
whose runtime call started inside one of the slice's ``train.step`` spans
(any thread: the backward launches from the autograd engine's), over
those spans."""

from perfbench.metrics.spans import joined


def read(record):
    out = joined(record)
    if out is None or not out["steps"]:
        return None
    return out["step_launches"] / out["steps"]
