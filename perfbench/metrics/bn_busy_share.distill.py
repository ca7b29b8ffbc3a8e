"""BatchNorm's share (%) of the device's busy time in the traced slice:
the seconds of device operations launched inside the program's
``vggm.bn`` spans (the masked fp32 forward) and ``vggm.bn.backward``
spans (its backward, on the autograd engine's thread), over the slice's
busy seconds (``spans.join``)."""

from perfbench.metrics.spans import share


def read(record):
    return share(record, "device", ("vggm.bn", "vggm.bn.backward"))
