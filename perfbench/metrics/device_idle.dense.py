"""The device's idle share (%) in the traced slice: 1 - the union of
device operations' intervals over the slice's length."""

from perfbench.metrics.common import device_idle


def read(record):
    return device_idle(record)
