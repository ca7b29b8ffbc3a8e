"""K1's share of its roofline in the traced slice of an extraction window:
the spectrogram kernel (``ops/spectrogram_kernel``) over whole passes,
bytes and operations of each track's valid frames from
``counts/kernels`` (the padding to the track's shape is not counted)."""

from perfbench.metrics.common import kernel_roofline


def read(record):
    return kernel_roofline(record, "k1_roofline.extract", ("spectrogram_kernel",), "k1",
                           {"spectrogram_kernel": None})
