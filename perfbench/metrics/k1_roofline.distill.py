"""K1's share of its roofline in the traced slice: the spectrogram kernel
(``ops/spectrogram_kernel``), bytes and operations from
``counts/kernels``."""

from perfbench.metrics.common import kernel_roofline


def read(record):
    w = record.get("traced_work") or {}
    return kernel_roofline(record, "k1_roofline.distill", ("spectrogram_kernel",), "k1",
                           {"spectrogram_kernel": w.get("k1_launches")})
