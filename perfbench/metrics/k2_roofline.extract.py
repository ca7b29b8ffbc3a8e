"""K2's share of its roofline in the traced slice of an extraction window:
the index-free forward (``ops/pool``) over pool1 and pool2, two launches a
spectrogram launch (one a chunk), bytes from ``counts/kernels.k2_bytes``."""

from perfbench.metrics.common import kernel_roofline


def read(record):
    k1 = ((record.get("trace") or {}).get("kernels") or {}).get("spectrogram_kernel")
    if k1 is None:
        return None
    return kernel_roofline(record, "k2_roofline.extract", ("pool_walk_kernel",), "k2",
                           {"pool_walk_kernel": 2 * k1["launches"]})
