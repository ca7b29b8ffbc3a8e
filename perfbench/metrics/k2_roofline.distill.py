"""K2's share of its roofline in the traced slice of a training window:
the with-index forward and the backward (``ops/pool``) over pool1 and
pool2, bytes from ``counts/kernels.k2_bytes``."""

from perfbench.metrics.common import kernel_roofline


def read(record):
    w = record.get("traced_work") or {}
    launches = w.get("k2_launches", {})
    return kernel_roofline(record, "k2_roofline.distill",
                           ("pool_walk_kernel", "pool_bwd_walk_kernel"), "k2",
                           {"pool_walk_kernel": launches.get("forward"),
                            "pool_bwd_walk_kernel": launches.get("backward")})
