"""The block-end epilogue's share of its roofline in the traced slice:
``affine_relu_pool2x2`` (``ops/epilogue``: affine, ReLU and 2x2/2 max pool
of each VGG block's last conv output), its least bytes from
``counts/vgg16.pool_bytes`` (y's window rows read, a quarter written, s
and t read) over its device time; read only where the trace holds as many
launches as the program's counter counted over the slice."""

from perfbench.metrics.common import kernel_roofline


def read(record):
    w = record.get("traced_work") or {}
    return kernel_roofline(record, "pool_epilogue_roofline.dense_vgg16",
                           ("affine_relu_pool2x2_kernel",), "pool",
                           {"affine_relu_pool2x2_kernel": w.get("pool_launches")})
