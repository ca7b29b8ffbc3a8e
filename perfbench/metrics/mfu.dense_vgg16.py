"""The 3x3 convolutions' share (%) of the card's dense bf16 peak in the
traced slice: their FLOPs over the traced passes
(``counts/vgg16.conv3x3_flops``, from shapes) over the device time of the
kernels cuDNN runs them in (every kernel whose name carries ``cudnn``).
The epilogues, fc6 and fc7 (cuBLAS GEMMs), the head and the input's copy
and preprocessing are outside both sides, so this reads the convolutions
alone, apart from the end-to-end rate."""

from perfbench.harness.cli import side


def read(record):
    t, w = record.get("trace"), record.get("traced_work") or {}
    flops = w.get("conv_flops")
    if not t or not t.get("kernels") or not flops:
        return None
    convs = {n: k for n, k in t["kernels"].items() if "cudnn" in n}
    seconds = sum(k["seconds"] for k in convs.values())
    if seconds <= 0:
        return None
    share = 100.0 * flops / seconds / record["peaks"]["bf16_flops"]
    side(f"mfu.dense_vgg16: {flops} conv FLOPs over {seconds:.6f} s of "
         f"{sum(k['launches'] for k in convs.values())} cuDNN launches "
         f"({len(convs)} kernels): {share:.4f}% of the bf16 peak")
    return share
