"""Operations and bytes worked out from shapes, and the card's peaks.

Nothing here reads the program: a kernel's work is what the algorithm
needs for the shapes it is given, whatever implements it. Model FLOPs
count two per multiply-add of every convolution and matrix product
(BatchNorm, activations and pools are not counted); a backward pass
counts the gradients of both the input and the weights, except for the
input gradient of a layer whose input needs none. Recomputed work and
padding are not counted. A roofline counts each input byte read once and
each output byte written once.
"""

# NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "fp32_flops": 67e12,
                              "hbm_bytes": 3.35e12},
}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``);
    an H100 SXM's for a card not in the table, named so on stderr by the
    caller."""
    return PEAKS.get(kind, PEAKS["NVIDIA H100 80GB HBM3"])


def conv_out(n: int, k: int, s: int, p: int = 0) -> int:
    """A VALID/padded convolution's or pool's output length (floor)."""
    return (n + 2 * p - k) // s + 1


def conv_flops(cin: int, cout: int, kh: int, kw: int, ho: int, wo: int) -> int:
    """Forward FLOPs of a convolution (2 per multiply-add)."""
    return 2 * cin * cout * kh * kw * ho * wo
