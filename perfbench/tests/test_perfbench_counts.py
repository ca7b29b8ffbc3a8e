"""The operation and byte counts against hand counts."""

import json

import pytest

from perfbench.counts import kernels, senet50, vggm
from perfbench.harness.spec import BENCH

VGGM = json.loads((BENCH / "configs" / "vggm-emovox-student.json").read_text())
SENET = json.loads((BENCH / "configs" / "senet50-ferplus.json").read_text())


def test_vggm_conv2_and_shapes_by_hand():
    layers = {l["name"]: l for l in vggm.layer_shapes(VGGM, 400)}
    # conv1 7x7/2 on 512 x 400: 253 x 197; pool1 3x3/2: 126 x 98;
    # conv2 5x5/2: 61 x 47 -> 2 x 96 x 256 x 25 x 61 x 47
    assert (layers["conv1"]["ho"], layers["conv1"]["wo"]) == (253, 197)
    assert (layers["conv2"]["ho"], layers["conv2"]["wo"]) == (61, 47)
    assert 2 * 96 * 256 * 25 * 61 * 47 == 3_522_969_600
    c2 = layers["conv2"]
    assert 2 * c2["cin"] * c2["cout"] * c2["kh"] * c2["kw"] * c2["ho"] * c2["wo"] == 3_522_969_600
    # fc6 9x1 over 9 x 11 after pool5: 2 x 256 x 9 x 4096 x 11
    assert layers["fc6"]["ho"] * layers["fc6"]["wo"] == 11
    assert vggm.pool_shapes(VGGM, 400) == [(96, 253, 197, 126, 98), (256, 61, 47, 30, 23)]


def test_vggm_train_flops_are_three_forwards_less_conv1_input_gradient():
    fwd = vggm.forward_flops(VGGM, 400)
    conv1 = 2 * 1 * 96 * 49 * 253 * 197
    assert vggm.train_flops(VGGM, 400) == 3 * fwd - conv1
    assert 7.4e9 < fwd < 7.5e9


def test_senet50_stem_and_first_bottleneck_by_hand():
    ls = senet50.layers(SENET, 224)
    assert ls[0] == (3, 64, 7, 7, 112, 112)  # 7x7/2 pad 3
    # stem pool 3x3/2 ceil mode: 112 -> 56; layer1_0: 64 -> 64 (1x1),
    # 3x3, 64 -> 256, SE 256 -> 16 -> 256, projection 64 -> 256
    assert ls[1:7] == [(64, 64, 1, 1, 56, 56), (64, 64, 3, 3, 56, 56),
                       (64, 256, 1, 1, 56, 56), (256, 16, 1, 1, 1, 1),
                       (16, 256, 1, 1, 1, 1), (64, 256, 1, 1, 56, 56)]
    assert 7.6e9 < senet50.forward_flops(SENET, 224) < 7.8e9


def test_k1_and_k2_by_hand():
    # K1: 64,384 int16 in, 512 x 400 float32 out; 5 x 512 x 9 a frame
    assert kernels.k1_bytes(64384, 400, 512, 2) == 64384 * 2 + 512 * 400 * 4
    assert kernels.k1_flops(400, 512) == pytest.approx(5 * 512 * 9 * 400)
    # K2 on pool2's [256, 61, 47] bf16 -> [256, 30, 23]
    x, y = 256 * 61 * 47 * 2, 256 * 30 * 23 * 2
    assert kernels.k2_bytes([(256, 61, 47, 30, 23)], 2, backward=False) == x + y
    assert kernels.k2_bytes([(256, 61, 47, 30, 23)], 2, backward=True) == 2 * x + 2 * y


def test_roofline_names_its_bound():
    peaks = {"hbm_bytes": 1e12, "fp32_flops": 1e12}
    assert kernels.roofline(2e9, 1e9, 4e-3, peaks) == (50.0, "bytes")
    assert kernels.roofline(1e9, 2e9, 4e-3, peaks) == (50.0, "flops")
