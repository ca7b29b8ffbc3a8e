"""VGG-VD-16's counts against hand counts, and the reference's leaves
against the published shapes."""

import json
import math

import pytest

from perfbench.counts import vgg16
from perfbench.harness.spec import BENCH
from perfbench.reference import vgg16 as ref

CFG = json.loads((BENCH / "configs" / "vgg16-face-ferplus.json").read_text())


def test_forward_flops_and_layers_by_hand():
    ls = vgg16.layers(CFG, 224)
    assert len(ls) == 13 + 3
    assert ls[1] == (64, 64, 3, 3, 224, 224)  # conv1_2
    assert ls[13] == (512, 4096, 7, 7, 1, 1)  # fc6 over pool5's 7x7
    assert vgg16.forward_flops(CFG, 224) == 2 * 15_466_201_088  # 15.47 GMAC
    fc = 512 * 49 * 4096 + 4096 * 4096 + 4096 * 8  # fc6, fc7, the head
    assert vgg16.conv3x3_flops(CFG, 224) == 2 * (15_466_201_088 - fc)


def test_pool_bytes_by_hand():
    assert vgg16.block_ends(CFG, 224) == [(224, 64), (112, 128), (56, 256),
                                          (28, 512), (14, 512)]
    elems = 224 * 224 * 64 + 112 * 112 * 128 + 56 * 56 * 256 + 28 * 28 * 512 + 14 * 14 * 512
    st = 8 * (64 + 128 + 256 + 512 + 512)
    assert vgg16.pool_bytes(CFG, 224, 128, 2) == 128 * elems * 2 * 5 // 4 + st
    assert vgg16.pool_bytes(CFG, 224, 128, 2) / 3.35e12 == pytest.approx(0.585e-3, rel=1e-2)


def test_reference_leaves_have_the_published_shapes():
    shapes = {name: shape for name, shape, _, _ in ref.leaves(CFG)}
    assert shapes["conv1_1.weight"] == (64, 3, 3, 3)
    assert shapes["conv5_3.weight"] == (512, 512, 3, 3)
    assert shapes["fc6.weight"] == (4096, 512, 7, 7)
    assert shapes["prediction.weight"] == (8, 4096)
    params = sum(math.prod(s) for s in shapes.values())
    assert 134_000_000 < params < 134_400_000


def test_conv_share_reads_the_cudnn_kernels_alone():
    from perfbench.harness.cli import metric_reader

    read = metric_reader("mfu.dense_vgg16").read
    kernels = {"sm90_xmma_fprop_implicit_gemm_bf16bf16_cudnn": {"seconds": 0.3, "launches": 3},
               "cutlass__5x_cudnn::Kernel": {"seconds": 0.1, "launches": 1},
               "affine_relu_kernel": {"seconds": 5.0, "launches": 10},
               "nvjet_tst_96x128_64x7_2x1_v_bz_splitK_TNN": {"seconds": 5.0, "launches": 1}}
    rec = {"trace": {"kernels": kernels}, "traced_work": {"conv_flops": 0.2 * 989e12},
           "peaks": {"bf16_flops": 989e12}}
    assert read(rec) == pytest.approx(50.0)
    assert read(dict(rec, trace={"kernels": {"affine_relu_kernel": kernels["affine_relu_kernel"]}})) is None
    assert read(dict(rec, traced_work={})) is None
    assert read(dict(rec, trace=None)) is None
