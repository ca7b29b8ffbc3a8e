"""The face fixtures and the teacher golden of the port's teacher path.

``tests/fixtures/torch_faces/`` holds small JPEGs that cover what the port's
decoder (``csrc/dataservice_faces.cc``) must reproduce: 4:2:0, 4:2:2,
4:4:4, 4:4:0 and grayscale, restart intervals, sizes that are not
multiples of 8 or 16, optimised Huffman tables, 16-bit quantisation tables
(SOF1), a 3x9 image (chroma two samples wide) and 224x224 and 320x256
frames. They were written by PIL, the 4:4:0 ones (which PIL cannot write)
by libjpeg through a small C++ helper compiled here.

``tests/fixtures/torch_teacher_golden.npz`` holds, for each fixture, the
committed ``native/libdataservice.so``'s ``decode_faces`` frames at crop
1/1.6 and 1.0 (224x224) and PIL's RGB decode; and the JAX package's
full-width ``SENet50`` and ``ResNet50`` logits through
``FaceTeacherPipeline``, in fp32 and in bf16, on four of those frames,
with ``random_teacher_variables(seed=0)``.

``tests/fixtures/torch_vgg16_golden.npz`` holds the JAX package's
full-width VGG-VD-16 (``VGGFace(arch="vd")``, 8-way head) logits through
``FaceTeacherPipeline`` with the vgg_face mean, in fp32 and in bf16, without
BatchNorm (as ``vgg-vd-face-fer``) and with the useBnorm retrofit, on the
same four frames, with ``random_vggface_variables(seed=0)``.

Rewrite them (minutes: full-width JAX compiles on the CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_teacher_golden.py --fixtures --golden
    JAX_PLATFORMS=cpu python tests/test_torch_teacher_golden.py --vgg16-golden

The tests below (marked ``slow``, outside Tier-1) recompute each golden
from the committed fixtures and hold it to the committed file.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "torch_faces"
GOLDEN = Path(__file__).resolve().parent / "fixtures" / "torch_teacher_golden.npz"
VGG16_GOLDEN = GOLDEN.with_name("torch_vgg16_golden.npz")
VGG_FACE_MEAN = (129.1863, 104.7624, 93.594)  # vgg_face's averageImage
LOGIT_FIXTURES = ("f420_224x224", "f422_320x256", "f444_97x131",
                  "gray_131x97")  # the four frames the logits cover
CROPS = {"crop0625": 1.0 / 1.6, "crop1": 1.0}
OUT_SIZE = 224
SEED = 0

# libjpeg writes what PIL cannot (4:4:0); compiled here with -ljpeg
_HELPER = r'''
#include <cstdio>
#include <cstdlib>
#include <jpeglib.h>
int main(int argc, char** argv) {
  // raw.rgb out.jpg width height quality hsamp vsamp restart_rows
  FILE* in = fopen(argv[1], "rb");
  int w = atoi(argv[3]), h = atoi(argv[4]);
  unsigned char* buf = (unsigned char*)malloc(size_t(w) * h * 3);
  if (fread(buf, 1, size_t(w) * h * 3, in) != size_t(w) * h * 3) return 1;
  fclose(in);
  jpeg_compress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[2], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, atoi(argv[5]), TRUE);
  c.comp_info[0].h_samp_factor = atoi(argv[6]);
  c.comp_info[0].v_samp_factor = atoi(argv[7]);
  c.restart_in_rows = atoi(argv[8]);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = buf + size_t(c.next_scanline) * w * 3;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  return 0;
}
'''


def face_image(w: int, h: int, seed: int) -> np.ndarray:
    """A seeded face-like RGB image: an elliptical skin-toned face with
    dark eyes and a red mouth (sharp edges), a coloured background, a
    sinusoid and noise (texture for every DCT band)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    cy, cx = h * (0.45 + 0.1 * rng.rand()), w * (0.45 + 0.1 * rng.rand())
    r = np.hypot((yy - cy) / (0.38 * h), (xx - cx) / (0.3 * w))
    skin = np.array([205.0, 150.0, 125.0]) + rng.randn(3) * 10
    bg = rng.rand(3) * 255
    img = np.where((r < 1)[..., None], skin * (1.1 - 0.3 * r[..., None]), bg)
    for ey in (-0.12, 0.12):
        er = np.hypot((yy - cy + 0.1 * h) / (0.05 * h),
                      (xx - cx - ey * w * 1.5) / (0.07 * w))
        img[er < 1] = (40, 30, 35)
    img[(np.abs(yy - cy - 0.2 * h) < 0.025 * h)
        & (np.abs(xx - cx) < 0.12 * w)] = (150, 40, 50)
    img += 30 * np.sin(xx / (3 + seed) + yy / 7.0)[..., None] * rng.rand(3)
    img += rng.randn(h, w, 3) * 6
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def make_fixtures(out: Path) -> None:
    """Write the fixture JPEGs into ``out``."""
    from PIL import Image

    out.mkdir(parents=True, exist_ok=True)
    pil = [
        ("f420_224x224", (224, 224), dict(quality=90, subsampling=2)),
        ("f422_320x256", (320, 256), dict(quality=85, subsampling=1)),
        ("f444_97x131", (97, 131), dict(quality=95, subsampling=0)),
        ("f420_97x131", (97, 131), dict(quality=75, subsampling=2)),
        ("f422_131x97", (131, 97), dict(quality=80, subsampling=1)),
        ("f420_restart_150x113", (150, 113),
         dict(quality=88, subsampling=2, restart_marker_blocks=5)),
        ("f420_opt_q30_61x45", (61, 45),
         dict(quality=30, subsampling=2, optimize=True)),
        ("f420_tiny_3x9", (3, 9), dict(quality=90, subsampling=2)),
        # tables over 255 are written with 16-bit precision, and the frame
        # as SOF1
        ("f444_q16bit_77x59", (77, 59),
         dict(subsampling=0, qtables=[[300 + k for k in range(64)], [2] * 64])),
    ]
    for i, (name, (w, h), kw) in enumerate(pil):
        Image.fromarray(face_image(w, h, i)).save(out / f"{name}.jpg", **kw)
    gray = [("gray_131x97", (131, 97), dict(quality=90)),
            ("gray_restart_45x37", (45, 37),
             dict(quality=70, restart_marker_rows=1))]
    for i, (name, (w, h), kw) in enumerate(gray, 20):
        Image.fromarray(face_image(w, h, i)).convert("L").save(
            out / f"{name}.jpg", **kw)
    with tempfile.TemporaryDirectory() as tmp:
        src, exe, raw = Path(tmp) / "h.cc", Path(tmp) / "h", Path(tmp) / "in.rgb"
        src.write_text(_HELPER)
        subprocess.run(["g++", "-O2", "-o", str(exe), str(src), "-ljpeg"],
                       check=True)
        for i, (name, (w, h), q, hs, vs, rst) in enumerate([
                ("f440_101x77", (101, 77), 90, 1, 2, 0),
                ("f440_restart_64x96", (64, 96), 80, 1, 2, 2)], 30):
            raw.write_bytes(face_image(w, h, i).tobytes())
            subprocess.run([str(exe), str(raw), str(out / f"{name}.jpg"),
                            str(w), str(h), str(q), str(hs), str(vs), str(rst)],
                           check=True)


def fixture_paths() -> list:
    return sorted(FIXTURES.glob("*.jpg"))


def jax_teacher_logits(frames: np.ndarray, use_se: bool, dtype) -> np.ndarray:
    """The JAX package's full-width teacher through ``FaceTeacherPipeline``
    on uint8 frames [N, 224, 224, 1], fp32 convs at full precision."""
    import jax
    import jax.numpy as jnp

    from mcncrossmodalemotions_torch.zoo.bridge import random_teacher_variables
    from mcncrossmodalemotions_tpu.models.resnet import ResNet
    from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )

    v = random_teacher_variables(SEED, use_se=use_se)
    variables = {"params": {"teacher": v["params"]},
                 "batch_stats": {"teacher": v["batch_stats"]}}
    model = FaceTeacherPipeline(teacher=ResNet(use_se=use_se, dtype=dtype),
                                input_size=OUT_SIZE, augment=False)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda var, x: model.apply(var, x, train=False))(
            variables, jnp.asarray(frames))
    return np.asarray(out, np.float32)


def golden_arrays() -> dict:
    """Everything the golden file holds, computed afresh."""
    import jax.numpy as jnp
    from PIL import Image

    from mcncrossmodalemotions_tpu.data import native

    paths = fixture_paths()
    names = [p.stem for p in paths]
    out = {"names": np.asarray(names)}
    for key, ratio in CROPS.items():
        out[f"frames_{key}"] = native.decode_faces(
            [str(p) for p in paths], OUT_SIZE, ratio, num_threads=4)[..., 0]
    for p in paths:
        with Image.open(p) as img:
            out[f"rgb_{p.stem}"] = np.asarray(img.convert("RGB"))
    idx = np.asarray([names.index(n) for n in LOGIT_FIXTURES])
    out["logit_index"] = idx
    frames = out["frames_crop0625"][idx][..., None]
    for arch, use_se in (("senet50", True), ("resnet50", False)):
        for tag, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
            out[f"logits_{arch}_{tag}"] = jax_teacher_logits(frames, use_se,
                                                             dtype)
    return out


def jax_vgg16_logits(frames: np.ndarray, use_batchnorm: bool,
                     dtype) -> np.ndarray:
    """The JAX package's full-width VGG-VD-16 through
    ``FaceTeacherPipeline`` with the vgg_face mean on uint8 frames
    [N, 224, 224, 1], fp32 convs at full precision."""
    import jax
    import jax.numpy as jnp

    from mcncrossmodalemotions_torch.zoo.bridge import random_vggface_variables
    from mcncrossmodalemotions_tpu.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_tpu.models.vggface import VGGFace

    v = random_vggface_variables(SEED, arch="vd", use_batchnorm=use_batchnorm)
    variables = {k: {"teacher": tree} for k, tree in v.items()}
    model = FaceTeacherPipeline(
        teacher=VGGFace(arch="vd", use_batchnorm=use_batchnorm, dtype=dtype),
        input_size=OUT_SIZE, mean_rgb=VGG_FACE_MEAN, augment=False)
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda var, x: model.apply(var, x, train=False))(
            variables, jnp.asarray(frames))
    return np.asarray(out, np.float32)


def vgg16_golden_arrays() -> dict:
    """Everything the VGG-VD-16 golden holds, computed afresh on the
    teacher golden's four frames."""
    import jax.numpy as jnp

    gold = np.load(GOLDEN)
    frames = gold["frames_crop0625"][gold["logit_index"]][..., None]
    out = {}
    for arch, bn in (("vgg16", False), ("vgg16_bn", True)):
        for tag, dtype in (("fp32", jnp.float32), ("bf16", jnp.bfloat16)):
            out[f"logits_{arch}_{tag}"] = jax_vgg16_logits(frames, bn, dtype)
    return out


def _hold_logits(fresh: dict, gold) -> None:
    for key, val in fresh.items():
        scale = float(np.abs(gold[key]).max())
        err = float(np.abs(val - gold[key]).max())
        print(f"{key}: max abs diff {err:.3e} (max |golden| {scale:.3f})")
        assert err <= 1e-5 * scale, key


@pytest.mark.slow
def test_golden_rechecked():
    """The committed golden is what the committed fixtures, the committed
    library, PIL and the JAX package give today."""
    gold = np.load(GOLDEN)
    fresh = golden_arrays()
    assert sorted(gold.files) == sorted(fresh)
    _hold_logits({k: v for k, v in fresh.items() if k.startswith("logits_")},
                 gold)
    for key, val in fresh.items():
        if not key.startswith("logits_"):
            np.testing.assert_array_equal(val, gold[key], err_msg=key)


@pytest.mark.slow
def test_vgg16_golden_rechecked():
    """The committed VGG-VD-16 golden is what the JAX package gives today."""
    gold = np.load(VGG16_GOLDEN)
    fresh = vgg16_golden_arrays()
    assert sorted(gold.files) == sorted(fresh)
    _hold_logits(fresh, gold)


def main(argv) -> int:
    if "--fixtures" in argv:
        make_fixtures(FIXTURES)
        print(f"wrote {len(fixture_paths())} fixtures to {FIXTURES}")
    if "--golden" in argv:
        arrays = golden_arrays()
        np.savez_compressed(GOLDEN, **arrays)
        for key, val in arrays.items():
            if key.startswith("logits_"):
                print(key, np.round(val, 4).tolist())
        print(f"wrote {GOLDEN} ({GOLDEN.stat().st_size} bytes)")
    if "--vgg16-golden" in argv:
        arrays = vgg16_golden_arrays()
        np.savez_compressed(VGG16_GOLDEN, **arrays)
        for key, val in arrays.items():
            print(key, np.round(val, 4).tolist())
        print(f"wrote {VGG16_GOLDEN} ({VGG16_GOLDEN.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.exit(main(sys.argv[1:]))
