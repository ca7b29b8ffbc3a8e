"""The port's own face-frame decoder, ``csrc/dataservice_faces.cc``.

Built here with ``g++`` by ``ops/_build.py``. Its RGB is held bit for bit
to PIL's (libjpeg-turbo) on every fixture of ``tests/fixtures/torch_faces``,
its ``decode_faces`` frames bit for bit to the committed
``native/libdataservice.so`` (libjpeg) at both crops and several output
sizes, and to the golden's frames of that library; within one gray level
of the PIL route. Entropy data cut short decodes as libjpeg decodes it.
Files it does not take (progressive, arithmetic, 12-bit, CMYK, over 64 MP,
a malformed or truncated header, no file) fail that frame only, and the
process decodes on. A broken source makes the build raise with the
compiler's output, and ``load_frame_batch`` does not fall back to PIL when
the library cannot be built. The host copies of ``data/images.py`` equal
the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pytest
from PIL import Image

from mcncrossmodalemotions_torch.data import images, native_faces
from mcncrossmodalemotions_torch.ops import _build
from mcncrossmodalemotions_tpu.data import images as jimages
from mcncrossmodalemotions_tpu.data import native as jnative
from tests.test_torch_teacher_golden import CROPS, FIXTURES, GOLDEN

NAMES = sorted(p.stem for p in FIXTURES.glob("*.jpg"))
needs_jnative = pytest.mark.skipif(
    not jnative.available(),
    reason="native/libdataservice.so does not load on this host")


def _path(name: str) -> str:
    return str(FIXTURES / f"{name}.jpg")


def test_the_fixtures_cover_the_decoder():
    """13 fixtures under 300 KB: every sampling, restarts, odd sizes."""
    assert len(NAMES) == 13
    assert sum((FIXTURES / f"{n}.jpg").stat().st_size for n in NAMES) < 300_000
    samplings = set()
    for n in NAMES:
        with Image.open(_path(n)) as img:
            samplings.add((img.mode,) + tuple(img.layer[0][1:3]))
    assert samplings >= {("RGB", 2, 2), ("RGB", 2, 1), ("RGB", 1, 2),
                         ("RGB", 1, 1), ("L", 1, 1)}
    assert b"\xff\xc1" in (FIXTURES / "f444_q16bit_77x59.jpg").read_bytes()
    assert b"\xff\xdd" in (FIXTURES / "f420_restart_150x113.jpg").read_bytes()


def test_the_library_is_built_from_its_source():
    assert native_faces.available()
    assert _build.library_path(native_faces.LIBRARY).exists()
    assert _build.source_path(native_faces.LIBRARY).name == "dataservice_faces.cc"


@pytest.mark.parametrize("name", NAMES)
def test_rgb_bitwise_equal_to_pil(name):
    got = native_faces.decode_jpeg_rgb(_path(name))
    with Image.open(_path(name)) as img:
        ref = np.asarray(img.convert("RGB"))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", NAMES)
def test_rgb_bitwise_equal_to_the_golden_pil_decode(name):
    np.testing.assert_array_equal(native_faces.decode_jpeg_rgb(_path(name)),
                                  np.load(GOLDEN)[f"rgb_{name}"])


@pytest.mark.parametrize("crop", sorted(CROPS))
def test_faces_bitwise_equal_to_the_golden_frames(crop):
    """The frames the card's host must give: the committed library's."""
    gold = np.load(GOLDEN)
    assert list(gold["names"]) == NAMES
    got = native_faces.decode_faces([_path(n) for n in NAMES], 224,
                                    CROPS[crop], num_threads=4)[..., 0]
    np.testing.assert_array_equal(got, gold[f"frames_{crop}"])


@needs_jnative
@pytest.mark.parametrize("size", [224, 64, 37, 2])
@pytest.mark.parametrize("crop", [1.0 / 1.6, 1.0, 0.3])
def test_faces_bitwise_equal_to_the_committed_library(size, crop):
    paths = [_path(n) for n in NAMES]
    got = native_faces.decode_faces(paths, size, crop, num_threads=3)
    ref = jnative.decode_faces(paths, size, crop, num_threads=3)
    np.testing.assert_array_equal(got, ref)


def test_faces_within_one_level_of_the_pil_route():
    for name in NAMES:
        got = native_faces.decode_faces([_path(name)], 48)[0]
        ref = images.load_face_frame(_path(name), 48)
        diff = np.abs(got.astype(int) - ref.astype(int)).max()
        assert diff <= 1, (name, diff)


def test_single_and_batched_entry_points_and_threads_agree():
    import ctypes

    paths = [_path(n) for n in NAMES]
    base = native_faces.decode_faces(paths, 40, num_threads=1)
    np.testing.assert_array_equal(
        native_faces.decode_faces(paths, 40, num_threads=8), base)
    lib = native_faces._load()
    for i, p in enumerate(paths):
        one = np.zeros((40, 40), np.uint8)
        rc = lib.ds_decode_face(p.encode(), 40, 1.0 / 1.6,
                                one.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        assert rc == 0
        np.testing.assert_array_equal(one, base[i, ..., 0])


def _pool_cpu_ticks() -> dict:
    """CPU clock ticks used so far by each of this process's pool threads
    (named ``ds-faces``), by thread id."""
    from pathlib import Path

    out = {}
    for task in Path("/proc/self/task").glob("*"):
        try:
            if (task / "comm").read_text().strip() != "ds-faces":
                continue
            stat = (task / "stat").read_text()
        except OSError:
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        out[task.name] = int(fields[11]) + int(fields[12])
    return out


@pytest.mark.parametrize("threads", [1, 2, 3])
def test_a_call_uses_no_more_threads_than_it_asks_for(threads):
    """The pool is shared and only grows; a call at fewer threads than its
    size still decodes on at most that many of them."""
    paths = [_path("f420_224x224")] * 480
    native_faces.decode_faces(paths[:64], 224, num_threads=8)  # pool >= 8
    before = _pool_cpu_ticks()
    assert len(before) >= 8
    native_faces.decode_faces(paths, 224, num_threads=threads)
    after = _pool_cpu_ticks()
    busy = [t for t, ticks in after.items() if ticks > before.get(t, 0)]
    assert 1 <= len(busy) <= threads, (threads, busy)


def _entropy_start(data: bytes) -> int:
    sos = data.index(b"\xff\xda")
    return sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")


def _mcu(name: str) -> tuple:
    """(height, width) of the fixture's MCU in pixels."""
    with Image.open(_path(name)) as img:
        _, h, v, _ = img.layer[0]
        return (8 * v, 8 * h) if img.mode == "RGB" else (8, 8)


@needs_jnative
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.24, 0.45, 0.6, 0.8, 0.9, 0.99])
def test_truncated_entropy_data_decodes_as_libjpeg(tmp_path, frac):
    """libjpeg's rule for entropy data cut short: zero bits for the MCU
    that runs out, zero coefficients (mid gray) for every MCU after it.
    Every pixel outside the MCU that ran out is the committed library's;
    inside it, the coefficients decoded from zero bits are garbage that
    can leave the IDCT's range, where the port follows jidctint.c (a
    range-limit table that wraps) and libjpeg-turbo's SIMD IDCT saturates:
    a known deviation (CHANGES.md), counted and printed here."""
    exact = 0
    for name in NAMES:
        data = (FIXTURES / f"{name}.jpg").read_bytes()
        start = _entropy_start(data)
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data[:start + int(frac * (len(data) - start))])
        h, w = Image.open(_path(name)).size[::-1]
        side = min(h, w)
        top, left = (h - side) // 2, (w - side) // 2
        # out_size == side at crop 1.0: the resize is the identity
        got = native_faces.decode_faces([str(path)], side, 1.0)[0, ..., 0]
        ref = jnative.decode_faces([str(path)], side, 1.0)[0, ..., 0]
        differ = np.argwhere(got != ref)
        mh, mw = _mcu(name)
        mcus = {((y + top) // mh, (x + left) // mw) for y, x in differ}
        assert len(mcus) <= 1, (name, sorted(mcus))
        exact += not len(differ)
    print(f"cut at {frac:.0%} of the entropy data: {exact}/{len(NAMES)} "
          "fixtures bitwise equal")


@needs_jnative
def test_corrupt_entropy_data_is_a_known_deviation(tmp_path):
    """Flipped bits inside the entropy data: both decoders decode, and
    agree above the corruption, but not below it: the coefficients that
    the flip garbles leave the IDCT's range, where the port follows
    jidctint.c's C arithmetic and range-limit table and libjpeg-turbo's
    SIMD IDCT works in 16-bit lanes that wrap and saturate. No encoder
    writes such coefficients (CHANGES.md)."""
    name = "f444_q16bit_77x59"
    data = bytearray((FIXTURES / f"{name}.jpg").read_bytes())
    start = _entropy_start(bytes(data))
    at = start + int(0.8 * (len(data) - start))
    data[at] ^= 0x10
    path = tmp_path / "flipped.jpg"
    path.write_bytes(bytes(data))
    got = native_faces.decode_jpeg_rgb(str(path))
    side = min(got.shape[:2])
    port = native_faces.decode_faces([str(path)], side, 1.0)[0, ..., 0]
    ref = jnative.decode_faces([str(path)], side, 1.0)[0, ..., 0]
    differ = np.argwhere(port != ref)
    print(f"{len(differ)} of {port.size} pixels differ, first row "
          f"{differ[:, 0].min() if len(differ) else None}")
    assert len(differ) > 0  # the deviation this test documents
    np.testing.assert_array_equal(port[:16], ref[:16])  # above the flip


def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    assert old in data
    return data.replace(old, new, 1)


def _bad_files(tmp_path) -> dict:
    """name -> path of a file the decoder must refuse."""
    good = (FIXTURES / "f420_97x131.jpg").read_bytes()
    sof = good.index(b"\xff\xc0")
    src = Image.open(_path("f420_97x131")).convert("RGB")
    files = {}

    def put(name, data):
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(data)
        files[name] = str(path)

    put("truncated_header", good[:40])
    put("truncated_in_sof", good[:sof + 8])
    put("empty", b"")
    put("not_a_jpeg", b"\x89PNG\r\n\x1a\n" + bytes(200))
    put("no_scan", good[:sof] + b"\xff\xd9")
    put("arithmetic", _patched(good, b"\xff\xc0", b"\xff\xc9"))
    put("lossless", _patched(good, b"\xff\xc0", b"\xff\xc3"))
    twelve = bytearray(good)
    twelve[sof + 4] = 12
    put("12bit", bytes(twelve))
    huge = bytearray(good)
    huge[sof + 5:sof + 9] = (65500).to_bytes(2, "big") * 2
    put("over_64mp", bytes(huge))
    bad_dht = bytearray(good)
    dht = good.index(b"\xff\xc4")
    bad_dht[dht + 5:dht + 21] = bytes([255] * 16)  # counts overflow
    put("bad_huffman_table", bytes(bad_dht))
    for name, kw in (("progressive", dict(progressive=True)),
                     ("cmyk", {})):
        path = tmp_path / f"{name}.jpg"
        (src.convert("CMYK") if name == "cmyk" else src).save(path, quality=90,
                                                             **kw)
        files[name] = str(path)
    files["missing"] = str(tmp_path / "missing.jpg")
    return files


REFUSED = ["truncated_header", "truncated_in_sof", "empty", "not_a_jpeg",
           "no_scan", "arithmetic", "lossless", "12bit", "over_64mp",
           "bad_huffman_table", "progressive", "cmyk", "missing"]


@pytest.mark.parametrize("name", REFUSED)
def test_a_refused_file_fails_its_frame_only(tmp_path, name):
    bad = _bad_files(tmp_path)[name]
    good = [_path(n) for n in NAMES[:3]]
    with pytest.raises(IOError, match="1/4 files failed"):
        native_faces.decode_faces(good[:1] + [bad] + good[1:], 32)
    with pytest.raises(IOError, match="ds_decode_jpeg_rgb"):
        native_faces.decode_jpeg_rgb(bad)
    # and the process is healthy: the good files decode as before
    out = native_faces.decode_faces(good, 32)
    np.testing.assert_array_equal(
        out, np.concatenate([native_faces.decode_faces([g], 32) for g in good]))


@needs_jnative
def test_the_committed_library_refuses_the_same_malformed_headers(tmp_path):
    """Where libjpeg refuses a file the port refuses it too; the port
    also refuses progressive, arithmetic and CMYK files, which libjpeg
    decodes (no face frame of the reference's is coded so)."""
    files = _bad_files(tmp_path)
    for name in ("truncated_header", "truncated_in_sof", "empty",
                 "not_a_jpeg", "no_scan", "12bit", "over_64mp",
                 "bad_huffman_table", "missing"):
        with pytest.raises(IOError):
            jnative.decode_faces([files[name]], 32)


def test_an_output_size_below_two_is_refused_before_the_library():
    # the resize divides by out_size - 1
    with pytest.raises(ValueError, match="out_size"):
        native_faces.decode_faces([_path(NAMES[0])], 1)


def test_return_codes_name_the_reason(tmp_path):
    files = _bad_files(tmp_path)
    for name, reason in (("missing", "cannot be read"),
                         ("truncated_header", "malformed header"),
                         ("progressive", "unsupported coding"),
                         ("cmyk", "unsupported coding"),
                         ("12bit", "unsupported coding"),
                         ("over_64mp", "over 64 MP")):
        with pytest.raises(IOError, match=reason):
            native_faces.decode_jpeg_rgb(files[name])


def test_a_broken_source_makes_the_build_raise(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    text = _build.source_path(native_faces.LIBRARY).read_text()
    (src / "broken_faces.cc").write_text(
        text.replace("int ds_decode_face(", "int ds_decode_face(undeclared_t x, "))
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken_faces.cc"
                       "(.|\n)*undeclared_t"):
        _build.load("broken_faces")
    assert not _build.library_path("broken_faces").exists()


def test_a_failed_build_does_not_fall_back_to_pil(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / f"{native_faces.LIBRARY}.cc").write_text("#error no decoder here\n")
    monkeypatch.setattr(_build, "CSRC", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native_faces, "_lib", None)
    with pytest.raises(RuntimeError, match="no decoder here"):
        images.load_frame_batch([_path(NAMES[0])], 32)


def test_load_frame_batch_reads_through_the_library(monkeypatch):
    paths = [_path(n) for n in NAMES]
    lib = images.load_frame_batch(paths, 56, num_threads=2)
    np.testing.assert_array_equal(
        lib, native_faces.decode_faces(paths, 56, images.CROP_RATIO))
    monkeypatch.setenv("MCNCME_DISABLE_NATIVE", "1")
    pil = images.load_frame_batch(paths, 56, num_threads=2)
    assert pil.shape == lib.shape == (len(paths), 56, 56, 1)
    assert np.abs(pil.astype(int) - lib.astype(int)).max() <= 1
    with pytest.raises(RuntimeError, match="switched off"):
        native_faces.decode_faces(paths, 56)


def test_host_copies_equal_the_jax_package(tmp_path):
    assert images.CROP_RATIO == jimages.CROP_RATIO
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    for out in ((224, 224), (5, 9), (1, 1), (37, 53)):
        np.testing.assert_array_equal(images.resize_bilinear_np(img, *out),
                                      jimages.resize_bilinear_np(img, *out))
    for i in range(3):
        a, b = tmp_path / f"a{i}.jpg", tmp_path / f"b{i}.jpg"
        images.save_synthetic_frame(a, i, size=40, seed=i)
        jimages.save_synthetic_frame(b, i, size=40, seed=i)
        assert a.read_bytes() == b.read_bytes()
        for crop in (1.0, 1.0 / 1.6):
            np.testing.assert_array_equal(
                images.load_face_frame(a, 24, crop),
                jimages.load_face_frame(b, 24, crop))
