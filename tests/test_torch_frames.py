"""The port's baseline JPEG writer (``data/images.py``) against PIL.

The card's host has no PIL, so ``save_synthetic_frame`` writes JAX's pixel
array (``synthetic_frame_pixels``) through ``encode_jpeg``: a YCbCr 4:2:0
file with flat chroma and the standard tables at quality 92, which is the
file PIL writes for ``Image.fromarray(img).convert("RGB").save(...,
quality=92)``. Here, where PIL 12 is installed:

- the writer's files decode with PIL and with the port's decoder
  (``csrc/dataservice_faces.cc``) bit for bit, at sizes that fill whole
  MCUs and sizes that pad one;
- their SOF names the components and sampling factors PIL's does, and
  their quantisation and Huffman tables are PIL's;
- the numpy entropy coder gives the bytes of a per-coefficient loop
  (the soak's coder before it was vectorised) on random coefficients with
  long zero runs;
- the pixels: within ``SOURCE_MAX`` gray levels of the source array (the
  most PIL's own quality-92 file is off on these frames is 16; ours is
  within 3 of PIL's own on each frame), the mean within 0.25 of PIL's own
  mean error, and within ``PIL_MAX`` of PIL's file's pixels (measured 8,
  mean under 1.3);
- the pixel array is JAX's ``save_synthetic_frame``'s;
- the dense-genesis soak's frames (``tools/soak_dense_genesis.py``, gray
  files with fixed-length codes through the same writer) keep their bytes:
  a pinned sha256.
"""

from __future__ import annotations

import hashlib
import io

import numpy as np
import pytest
from PIL import Image

from mcncrossmodalemotions_torch.data import images, native_faces
from mcncrossmodalemotions_torch.tools import soak_dense_genesis as soak
from mcncrossmodalemotions_tpu.data import images as jimages

SOURCE_MAX = 18  # gray levels from the source array
PIL_MAX = 10  # gray levels from PIL's quality-92 file of the same array
SOAK_SHA256 = "fea7526938d615051586fba4b8c2ed766e1b236c852cf26dc3ee4a6d85bc0830"
CASES = [(16, 0, 0), (40, 3, 1), (48, 5, 2), (64, 6, 3), (80, 1, 4),
         (256, 2, 5), (17, 4, 6), (1, 0, 7)]


def _pil_file(px: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).convert("RGB").save(buf, format="JPEG", quality=92)
    return buf.getvalue()


def _segments(data: bytes) -> dict:
    """{marker: [payload, ...]} of the segments before the scan."""
    out: dict = {}
    i = 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        out.setdefault(data[i + 1], []).append(data[i + 4:i + 2 + n])
        i += 2 + n
    return out


def _tables(payloads: list, entry: int) -> dict:
    """{table id byte: table bytes} of DQT (``entry`` 64) or DHT (0)
    segments, however many tables each segment holds."""
    out = {}
    for p in payloads:
        i = 0
        while i < len(p):
            n = entry or 16 + sum(p[i + 1:i + 17])
            out[p[i]] = p[i + 1:i + 1 + n]
            i += 1 + n
    return out


def _gray(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("L")).astype(int)


@pytest.mark.parametrize("size,pattern,seed", CASES)
def test_files_decode_alike_and_near_the_source(tmp_path, size, pattern, seed):
    path = tmp_path / "f.jpg"
    images.save_synthetic_frame(path, pattern, size=size, seed=seed)
    px = images.synthetic_frame_pixels(pattern, size, seed)
    pil = np.asarray(Image.open(path).convert("RGB"))
    port = native_faces.decode_jpeg_rgb(str(path))
    assert port.shape == (size, size, 3)
    np.testing.assert_array_equal(port, pil)
    np.testing.assert_array_equal(pil[..., 0], pil[..., 2])  # flat chroma
    ours = pil[..., 0].astype(int)
    theirs = _gray(_pil_file(px))
    err, pil_err = np.abs(ours - px), np.abs(theirs - px)
    print(f"{size}: max |ours - source| {err.max()} (PIL's {pil_err.max()}), "
          f"mean {err.mean():.3f} ({pil_err.mean():.3f}); max |ours - PIL's| "
          f"{np.abs(ours - theirs).max()}")
    assert err.max() <= SOURCE_MAX
    assert err.mean() <= pil_err.mean() + 0.25
    assert np.abs(ours - theirs).max() <= PIL_MAX


def test_headers_are_pils():
    px = images.synthetic_frame_pixels(3, 64, 1)
    ours, theirs = _segments(images.encode_jpeg(px)), _segments(_pil_file(px))
    assert ours[0xC0] == theirs[0xC0]  # 8 bits, 64x64, Y 2x2, Cb/Cr 1x1
    assert ours[0xC0][0][5:] == bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    assert _tables(ours[0xDB], 64) == _tables(theirs[0xDB], 64)
    assert _tables(ours[0xC4], 0) == _tables(theirs[0xC4], 0)
    assert ours[0xE0] == theirs[0xE0]  # JFIF 1.1


def _loop_scan(zz: np.ndarray, components, tables) -> bytes:
    """A per-coefficient reference coder (the soak's loop, with a table
    set and a DC predictor per component)."""
    acc, nbits, prev = 0, 0, {}

    def put(value: int, size: int) -> None:
        nonlocal acc, nbits
        acc, nbits = (acc << size) | value, nbits + size

    def magnitude(v: int) -> tuple:
        size = abs(v).bit_length()
        return (v if v >= 0 else v + (1 << size) - 1), size

    def code(table, symbol):
        put(int(table[0][symbol]), int(table[1][symbol]))

    for z, c in zip(zz.tolist(), components):
        dc, ac = tables[c]
        bits, size = magnitude(z[0] - prev.get(c, 0))
        prev[c] = z[0]
        code(dc, size)
        put(bits, size)
        run = 0
        for v in z[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                code(ac, 0xF0)
                run -= 16
            bits, size = magnitude(v)
            code(ac, (run << 4) | size)
            put(bits, size)
            run = 0
        if run:
            code(ac, 0x00)
    pad = -nbits % 8
    put((1 << pad) - 1, pad)
    return acc.to_bytes(nbits // 8, "big").replace(b"\xff", b"\xff\x00")


@pytest.mark.parametrize("seed", range(4))
def test_entropy_coder_equals_a_loop(seed):
    rng = np.random.RandomState(seed)
    n = 60
    zz = rng.randint(-300, 301, (n, 64)) * (rng.rand(n, 64) < 0.15)
    zz[::5, 1:] = 0  # blocks of DC alone
    zz[1::5, 63] = -1  # blocks ending at the last coefficient
    zz[2::5, 1:40] = 0  # runs past 16 (ZRL)
    zz[:, 0] = rng.randint(-1000, 1001, n)
    components = np.tile([0, 0, 0, 0, 1, 2], n // 6)
    luma, chroma = (tuple(images.huffman_codes(bits, values)
                          for _, bits, values in images.STANDARD_HUFFMAN[i:i + 2])
                    for i in (0, 2))
    tables = [luma, chroma, chroma]
    assert (images.entropy_scan(zz, components, tables)
            == _loop_scan(zz, components, tables))


def test_pixels_are_jaxs(monkeypatch, tmp_path):
    seen = []
    fromarray = Image.fromarray

    def spy(arr, *a, **k):
        seen.append(np.array(arr))
        return fromarray(arr, *a, **k)

    monkeypatch.setattr(Image, "fromarray", spy)
    for pattern, size, seed in ((2, 64, 0), (6, 40, 11)):
        jimages.save_synthetic_frame(tmp_path / "j.jpg", pattern, size=size,
                                     seed=seed)
        np.testing.assert_array_equal(
            seen.pop(), images.synthetic_frame_pixels(pattern, size, seed))


def test_soak_frames_keep_their_bytes():
    h = hashlib.sha256()
    for track, count in ((0, 70), (5, 3), (31, 1)):
        for data in soak.track_frames(track, count):
            h.update(data)
    assert h.hexdigest() == SOAK_SHA256


def test_no_pil_on_the_write_path(monkeypatch, tmp_path):
    """The writer reaches no PIL: with ``PIL`` unimportable the frames and
    a synthetic imdb with frames are still written."""
    import builtins
    import sys

    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL on this host")
        return real_import(name, *a, **k)

    monkeypatch.delitem(sys.modules, "PIL", raising=False)
    monkeypatch.delitem(sys.modules, "PIL.Image", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    imdb = build_synthetic_imdb(tmp_path / "wavs", num_speakers=1,
                                tracks_per_speaker=2,
                                duration_range=(1.0, 1.2), with_frames=True)
    frames = [tmp_path / "frames" / f for t in imdb.dense_frames for f in t]
    assert frames and all(f.read_bytes()[:2] == b"\xff\xd8" for f in frames)
    with pytest.raises(ValueError, match="image"):
        images.encode_jpeg(np.zeros((0, 8), np.uint8))
