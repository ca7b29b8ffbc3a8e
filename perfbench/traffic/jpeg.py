"""A baseline JPEG writer: a frozen copy of the port's numpy coder
(``data/images.encode_jpeg`` and ``synthetic_frame_pixels``), so that the
files the benchmark decodes never change with the program. A gray image
is written as Y of a YCbCr 4:2:0 file with flat chroma and the standard
(T.81 Annex K) tables at quality 92. ``quantised_luma`` gives the Y
plane's quantised DCT coefficients, from which the plain reference
decodes the file's content without a JPEG decoder."""

from __future__ import annotations

from typing import Sequence

import numpy as np

ZIGZAG = np.asarray([i * 8 + j for i, j in sorted(
    ((i, j) for i in range(8) for j in range(8)),
    key=lambda p: (p[0] + p[1], p[0] if (p[0] + p[1]) % 2 else -p[0]))])
_K = np.arange(8)
DCT = np.sqrt(2 / 8) * np.cos((2 * _K[None, :] + 1) * _K[:, None] * np.pi / 16)
DCT[0] /= np.sqrt(2)

# T.81 Annex K.1: the luminance and chrominance quantisation tables, in
# natural (row-major) order
_LUMA_Q = np.asarray([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.full(64, 99)
_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# T.81 Annex K.3: the standard Huffman tables as (bits, values): the code
# count of each length 1..16, then the symbols in code order
_AC_LUMA_VALUES = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALUES = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STANDARD_HUFFMAN = (
    (0x00, bytes([0, 1, 5, 1, 1, 1, 1, 1, 1] + [0] * 7), bytes(range(12))),
    (0x10, bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]),
     _AC_LUMA_VALUES),
    (0x01, bytes([0, 3] + [1] * 9 + [0] * 5), bytes(range(12))),
    (0x11, bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
     _AC_CHROMA_VALUES),
)
QUALITY = 92  # the JAX package's save_synthetic_frame (PIL, quality=92)
_JFIF = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def quality_table(base: np.ndarray) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table at ``QUALITY``
    (50 or more: 200 - 2 x quality percent, 16% at 92), clamped to 1..255
    as a baseline table must be."""
    return np.clip((base * (200 - 2 * QUALITY) + 50) // 100, 1, 255)


def huffman_codes(bits: bytes, values: bytes) -> tuple:
    """The canonical codes of a DHT table: (code, length) arrays indexed
    by symbol (length 0: not in the table)."""
    code_of = np.zeros(256, np.int64)
    length_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            code_of[values[k]], length_of[values[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return code_of, length_of


def zigzag_coefficients(img: np.ndarray, q: np.ndarray) -> np.ndarray:
    """[H, W] uint8 (multiples of 8) -> [blocks, 64] DCT coefficients
    quantised by ``q`` (natural order, or a scalar), in zigzag order,
    blocks in raster order."""
    h, w = img.shape
    blocks = (img.astype(np.float64) - 128).reshape(
        h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    q = np.broadcast_to(np.asarray(q, np.float64).reshape(-1), (64,))
    coef = np.round(DCT @ blocks @ DCT.T / q.reshape(8, 8)).astype(np.int64)
    return coef.reshape(-1, 64)[:, ZIGZAG]


def _magnitude(v: np.ndarray) -> tuple:
    """(bits, size) of each value: its T.81 category and the low ``size``
    bits of v (v - 1 for a negative v)."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    return np.where(v >= 0, v, v + (1 << size) - 1), size


def entropy_scan(zz: np.ndarray, components: np.ndarray,
                 tables: Sequence[tuple]) -> bytes:
    """The baseline scan of ``[blocks, 64]`` zigzag coefficients in scan
    order: block i belongs to component ``components[i]``, is coded with
    that component's (DC, AC) ``huffman_codes`` in ``tables`` and has its
    DC predicted from the component's previous block; padded with ones
    and 0xFF-stuffed."""
    n = zz.shape[0]
    comp = np.asarray(components, np.int64)
    dc_code, dc_len, ac_code, ac_len = (np.stack([t[i][j] for t in tables])
                                        for i in (0, 1) for j in (0, 1))
    diff = np.empty(n, np.int64)
    for c in range(len(tables)):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(zz[idx, 0], prepend=0)
    # one item a code (and the magnitude bits after it), sorted by block,
    # then position: DC at 0, the ZRLs before the coefficient at k at
    # 32k + 0..2, the coefficient at 32k + 3, EOB at 32 * 64
    keys, values, lengths = [], [], []

    def add(key, codes, lens, c, symbol, bits=0, size=0):
        keys.append(key)
        values.append((codes[c, symbol] << size) | bits)
        lengths.append(lens[c, symbol] + size)

    bits, size = _magnitude(diff)
    add(np.arange(n) * 4096, dc_code, dc_len, comp, size, bits, size)
    b, k = np.nonzero(zz[:, 1:])
    k = k + 1
    first = np.r_[True, b[1:] != b[:-1]]  # the block's first nonzero AC
    run = k - np.where(first, 0, np.r_[0, k[:-1]]) - 1
    zrl = run // 16
    z = np.repeat(np.arange(len(b)), zrl)
    nth = np.arange(len(z)) - np.repeat(np.cumsum(zrl) - zrl, zrl)
    add(b[z] * 4096 + k[z] * 32 + nth, ac_code, ac_len, comp[b[z]], 0xF0)
    bits, size = _magnitude(zz[b, k])
    add(b * 4096 + k * 32 + 3, ac_code, ac_len, comp[b],
        ((run % 16) << 4) | size, bits, size)
    last = np.zeros(n, np.int64)
    last[b] = k  # b ascends, so the block's last nonzero position stays
    eob = np.flatnonzero(last < 63)
    add(eob * 4096 + 2048, ac_code, ac_len, comp[eob], 0x00)
    order = np.argsort(np.concatenate(keys), kind="stable")
    values = np.concatenate(values)[order]
    lengths = np.concatenate(lengths)[order]
    # each item's bits, most significant first, then ones to a byte
    total = int(lengths.sum())
    item = np.repeat(np.arange(len(values)), lengths)
    shift = np.repeat(np.cumsum(lengths), lengths) - 1 - np.arange(total)
    stream = ((values[item] >> shift) & 1).astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-total % 8, np.uint8)])
    return np.packbits(stream).tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def jpeg_file(height: int, width: int, components: Sequence[tuple],
              qtables: Sequence[np.ndarray], huffman: Sequence[tuple],
              scan: bytes, jfif: bool = False) -> bytes:
    """A baseline JPEG: ``components`` as (sampling byte, quantisation
    table, DC table << 4 | AC table), ids 1.. in order; ``qtables``
    (natural order, 8-bit) in one DQT segment; ``huffman`` as (class << 4
    | id, bits, values) in one DHT segment; one interleaved ``scan``."""
    dqt = b"".join(bytes([i]) + bytes(np.asarray(t).reshape(-1)[ZIGZAG]
                                      .astype(np.uint8))
                   for i, t in enumerate(qtables))
    dht = b"".join(bytes([tc]) + bits + values for tc, bits, values in huffman)
    sof = (bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
           + bytes([len(components)]) + b"".join(
               bytes([i + 1, samp, tq])
               for i, (samp, tq, _) in enumerate(components)))
    sos = (bytes([len(components)]) + b"".join(
        bytes([i + 1, td]) for i, (_, _, td) in enumerate(components))
        + bytes([0, 63, 0]))
    return (b"\xff\xd8" + (_segment(0xE0, _JFIF) if jfif else b"")
            + _segment(0xDB, dqt) + _segment(0xC0, sof)
            + _segment(0xC4, dht) + _segment(0xDA, sos) + scan + b"\xff\xd9")


def encode_jpeg(img: np.ndarray) -> bytes:
    """[H, W] uint8 gray -> a YCbCr 4:2:0 baseline JPEG with Y = img and
    flat chroma (Cb = Cr = 128), the standard tables at quality 92: what
    PIL writes for ``Image.fromarray(img).convert("RGB")`` (whose libjpeg
    makes Y = gray and Cb = Cr = 128 exactly). A side that is not a
    multiple of 16 is padded to one by repeating its last row or column,
    as libjpeg pads a partial MCU."""
    h, w = img.shape
    if not h or not w or h > 65535 or w > 65535:
        raise ValueError(f"encode_jpeg: a {h}x{w} image")
    qy = quality_table(_LUMA_Q)
    full = np.pad(img, ((0, -h % 16), (0, -w % 16)), mode="edge")
    rows, cols = full.shape[0] // 16, full.shape[1] // 16
    luma = zigzag_coefficients(full, qy).reshape(rows, 2, cols, 2, 64)
    # an MCU: Y's 2x2 blocks in raster order, then Cb and Cr (all zero)
    zz = np.concatenate(
        [luma.transpose(0, 2, 1, 3, 4).reshape(rows * cols, 4, 64),
         np.zeros((rows * cols, 2, 64), np.int64)], axis=1)
    luma_t, chroma_t = (tuple(huffman_codes(bits, values)
                              for _, bits, values in STANDARD_HUFFMAN[i:i + 2])
                        for i in (0, 2))
    scan = entropy_scan(zz.reshape(-1, 64),
                        np.tile([0, 0, 0, 0, 1, 2], rows * cols),
                        [luma_t, chroma_t, chroma_t])
    return jpeg_file(h, w, [(0x22, 0, 0x00), (0x11, 1, 0x11), (0x11, 1, 0x11)],
                     [qy, quality_table(_CHROMA_Q)],
                     STANDARD_HUFFMAN, scan, jfif=True)


def synthetic_frame_pixels(pattern_id: int, size: int = 64,
                           seed: int = 0) -> np.ndarray:
    """The [size, size] uint8 face frame whose content encodes
    ``pattern_id``: the JAX package's ``save_synthetic_frame`` array."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    base = 127 + 120 * np.sin(2 * np.pi * (pattern_id + 1) * (xx + yy) / (4 * size))
    return np.clip(base + rng.randn(size, size) * 8, 0, 255).astype(np.uint8)


def quantised_luma(img: np.ndarray) -> tuple:
    """(the [H', W'] MCU-padded Y plane's zigzag coefficients
    ``[blocks, 64]`` in raster block order, the natural-order quantisation
    table, padded shape) of what ``encode_jpeg`` writes for ``img``."""
    h, w = img.shape
    qy = quality_table(_LUMA_Q)
    full = np.pad(img, ((0, -h % 16), (0, -w % 16)), mode="edge")
    return zigzag_coefficients(full, qy), qy, full.shape
