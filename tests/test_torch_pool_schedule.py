"""K2's forward schedule, rendered in numpy on the CPU.

``csrc/max_pool_3x3s2.cu`` cannot run here, so ``render_k2`` repeats the
forward's schedule as the kernel runs it: the launcher's vector width (16
bytes, one element where C x the element size is not a multiple of 16
bytes or a base pointer is not aligned to it), the strip plan (output rows a
thread walks, one strip per ``blockIdx.y``), the decode of a lane into
(b, oj, channel vector), each input row reduced over its three columns
first, then rows 0, 1, 2 combined in that order, the carried row whose
code offset drops from 6 to 0, and the stores (each the winner's own
bits, NaN payloads included). An index fault in that schedule shows here
as a disagreement with the plain version ``max_pool_3x3s2_with_index``:
``y`` bitwise, ``idx`` exactly.
"""

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.ops.pool import max_pool_3x3s2_with_index

MIN_STRIP, MAX_STRIP = 4, 16
FILL = 132 * 2048 * 2  # threads: two waves of 132 full SMs
ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# (H, W): the smallest input, odd H with even W, even H with odd W, two
# whole strips of 4 output rows (ho = 8) and one row past them (ho = 9)
SHAPES = [(3, 3), (9, 8), (10, 11), (17, 18), (19, 20)]


def vector_width(c, itemsize, misalign=0):
    """Elements a lane loads at once: 16 bytes where the vector divides C
    and the bases are 16-byte aligned (misalign, bytes), else one."""
    v = 16 // itemsize
    return v if c % v == 0 and misalign % 16 == 0 else 1


def strip_rows(columns, ho):
    """Output rows a thread walks: about FILL threads in the grid."""
    s = min(max(columns * ho // FILL, MIN_STRIP), MAX_STRIP)
    return max(min(s, ho), -(-ho // 65535))


def wins(v, m):
    """The running max's replace rule: strictly greater, or NaN."""
    return (v > m) | np.isnan(v)


def reduce_row(x, b, r, oj, ch):
    """Per lane and element: the max of input row r over columns 2oj,
    2oj+1, 2oj+2 of the lane's channels, and its column."""
    m = x[b, r, 2 * oj, ch]
    col = np.zeros(m.shape, np.int64)
    for dx in (1, 2):
        v = x[b, r, 2 * oj + dx, ch]
        take = wins(v, m)
        m, col = np.where(take, v, m), np.where(take, dx, col)
    return m, col


def render_k2(x, itemsize, misalign=0, strip=None):
    """[B, H, W, C] float32 (bf16-exact for itemsize 2) -> (y, idx) as the
    kernel computes them; y as the integer bits the kernel stores."""
    bsz, h, w, c = x.shape
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    v = vector_width(c, itemsize, misalign)
    nv = c // v
    columns = bsz * wo * nv
    strip = strip or strip_rows(columns, ho)
    y = np.full((bsz, ho, wo, c), np.nan, np.float32)
    idx = np.full((bsz, ho, wo, c), 255, np.int64)
    lane = np.arange(columns)  # blockIdx.x * THREADS + threadIdx.x
    t, vec = lane // nv, lane % nv
    b, oj = (t // wo)[:, None], (t % wo)[:, None]
    ch = vec[:, None] * v + np.arange(v)[None, :]
    for oi0 in range(0, ho, strip):  # blockIdx.y
        top, top_col = reduce_row(x, b, 2 * oi0, oj, ch)
        for oi in range(oi0, min(oi0 + strip, ho)):
            mid, mid_col = reduce_row(x, b, 2 * oi + 1, oj, ch)
            bot, bot_col = reduce_row(x, b, 2 * oi + 2, oj, ch)
            m, code = top, top_col
            take = wins(mid, m)
            m, code = np.where(take, mid, m), np.where(take, 3 + mid_col, code)
            take = wins(bot, m)
            m, code = np.where(take, bot, m), np.where(take, 6 + bot_col, code)
            y[b, oi, oj, ch], idx[b, oi, oj, ch] = m, code
            top, top_col = bot, bot_col  # row 2 becomes row 0: code 6 -> 0
    assert not (idx == 255).any(), "an output the grid did not cover"
    bits = y.view(np.uint32)
    return (bits >> 16 if itemsize == 2 else bits), idx


def render_columns_first(x):
    """The TPU kernel's order: down each window column first, then across
    the columns. Same maximum, another winner under ties."""
    h, w = x.shape[1:3]
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    at = lambda dy, dx: x[:, dy:dy + 2 * ho - 1:2, dx:dx + 2 * wo - 1:2]
    m = code = None
    for dx in range(3):
        cm, row = at(0, dx), np.zeros(at(0, dx).shape, np.int64)
        for dy in (1, 2):
            take = wins(at(dy, dx), cm)
            cm, row = np.where(take, at(dy, dx), cm), np.where(take, dy, row)
        if m is None:
            m, code = cm, 3 * row + dx
        else:
            take = wins(cm, m)
            m, code = np.where(take, cm, m), np.where(take, 3 * row + dx, code)
    return m, code


def make_input(kind, shape, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    if kind == "relu":
        return np.maximum(x, 0)
    if kind == "ints":  # ties everywhere
        return rng.randint(0, 3, shape).astype(np.float32)
    if kind == "nan":  # NaN in shared rows, halo columns and twice a window
        x = np.maximum(x, 0)
        x[rng.rand(*shape) < 0.08] = np.nan
        x[:, ::2, ::2][rng.rand(*x[:, ::2, ::2].shape) < 0.1] = np.nan
        return x
    if kind == "payloads":  # NaNs of three payloads: the last one wins
        x = np.maximum(x, 0)
        pick = rng.randint(0, 12, shape)
        for i, bits in enumerate((0x7FC00000, 0xFFFF0000, 0x7F810000)):
            x[pick == i] = np.uint32(bits).view(np.float32)
        return x
    if kind == "-inf":  # whole -inf windows and rows beside finite ones
        x[rng.rand(*shape) < 0.7] = -np.inf
        x[:, 2::4] = -np.inf
        return x
    # +0 and -0 only, ties between signed zeros
    return np.where(rng.rand(*shape) < 0.5, -0.0, 0.0).astype(np.float32)


def exact(x, dtype):
    """x in dtype with its NaN payloads: a bf16 NaN is the high half of
    the float's bits (torch's float -> bf16 cast would make it 0xFFFF)."""
    t = torch.from_numpy(x).to(dtype)
    if dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().copy()
        nan = np.isnan(x)
        bits[nan] = (x.view(np.uint32)[nan] >> 16).astype(np.uint16).view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    return t


def as_float(t):
    """float32 numpy array of a bf16 or fp32 tensor, bits kept."""
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
        return (bits << 16).astype(np.uint32).view(np.float32)
    return t.numpy()


def plain(t):
    """The plain version's (y bits, idx) for the tensor t."""
    y, idx = max_pool_3x3s2_with_index(t)
    bits = as_float(y.contiguous()).view(np.uint32)
    return (bits >> 16 if t.dtype == torch.bfloat16 else bits), \
        idx.numpy().astype(np.int64)


def assert_matches_plain(t, got, where=""):
    """idx exactly the plain version's; y bitwise the plain version's,
    except that a NaN is compared as NaN: the CPU's bf16 max pool keeps a
    NaN's payload on some channels and makes it 0x7FC0 on others (the
    card's keeps it). y is also held bit for bit to the input element its
    idx names, so a NaN's payload is the winner's own."""
    got_y, got_idx = got
    ref_y, ref_idx = plain(t)
    np.testing.assert_array_equal(got_idx, ref_idx, err_msg=f"idx {where}")
    bf16 = t.dtype == torch.bfloat16
    def nan(bits):
        bits = (bits << 16 if bf16 else bits).astype(np.uint32)
        return np.isnan(bits.view(np.float32))
    np.testing.assert_array_equal(nan(got_y), nan(ref_y), err_msg=f"NaN {where}")
    np.testing.assert_array_equal(np.where(nan(ref_y), 0, got_y),
                                  np.where(nan(ref_y), 0, ref_y),
                                  err_msg=f"y {where}")
    x = as_float(t).view(np.uint32)
    x = x >> 16 if bf16 else x
    ho, wo = got_y.shape[1:3]
    oi = np.arange(ho)[None, :, None, None]
    oj = np.arange(wo)[None, None, :, None]
    b = np.arange(x.shape[0])[:, None, None, None]
    ch = np.arange(x.shape[3])[None, None, None, :]
    winner = x[b, 2 * oi + got_idx // 3, 2 * oj + got_idx % 3, ch]
    np.testing.assert_array_equal(got_y, winner, err_msg=f"winner {where}")


@pytest.mark.parametrize("c", [1, 3, 4, 8, 12, 96, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["relu", "ints", "nan", "payloads", "-inf",
                                  "zeros"])
def test_schedule_matches_plain_bitwise(kind, dtype, c):
    for h, w in SHAPES:
        t = exact(make_input(kind, (2, h, w, c), h * w + c), dtype)
        assert_matches_plain(t, render_k2(as_float(t), ITEMSIZE[dtype]),
                             f"at {h}x{w}")


@pytest.mark.parametrize("strip", [1, 5, 16])
@pytest.mark.parametrize("kind", ["relu", "ints", "nan"])
def test_long_strips_carry_the_row(kind, strip):
    """The strip lengths of the full-size launches (5 at the train step's
    pool2, 16 at pool1), here over 33 output rows: strips end inside the
    image, at its last row, and one row past a whole strip."""
    for h in (2 * strip * 2 + 1, 2 * strip * 2 + 3, 12):
        t = exact(make_input(kind, (2, h, 13, 8), h + strip), torch.bfloat16)
        assert_matches_plain(t, render_k2(as_float(t), 2, strip=strip))


@pytest.mark.parametrize("c,misalign", [(12, 0), (3, 0), (8, 2), (8, 8)])
def test_narrow_paths_match_plain(c, misalign):
    """C=12 in bf16 (24 bytes), C=3, and a base 2 or 8 bytes off 16: one
    element a lane."""
    t = exact(make_input("ints", (3, 9, 11, c), c + misalign), torch.bfloat16)
    assert_matches_plain(t, render_k2(as_float(t), 2, misalign=misalign))


def test_columns_first_order_is_caught():
    """The trap: rows [0,5,0] and [5,0,0] tie at 5. Row-major picks (0,1),
    down-the-columns-first (1,0); a schedule in that order fails here."""
    x = np.zeros((1, 3, 3, 1), np.float32)
    x[0, 0, 1, 0] = x[0, 1, 0, 0] = 5
    m, code = render_columns_first(x)
    _, ref_idx = plain(torch.from_numpy(x))
    assert m.item() == 5 and code.item() == 3 and ref_idx.item() == 1
    assert render_k2(x, 4)[1].item() == 1
    ties = make_input("ints", (2, 17, 18, 8), 0)
    _, ref_idx = plain(torch.from_numpy(ties))
    _, code = render_columns_first(ties)
    np.testing.assert_array_equal(render_k2(ties, 4)[1], ref_idx)
    assert (code != ref_idx).mean() > 0.05
