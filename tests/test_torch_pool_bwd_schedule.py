"""K2's backward schedule, rendered in numpy on the CPU.

``csrc/max_pool_3x3s2.cu`` cannot run here, so ``render_k2_bwd`` repeats
the backward's schedule as the kernel runs it: the launcher's vector width
(16 bytes of dy and dx, V bytes of idx; one element a lane where C x the
element size is not a multiple of 16 bytes or a base is off its
alignment), the strip plan (output rows a lane walks, one strip per
``blockIdx.y``), the decode of a lane into (b, window column oj, channel
vector) with the tail lane oj = wo, the row above a strip read to seed its
carry, per output row input rows 2k (the carry plus row k's position-0
shares) and 2k+1, the carry of positions 2, input row 0 and the tail
columns and rows, and the fp32 sums from +0 rounded once.

The rule it must give is autograd of ``F.max_pool2d`` on the card, whose
channels-last backward copies dy (bits and all) to an element that one
window alone covers and sums from +0 where two or more do. The CPU's
autograd and the plain version ``max_pool_3x3s2_backward_from_index`` sum
from +0 everywhere (-0.0 becomes +0 there), and the CPU's bf16 autograd
sums in bf16. So the render is held bitwise to ``card_rule``: the plain
version's sums, with each one-window element's dy copied in; and the plain
version to fp32 autograd of ``F.max_pool2d`` rounded once. A NaN is
compared as NaN where it is a sum (its bits depend on the machine's float
adds and conversions), bit for bit where it is copied. An index or order
fault in the schedule shows here.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcncrossmodalemotions_torch.ops.pool import (
    max_pool_3x3s2_backward_from_index,
    max_pool_3x3s2_with_index,
)

MIN_STRIP, MAX_STRIP = 4, 16
FILL = 132 * 2048 * 2  # lanes: two waves of 132 full SMs
ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# (H, W): the smallest input, odd H with even W, even H with odd W, two
# whole strips of 4 output rows (ho = 8) and one row past them (ho = 9)
SHAPES = [(3, 3), (9, 8), (10, 11), (17, 18), (19, 20)]
ZERO = np.float32(0)


def vector_width(c, itemsize, misalign=(0, 0, 0)):
    """Elements a lane takes at once: 16 bytes of dy and dx where the
    vector divides C, dy and dx are 16-byte aligned and idx is aligned to
    the vector's V bytes (misalign: dy, idx, dx bytes off), else one."""
    v = 16 // itemsize
    dy_off, idx_off, dx_off = misalign
    aligned = (dy_off | dx_off) % 16 == 0 and idx_off % v == 0
    return v if c % v == 0 and aligned else 1


def strip_rows(lanes, ho):
    """Output rows a lane walks: about FILL lanes in the grid."""
    s = min(max(lanes * ho // FILL, MIN_STRIP), MAX_STRIP)
    return max(min(s, ho), -(-ho // 65535))


def routed(code, at, g):
    """dy where the window's winner is at `at`, else +0 (dy not read)."""
    return np.where(code == at, g, ZERO)


def sum_bits(s, itemsize):
    """fp32 sums as stored: as they are, or rounded once to bf16 (to
    nearest even; a NaN keeps its high half, made quiet)."""
    u = s.astype(np.float32).view(np.uint32).astype(np.uint64)
    if itemsize == 4:
        return u.astype(np.uint32)
    rounded = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)
    return np.where(np.isnan(s), (u >> 16).astype(np.uint32) | 0x40, rounded)


def copy_bits(s, itemsize):
    """dy copied as it is: a bf16 value's bits are its float's high half."""
    u = s.astype(np.float32).view(np.uint32)
    return u >> 16 if itemsize == 2 else u


def render_k2_bwd(dy, idx, h, w, itemsize, misalign=(0, 0, 0), strip=None,
                  oj_first=False):
    """dy [B, ho, wo, C] float32 (bf16-exact for itemsize 2) and idx (the
    in-window codes) -> dx's bits as the kernel stores them.

    ``oj_first`` is a mutation: input row 2k's sum taken over window
    columns first (oj-1 at rows k-1 and k, then oj), not rows first."""
    bsz, ho, wo, c = dy.shape
    v = vector_width(c, itemsize, misalign)
    nv = c // v
    lanes = bsz * (wo + 1) * nv  # lane oj = wo: the tail column(s)
    strip = strip or strip_rows(lanes, ho)
    dx = np.zeros((bsz, h, w, c), np.uint32)
    writes = np.zeros((bsz, h, w, c), np.int64)
    lane = np.arange(lanes)  # blockIdx.x * THREADS + threadIdx.x
    t, vec = lane // nv, lane % nv
    b, oj = (t // (wo + 1))[:, None], (t % (wo + 1))[:, None]
    ch = vec[:, None] * v + np.arange(v)[None, :]
    left, right = oj >= 1, oj < wo  # windows oj-1 and oj
    both = left & right  # column 2oj in two windows
    odd = 2 * oj + 1 < w  # column 2oj+1 exists

    def load(row):
        """dy and codes of windows oj-1 and oj at output row `row` (0 and
        255 outside the image, where nothing is read)."""
        out = []
        for has, col in ((left, oj - 1), (right, oj)):
            col = np.clip(col, 0, wo - 1)
            out += [np.where(has, dy[b, row, col, ch], ZERO),
                    np.where(has, idx[b, row, col, ch], 255)]
        return out

    def store(row, col, bits, sel):
        sel = np.broadcast_to(sel, bits.shape)
        at = (np.broadcast_to(b, bits.shape)[sel], row,
              np.broadcast_to(2 * oj + col, bits.shape)[sel], ch[sel])
        dx[at] = bits[sel]
        writes[at] += 1

    def shares(win, base):
        """An input row one window row covers: column 2oj sums where both
        windows exist, else copies one; column 2oj+1 copies."""
        gl, al, gr, ar = win
        lv, rv = routed(al, base + 2, gl), routed(ar, base, gr)
        return (np.where(both, (ZERO + lv) + rv, np.where(left, lv, rv)),
                routed(ar, base + 1, gr))

    def store_shares(row, e, d):
        store(row, 0, np.where(both, sum_bits(e, itemsize),
                               copy_bits(e, itemsize)), True)
        store(row, 1, copy_bits(d, itemsize), odd)

    with np.errstate(invalid="ignore"):  # inf - inf: NaN, as on the card
        for oi0 in range(0, ho, strip):  # blockIdx.y
            rows = min(strip, ho - oi0)
            if oi0 > 0:  # seed the carry from the row above the strip
                prev = load(oi0 - 1)
                ce, co = shares(prev, 6)
            for k in range(oi0, oi0 + rows):
                win = load(k)
                gl, al, gr, ar = win
                if k == 0:  # input row 0 lies in window row 0 alone
                    store_shares(0, *shares(win, 0))
                else:  # the carry, then row k's position-0 shares
                    if oj_first:  # window column oj-1 at rows k-1 and k first
                        top = (((ZERO + routed(prev[1], 8, prev[0]))
                                + routed(al, 2, gl))
                               + routed(prev[3], 6, prev[2]))
                    else:
                        top = (ZERO + ce) + routed(al, 2, gl)
                    top = top + routed(ar, 0, gr)
                    store(2 * k, 0, sum_bits(top, itemsize), True)
                    store(2 * k, 1, sum_bits((ZERO + co) + routed(ar, 1, gr),
                                             itemsize), odd)
                store_shares(2 * k + 1, *shares(win, 3))
                prev = win
                ce, co = shares(win, 6)
            if oi0 + rows == ho:  # row 2ho in window row ho-1 alone, then none
                store_shares(2 * ho, ce, co)
                if 2 * ho + 1 < h:
                    store(2 * ho + 1, 0, np.zeros_like(dx[0, 0, 0, ch]), True)
                    store(2 * ho + 1, 1, np.zeros_like(dx[0, 0, 0, ch]), odd)
    assert (writes == 1).all(), "an input element written not exactly once"
    return dx


def one_window(h, w):
    """[h, w] mask of the input elements that one window alone covers: row
    (and column) 0, the odd ones above 2ho, and 2ho."""
    ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
    line = lambda n, no: np.array([i == 0 or i == 2 * no or (i % 2 and i < 2 * no)
                                   for i in range(n)])
    return line(h, ho)[:, None] & line(w, wo)[None, :]


def card_rule(dy, idx, h, w):
    """dx's bits by the card's autograd rule: the plain version's sums, and
    at each element one window alone covers, that window's dy bits where
    the element won it, else +0."""
    ho, wo = dy.shape[1:3]
    ref = bits_of(max_pool_3x3s2_backward_from_index(dy, idx, h, w).contiguous())
    dyb, codes = bits_of(dy.contiguous()), idx.numpy()
    for i, j in zip(*np.nonzero(one_window(h, w))):
        oi, oj = min(i // 2, ho - 1), min(j // 2, wo - 1)
        won = codes[:, oi, oj] == 3 * (i - 2 * oi) + (j - 2 * oj)
        ref[:, i, j] = np.where(won, dyb[:, oi, oj], 0)
    return ref


def exact(a, dtype):
    """float32 numpy -> tensor of dtype (bf16-exact inputs stay exact)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def as_float(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def bits_of(t):
    """A tensor's stored bits as uint32 (bf16: the 16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    return t.view(torch.int32).numpy().view(np.uint32)


def autograd_dx(x, dy):
    """Autograd of F.max_pool2d in fp32 on the (bf16-exact) inputs, rounded
    once to their dtype: the card's bf16 autograd, which sums in fp32 (the
    CPU's bf16 max_pool2d backward sums in bf16)."""
    xg = x.float().permute(0, 3, 1, 2).requires_grad_(True)
    y = F.max_pool2d(xg, 3, 2)
    (dx,) = torch.autograd.grad(y, xg, dy.float().permute(0, 3, 1, 2))
    return dx.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def assert_bitwise(got, ref, itemsize, exact_nan, where):
    """Bits equal; a NaN compared as NaN, except where exact_nan."""
    shift = 16 if itemsize == 2 else 0
    nan = lambda u: np.isnan((u.astype(np.uint32) << shift).view(np.float32))
    np.testing.assert_array_equal(nan(got), nan(ref), err_msg=f"NaN {where}")
    loose = nan(got) & np.logical_not(exact_nan)
    np.testing.assert_array_equal(np.where(loose, 0, got),
                                  np.where(loose, 0, ref),
                                  err_msg=f"dx {where}")


def make_x(kind, shape, rng):
    x = rng.randn(*shape).astype(np.float32)
    if kind == "ints":  # ties in nearly every window
        return rng.randint(0, 3, shape).astype(np.float32)
    return np.maximum(x, 0)


def make_dy(kind, shape, rng):
    dy = rng.randn(*shape).astype(np.float32)
    if kind == "special":  # NaN, +-inf and -0 at winners and misses alike
        pick = rng.rand(*shape)
        dy[pick < 0.05] = np.nan
        dy[(pick >= 0.05) & (pick < 0.12)] = np.inf
        dy[(pick >= 0.12) & (pick < 0.19)] = -np.inf
        dy[(pick >= 0.19) & (pick < 0.4)] = -0.0
    return dy


def check_case(x, dy, dtype, misalign=(0, 0, 0), strip=None, where=""):
    """The render bitwise the card's rule, whose sums are the plain
    version's, which is bitwise autograd. Returns the render's bits and
    the mask of elements one window alone covers."""
    xt, dyt = exact(x, dtype), exact(dy, dtype)
    h, w = x.shape[1:3]
    itemsize = ITEMSIZE[dtype]
    _, idx = max_pool_3x3s2_with_index(xt)
    got = render_k2_bwd(as_float(dyt), idx.numpy().astype(np.int64), h, w,
                        itemsize, misalign, strip)
    copied = np.broadcast_to(one_window(h, w)[None, :, :, None], got.shape)
    assert_bitwise(got, card_rule(dyt, idx, h, w), itemsize, copied,
                   f"vs the card's rule {where}")
    plain = max_pool_3x3s2_backward_from_index(dyt, idx, h, w).contiguous()
    assert_bitwise(bits_of(plain), bits_of(autograd_dx(xt, dyt)), itemsize,
                   False, f"plain vs autograd {where}")
    return got, copied


@pytest.mark.parametrize("c", [1, 3, 4, 8, 12, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_kind,dy_kind", [("relu", "normal"),
                                            ("ints", "normal"),
                                            ("ints", "special")])
def test_schedule_matches_the_card_rule(x_kind, dy_kind, dtype, c):
    copied_minus_zero = 0
    for h, w in SHAPES:
        rng = np.random.RandomState(h * w + c)
        ho, wo = (h - 3) // 2 + 1, (w - 3) // 2 + 1
        x = make_x(x_kind, (2, h, w, c), rng)
        dy = make_dy(dy_kind, (2, ho, wo, c), rng)
        got, copied = check_case(x, dy, dtype, where=f"at {h}x{w}")
        sign = 0x8000 if dtype == torch.bfloat16 else 0x80000000
        copied_minus_zero += ((got == sign) & copied).sum()
    if dy_kind == "special":  # the copy, not a sum from +0, was tested
        assert copied_minus_zero > 0


@pytest.mark.parametrize("strip", [1, 5, 16])
@pytest.mark.parametrize("x_kind,dy_kind", [("relu", "normal"),
                                            ("ints", "normal"),
                                            ("ints", "special")])
def test_strips_seed_their_carry(x_kind, dy_kind, strip):
    """The strip lengths of the full-size launches (16 at pool1, 5 at
    pool2) and one row a strip: strips end inside the image, at its last
    row and one row past a whole strip; each but the first seeds its carry
    from the row above it."""
    for h in (2 * strip * 2 + 1, 2 * strip * 2 + 3, 12):
        rng = np.random.RandomState(h + strip)
        x = make_x(x_kind, (2, h, 14, 8), rng)
        dy = make_dy(dy_kind, (2, (h - 3) // 2 + 1, 6, 8), rng)
        check_case(x, dy, torch.bfloat16, strip=strip, where=f"h {h}")


@pytest.mark.parametrize("dtype,c,misalign", [
    (torch.bfloat16, 12, (0, 0, 0)),  # 24 bytes a pixel
    (torch.bfloat16, 8, (2, 0, 0)),   # dy 2 bytes off
    (torch.bfloat16, 8, (0, 4, 0)),   # idx 4 bytes off its 8
    (torch.bfloat16, 8, (0, 0, 8)),   # dx 8 bytes off
    (torch.float32, 4, (0, 1, 0)),    # idx 1 byte off its 4
    (torch.float32, 6, (0, 0, 0))])   # 24 bytes a pixel
def test_narrow_paths_match_plain(dtype, c, misalign):
    """One element a lane."""
    assert vector_width(c, ITEMSIZE[dtype], misalign) == 1
    rng = np.random.RandomState(c + sum(misalign))
    x = make_x("ints", (3, 10, 11, c), rng)
    dy = make_dy("special", (3, 4, 5, c), rng)
    check_case(x, dy, dtype, misalign)


def test_sum_over_columns_first_is_caught():
    """The trap: one input element that wins all four windows over it,
    with dy 1e8, 1, -1e8 and 3 there. Rows first (oi, then oj) gives
    ((1e8 + 1) - 1e8) + 3 = 3 in fp32; columns first gives (1e8 - 1e8) +
    1 + 3 = 4. The plain version and autograd sum rows first; a schedule
    in the other order fails here."""
    x = np.zeros((1, 5, 5, 1), np.float32)
    x[0, 2, 2, 0] = 5  # (2, 2) wins windows (0,0), (0,1), (1,0), (1,1)
    dy = np.array([1e8, 1, -1e8, 3], np.float32).reshape(1, 2, 2, 1)
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    _, idx = max_pool_3x3s2_with_index(xt)
    codes = idx.numpy().astype(np.int64)
    assert codes.ravel().tolist() == [8, 6, 2, 0]
    ref = bits_of(autograd_dx(xt, dyt))
    good = render_k2_bwd(dy, codes, 5, 5, 4)
    bad = render_k2_bwd(dy, codes, 5, 5, 4, oj_first=True)
    assert good[0, 2, 2, 0].view(np.float32) == 3.0
    assert bad[0, 2, 2, 0].view(np.float32) == 4.0
    np.testing.assert_array_equal(good, ref)
    assert not np.array_equal(bad, ref)
    rng = np.random.RandomState(0)  # winners that two to four windows share
    x = make_x("ints", (2, 17, 18, 8), rng)
    corners = x[:, ::2, ::2]
    corners[rng.rand(*corners.shape) < 0.5] += 3
    dy = rng.choice(np.float32([1e8, 1, -1e8]), (2, 8, 8, 8))
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    _, idx = max_pool_3x3s2_with_index(xt)
    codes = idx.numpy().astype(np.int64)
    ref = bits_of(autograd_dx(xt, dyt))
    np.testing.assert_array_equal(render_k2_bwd(dy, codes, 17, 18, 4), ref)
    assert not np.array_equal(
        render_k2_bwd(dy, codes, 17, 18, 4, oj_first=True), ref)
