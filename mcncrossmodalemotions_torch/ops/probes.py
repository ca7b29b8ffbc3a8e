"""The Hopper probe kernels (``csrc/probes.cu``) and their plain versions.

Replace the TPU kernels of the Mosaic lowering probes:
``tools/probe_mosaic.py`` (P1-P11, ``pcall`` :38-42) and
``tools/probe_mosaic2.py`` (P4r, P4s, P4b, P12 through ``pcall`` :31-35,
P1r through its inline ``pl.pallas_call`` :111-113). The source note in
``csrc/probes.cu`` says why three kernels cover all seventeen probes and
what bounds them. Each wrapper runs its plain version for a CPU tensor and
its kernel for a CUDA tensor (or raises); each launch adds one to the
wrapper's ``launches``:

- ``probe_gather(x, index, axis)``: ``x`` gathered along ``axis`` by an
  ``IndexMap`` (``index_map`` checks the indices on the host and puts them
  on the device once), f32 out; plain: ``torch.index_select``;
- ``probe_select_matmul(a, b)``: fp32 FFMA product (P9), never TF32, K
  split across a block's warps; plain: an fp32 einsum;
- ``probe_col_candidates(x, y, dy)``: the pool gradient's column-candidate
  expansion (P12); plain: the probe's masked sum.

The plain versions take the wrappers' arguments. The gather and the
expansion each pick a path from their arguments (16-byte vectors or one
element a thread, 32- or 64-bit offsets): ``gather_route`` and
``col_candidates_route`` compute it as the C launcher does, and each
wrapper keeps its last launch's in ``route`` (``library_route`` asks the
built library which path it took, for the tests on the card).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mcncrossmodalemotions_torch.ops import _ffi
from mcncrossmodalemotions_torch.ops._ffi import INT, LONGLONG, VOIDP

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
LIB = _ffi.Library("probes", {
    **dict.fromkeys(("probe_gather_f32", "probe_gather_bf16"), (
        INT, [VOIDP] * 3 + [LONGLONG, INT, INT, LONGLONG, VOIDP])),
    "probe_select_matmul_f32": (INT, [VOIDP, LONGLONG, VOIDP, VOIDP]
                                + [INT] * 3 + [VOIDP]),
    "probe_col_candidates_f32": (INT, [VOIDP] * 4 + [INT] * 4 + [VOIDP]),
    "probe_gather_route": (INT, [VOIDP, VOIDP, INT, LONGLONG, INT, INT,
                                 LONGLONG]),
    "probe_col_candidates_route": (INT, [VOIDP] * 4 + [INT] * 4)})
_NARROW = 2 ** 31  # 32-bit offsets below this many elements


class Route(NamedTuple):
    """The path a probe kernel's launcher takes."""

    vec: int    # elements a thread moves a load: 16 bytes' worth, or 1
    wide: bool  # 64-bit offsets (a tensor of 2^31 elements or more)


def gather_route(x_ptr: int, out_ptr: int, itemsize: int, outer: int,
                 n_in: int, n_out: int, inner: int) -> Route:
    """``probe_gather``'s path: 16-byte vectors along ``inner`` where it is
    a multiple of the vector width (4 f32, 8 bf16) and both base pointers
    are 16-byte aligned; 64-bit offsets where x or out holds 2^31 elements
    or more."""
    vec = 16 // itemsize
    vector = inner % vec == 0 and x_ptr % 16 == 0 and out_ptr % 16 == 0
    wide = outer * max(n_in, n_out) * inner >= _NARROW
    return Route(vec if vector else 1, wide)


def gather_dims(shape, axis: int) -> tuple:
    """(outer, inner): the element counts before and after ``axis``, the
    ``[outer, n_in, inner]`` view ``probe_gather``'s kernel reads."""
    axis = axis % len(shape)
    return (int(np.prod(shape[:axis], dtype=np.int64)),
            int(np.prod(shape[axis + 1:], dtype=np.int64)))


def col_candidates_route(x_ptr: int, y_ptr: int, dy_ptr: int, out_ptr: int,
                         t: int, w: int, wh: int, c: int) -> Route:
    """``probe_col_candidates``' path: float4 channels where ``c`` is a
    multiple of 4 and the four pointers are 16-byte aligned; 64-bit
    offsets where x, y or dy holds 2^31 elements or more."""
    ptrs = (x_ptr, y_ptr, dy_ptr, out_ptr)
    vector = c % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    return Route(4 if vector else 1, t * max(w, wh) * c >= _NARROW)


class IndexMap(NamedTuple):
    """Gather indices on a device, made by ``index_map``."""

    values: torch.Tensor  # int32 [n_out], each in [0, n_in)
    n_in: int             # the length of the gathered axis


def index_map(idx, n_in: int, device: torch.device | str) -> IndexMap:
    """Check 1-D integer ``idx`` against ``[0, n_in)`` on the host, then
    copy it to ``device`` as int32, once for every launch that uses it."""
    idx = np.asarray(idx)
    if idx.ndim != 1 or idx.size == 0 or not np.issubdtype(idx.dtype, np.integer):
        raise ValueError(f"index_map expects a non-empty 1-D integer array, "
                         f"got {idx.dtype} {idx.shape}")
    if idx.min() < 0 or idx.max() >= n_in:
        raise IndexError(f"index_map: indices [{idx.min()}, {idx.max()}] "
                         f"outside [0, {n_in})")
    return IndexMap(torch.from_numpy(idx.astype(np.int32)).to(device), n_in)


def library_route(wrapper) -> Route:
    """The path the built library's launcher took at ``wrapper``'s last
    launch on the card (asked again with the same arguments, no launch)."""
    code = LIB.fn(f"{wrapper.__name__}_route")(*wrapper.route_args)
    return Route(code // 2, bool(code % 2))


# -- P1-P8, P10, P11, P4r, P4s, P4b, P1r -----------------------------------
def gather(x: torch.Tensor, index: IndexMap, axis: int) -> torch.Tensor:
    """Plain version of ``probe_gather``."""
    return torch.index_select(x, axis, index.values).float()


@_ffi.counted("probe_gather")
def probe_gather(x: torch.Tensor, index: IndexMap, axis: int) -> torch.Tensor:
    """``x`` (f32 or bf16) gathered along ``axis`` by ``index``, as f32:
    ``out[..., j, ...] = x[..., index[j], ...]``.

    CPU: the plain version. CUDA: ``x`` contiguous, ``index`` on its
    device; the kernel reads ``x`` as ``[outer, n_in, inner]``.
    """
    axis = axis % x.dim()
    if x.shape[axis] != index.n_in:
        raise ValueError(f"probe_gather: axis {axis} of {tuple(x.shape)} is "
                         f"not the index map's {index.n_in}")
    _ffi.check_device("probe_gather", x, index.values)
    if _ffi.on_cpu("probe_gather", x):
        return gather(x, index, axis)
    _ffi.check_dtype("probe_gather", x, _SUFFIX)
    if not x.is_contiguous():
        raise ValueError("probe_gather expects a contiguous tensor")
    outer, inner = gather_dims(x.shape, axis)
    n_out = index.values.numel()
    out = torch.empty((*x.shape[:axis], n_out, *x.shape[axis + 1:]),
                      dtype=torch.float32, device=x.device)
    LIB.launch(f"probe_gather_{_SUFFIX[x.dtype]}", probe_gather, x,
               (x.data_ptr(), index.values.data_ptr(), out.data_ptr(), outer,
                index.n_in, n_out, inner))
    probe_gather.route_args = (x.data_ptr(), out.data_ptr(), x.element_size(),
                               outer, index.n_in, n_out, inner)
    probe_gather.route = gather_route(*probe_gather.route_args)
    return out


# -- P9 ----------------------------------------------------------------------
def select_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of ``probe_select_matmul``: an fp32 einsum (full fp32
    on the card while ``torch.backends.cuda.matmul.allow_tf32`` is False)."""
    return torch.einsum("mk,kn->mn", a.float(), b.float())


@_ffi.counted("probe_select_matmul")
def probe_select_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[m, k] @ [k, n] in fp32, by fp32 FFMA on the CUDA cores.

    CPU: the plain version. CUDA: both f32 on one device, ``a`` with unit
    column stride (a row-strided view such as ``x[:, :k]`` is taken as it
    is), ``b`` contiguous.
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"probe_select_matmul: cannot multiply "
                         f"{tuple(a.shape)} by {tuple(b.shape)}")
    _ffi.check_device("probe_select_matmul", a, b)
    if _ffi.on_cpu("probe_select_matmul", a):
        return select_matmul(a, b)
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"probe_select_matmul: f32 only, got {a.dtype}, "
                        f"{b.dtype}")
    if a.stride(1) != 1 or not b.is_contiguous():
        raise ValueError("probe_select_matmul expects a with unit column "
                         "stride and a contiguous b")
    (m, k), n = a.shape, b.shape[1]
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    LIB.launch("probe_select_matmul_f32", probe_select_matmul, a,
               (a.data_ptr(), a.stride(0), b.data_ptr(), c.data_ptr(), m, k, n))
    return c


# -- P12 ---------------------------------------------------------------------
def col_candidates(x: torch.Tensor, y: torch.Tensor,
                   dy: torch.Tensor) -> torch.Tensor:
    """Plain version of ``probe_col_candidates``: the probe's k12 body."""
    w = x.shape[1]
    col_even = (torch.arange(w, device=x.device) % 2 == 0).view(1, w, 1)
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    grad = torch.zeros_like(x)
    for k2 in (0, 1):
        yc = torch.repeat_interleave(y[:, 1 - k2:], 2, dim=1)[:, :w]
        dyc = torch.repeat_interleave(dy[:, 1 - k2:], 2, dim=1)[:, :w]
        m = x == yc
        if k2:
            m = m & col_even
        grad = grad + torch.where(m, dyc, zero)
    return grad


@_ffi.counted("probe_col_candidates")
def probe_col_candidates(x: torch.Tensor, y: torch.Tensor,
                         dy: torch.Tensor) -> torch.Tensor:
    """P12's expansion: ``x`` [T, W, C], ``y`` and ``dy`` [T, Wh, C] with
    ``2 * (Wh - 1) >= W`` -> [T, W, C]: for k2 in {0, 1}, ``dy`` at the
    candidate column ``w // 2 + 1 - k2`` where ``x`` equals ``y`` there
    (for k2 = 1 only at even ``w``), summed.

    CPU: the plain version. CUDA: all three contiguous f32 on one device.
    """
    if (x.dim() != 3 or y.shape != dy.shape or y.dim() != 3
            or y.shape[0] != x.shape[0] or y.shape[2] != x.shape[2]
            or 2 * (y.shape[1] - 1) < x.shape[1]):
        raise ValueError(f"probe_col_candidates: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, dy {tuple(dy.shape)} are not "
                         "[T, W, C] and [T, Wh, C] with 2 (Wh - 1) >= W")
    _ffi.check_device("probe_col_candidates", x, y, dy)
    if _ffi.on_cpu("probe_col_candidates", x):
        return col_candidates(x, y, dy)
    if {x.dtype, y.dtype, dy.dtype} != {torch.float32}:
        raise TypeError("probe_col_candidates: f32 only")
    if not (x.is_contiguous() and y.is_contiguous() and dy.is_contiguous()):
        raise ValueError("probe_col_candidates expects contiguous tensors")
    t, w, c = x.shape
    out = torch.empty_like(x)
    args = (x.data_ptr(), y.data_ptr(), dy.data_ptr(), out.data_ptr(), t, w,
            y.shape[1], c)
    LIB.launch("probe_col_candidates_f32", probe_col_candidates, x, args)
    probe_col_candidates.route_args = args
    probe_col_candidates.route = col_candidates_route(*args)
    return out


probe_gather.route = probe_gather.route_args = None  # set at each launch
probe_col_candidates.route = probe_col_candidates.route_args = None
