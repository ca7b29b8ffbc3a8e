"""The port's one boundary with its compiled libraries.

Each library of ``csrc/`` is one ``Library``: its name and each symbol's
``(restype, argtypes)``, set once, when ``_build.load`` first loads it.
Every kernel wrapper launches through ``Library.launch`` and is entered
by ``counted`` in the record of launches, under the name its kernel line
prints. The ``check_*`` helpers test the input conditions that more than
one kernel has. Nothing here imports torch at import: the host readers
(``data/native_audio.py``, ``data/native_faces.py``) bind through it too.
"""

from __future__ import annotations

import ctypes
import importlib
from typing import Callable, Dict, Iterable, Optional, Tuple

from mcncrossmodalemotions_torch.ops import _build

VOIDP, INT, LONGLONG, FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_float)
KERNEL_MODULES = ("spectrogram_kernel", "pool", "probes", "epilogue",
                  "train_bn")  # the modules whose wrappers are counted
_record: Dict[str, Callable] = {}


class Library:
    """A library of ``csrc/``: ``name`` and ``{symbol: (restype, argtypes)}``."""

    def __init__(self, name: str, symbols: Dict[str, Tuple[type, list]]):
        self.name, self.symbols = name, symbols
        self.cdll: Optional[ctypes.CDLL] = None  # loaded at first use
        self.fns: Dict[str, Callable] = {}

    def load(self) -> ctypes.CDLL:
        """The library; built, loaded and typed at the first call."""
        if self.cdll is None:
            cdll = _build.load(self.name)
            for symbol, (restype, argtypes) in self.symbols.items():
                fn = getattr(cdll, symbol)
                fn.restype, fn.argtypes = restype, argtypes
                self.fns[symbol] = fn
            self.cdll = cdll
        return self.cdll

    def fn(self, symbol: str) -> Callable:
        """The library's function ``symbol``, its types set."""
        if self.cdll is None:
            self.load()
        return self.fns[symbol]

    def launch(self, symbol: str, wrapper: Callable, ref, args: tuple,
               stream: Optional[int] = None) -> None:
        """Launch ``symbol`` with ``args`` and then ``stream`` (without one:
        the current stream of ``ref``'s device, with that device current);
        raise on a nonzero return, else add one to ``wrapper.launches``."""
        fn = self.fn(symbol)
        if stream is None:
            import torch

            with torch.cuda.device(ref.device):
                err = fn(*args,
                         torch.cuda.current_stream(ref.device).cuda_stream)
        else:
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed: CUDA error {err} "
                               f"(shape {tuple(ref.shape)}, {ref.dtype})")
        wrapper.launches += 1


def counted(name: str) -> Callable:
    """Enter the decorated wrapper in the record of launches under
    ``name``, with ``launches`` at 0."""
    def enter(wrapper):
        wrapper.launches = 0
        _record[name] = wrapper
        return wrapper
    return enter


def record(names: Optional[Iterable[str]] = None) -> Dict[str, Callable]:
    """The record's wrappers by name: every one, or those ``names``."""
    for module in KERNEL_MODULES:
        importlib.import_module(f"{__package__}.{module}")
    return dict(_record) if names is None else {k: _record[k] for k in names}


def launches(names: Optional[Iterable[str]] = None) -> Dict[str, int]:
    """The launches of the record's wrappers (every one, or those
    ``names``) in this process since their last reset."""
    return {k: w.launches for k, w in record(names).items()}


def reset(names: Optional[Iterable[str]] = None) -> None:
    """Zero the launches of the record's wrappers (every one, or those
    ``names``)."""
    for w in record(names).values():
        w.launches = 0


def on_cpu(who: str, x) -> bool:
    """Whether ``x`` is on the CPU, not the card; raise for any other
    device: there is no silent path."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: unsupported device {x.device}")
    return x.device.type == "cpu"


def check_dtype(who: str, x, dtypes) -> None:
    """Raise unless ``x``'s dtype is one of ``dtypes``."""
    if x.dtype not in dtypes:
        raise TypeError(f"{who}: unsupported dtype {x.dtype}")


def check_nhwc(who: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous NHWC [B, H, W, C] one."""
    for t in tensors:
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{who} expects contiguous NHWC [B, H, W, C] "
                             f"tensors, got {tuple(t.shape)} with strides "
                             f"{t.stride()}")


def check_device(who: str, *tensors) -> None:
    """Raise unless the tensors are on one device."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{who}: operands on different devices "
                         f"{[str(t.device) for t in tensors]}")


def check_lanes(who: str, x, *others) -> None:
    """Raise on what kernels whose lanes move 16 bytes do not take: ``x``'s
    last dimension C not a whole number of 16-byte vectors, or the data of
    ``x`` or of one of ``others`` (None skipped) not 16-byte aligned."""
    c = x.shape[-1]
    if c * x.element_size() % 16:
        raise ValueError(f"{who}: C = {c} in {x.dtype} is not a whole number "
                         f"of 16-byte vectors")
    for t in (x, *others):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{who}: a tensor's data is not 16-byte aligned")
