"""The port's native-call boundary (``ops/_ffi.py``) on the CPU, against a
fake library: no compiler and no card.

A library's symbols get their types once, whatever follows; a launch
passes a given stream on as it is, counts one on its wrapper, and raises
on a nonzero return naming the symbol, the shape and the dtype; the CPU
path of a wrapper launches nothing; the record of launches holds every
kernel wrapper under the name its kernel line prints. The kernels
themselves are held on the card (``tests/test_torch_kernels_gpu.py``).
"""

from types import SimpleNamespace

import pytest
import torch

from mcncrossmodalemotions_torch.ops import _ffi, epilogue, pool, train_bn
from mcncrossmodalemotions_torch.ops._ffi import INT, VOIDP
from mcncrossmodalemotions_torch.tools import K1_K2, kernel_launches

SYMBOLS = {"k_f32": (INT, [VOIDP, INT, VOIDP]), "k_route": (INT, [INT])}


class _FakeFn:
    """A library function: records its calls and each time its argument
    types are set, and returns ``result``."""

    restype = None

    def __init__(self, result: int):
        self.result, self.calls, self.typed, self._argtypes = result, [], 0, None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self._argtypes = value
        self.typed += 1

    def __call__(self, *args):
        self.calls.append(args)
        return self.result


@pytest.fixture
def loads(monkeypatch):
    """``_build.load`` replaced by fake libraries, every symbol returning
    ``loads.result``; ``loads.names`` lists the names loaded."""
    made = {}
    loads = SimpleNamespace(names=[], result=0, made=made)

    def load(name):
        loads.names.append(name)
        return made.setdefault(name, SimpleNamespace(
            **{s: _FakeFn(loads.result) for s in ("k_f32", "k_route",
                                                  *epilogue.LIB.symbols)}))

    monkeypatch.setattr(_ffi._build, "load", load)
    return loads


def test_a_symbols_types_are_set_once_however_many_launches_follow(loads):
    lib = _ffi.Library("fake", SYMBOLS)
    wrapper = SimpleNamespace(launches=0)
    x = torch.zeros(2, 3)
    for i in range(5):
        lib.launch("k_f32", wrapper, x, (x.data_ptr(), i), stream=1)
    assert lib.fn("k_route")(4) == 0
    fake = loads.made["fake"]
    assert loads.names == ["fake"]
    assert [f.typed for f in (fake.k_f32, fake.k_route)] == [1, 1]
    assert (fake.k_f32.restype, fake.k_f32.argtypes) == SYMBOLS["k_f32"]
    assert [c[1] for c in fake.k_f32.calls] == list(range(5))
    assert wrapper.launches == 5


def test_a_nonzero_return_raises_naming_the_symbol_shape_and_dtype(loads):
    loads.result = 700
    lib = _ffi.Library("fake", SYMBOLS)
    wrapper = SimpleNamespace(launches=0)
    x = torch.zeros(2, 3, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match=r"^k_f32 launch failed: CUDA error "
                       r"700 \(shape \(2, 3, 4, 16\), torch.bfloat16\)$"):
        lib.launch("k_f32", wrapper, x, (x.data_ptr(), 1), stream=1)
    assert wrapper.launches == 0


@pytest.mark.parametrize("stream", [0, 2 ** 40 + 3])
def test_a_given_stream_is_passed_through_unchanged(loads, stream):
    lib = _ffi.Library("fake", SYMBOLS)
    x = torch.zeros(3)
    lib.launch("k_f32", SimpleNamespace(launches=0), x, (x.data_ptr(), 7),
               stream=stream)
    assert loads.made["fake"].k_f32.calls == [(x.data_ptr(), 7, stream)]


def test_a_launch_counts_one_on_its_wrapper_and_the_cpu_path_none(
        loads, monkeypatch):
    """``affine_relu`` through a fake of its library, a tensor on the meta
    device standing in for one on the card; then its plain version for a
    CPU tensor."""
    monkeypatch.setattr(epilogue, "LIB", _ffi.Library("teacher_epilogue",
                                                      epilogue.LIB.symbols))
    monkeypatch.setattr(epilogue.affine_relu, "launches", 0)
    y = torch.empty(2, 3, 4, 16, dtype=torch.bfloat16, device="meta")
    s = t = torch.empty(16, device="meta")
    epilogue.affine_relu(y, s, t, stream=9)
    assert epilogue.affine_relu.launches == 1
    (args,) = loads.made["teacher_epilogue"].affine_relu_bf16.calls
    assert args[-4:] == (2, 12, 16, 9)
    epilogue.affine_relu(torch.zeros(2, 3, 4, 16), torch.ones(16),
                         torch.zeros(16))
    assert epilogue.affine_relu.launches == 1
    assert loads.names == ["teacher_epilogue"]


def test_the_record_holds_every_wrapper_under_its_kernel_line_name(
        monkeypatch):
    from mcncrossmodalemotions_torch.ops import probes
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import (
        spectrogram_cuda,
    )

    wrappers = {
        "spectrogram": spectrogram_cuda,
        "max_pool_3x3s2": pool.max_pool_3x3s2_cuda,
        "max_pool_3x3s2_idx": pool.max_pool_3x3s2_idx_cuda,
        "max_pool_3x3s2_bwd": pool.max_pool_3x3s2_bwd_cuda,
        "probe_gather": probes.probe_gather,
        "probe_select_matmul": probes.probe_select_matmul,
        "probe_col_candidates": probes.probe_col_candidates,
        **{k: getattr(epilogue, k) for k in (
            "affine_relu", "affine_squeeze", "affine_gate_add_relu",
            "affine_relu_pool2x2")},
        **{k: getattr(train_bn, k) for k in (
            "stats", "finalize", "apply", "backward_reduce",
            "backward_finalize", "backward_apply")}}
    assert _ffi.record() == wrappers
    assert list(kernel_launches()) == list(K1_K2) == list(wrappers)[:4]
    monkeypatch.setattr(pool.max_pool_3x3s2_cuda, "launches", 5)
    assert _ffi.launches(["max_pool_3x3s2"]) == {"max_pool_3x3s2": 5}
    _ffi.reset(["max_pool_3x3s2"])
    assert pool.max_pool_3x3s2_cuda.launches == 0
