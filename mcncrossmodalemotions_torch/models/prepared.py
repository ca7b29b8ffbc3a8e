"""What a face teacher's fused eval forward reads instead of its module's
tensors, built once per weight version (``PreparedEval``), and the casts
its builds share.

``models/resnet.ResNet`` and ``models/vggface.VGGFace`` each hold one as
``model.prepared`` and say what goes into it (``model._prepare_eval()``:
conv weights in the compute dtype and ``channels_last`` memory, fully
connected weights as the GEMM reads them, each epilogue's fp32 ``(s, t)``);
this module decides when that is built again.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch
from torch import nn

from mcncrossmodalemotions_torch.utils import trace

# Submodules assigned anywhere in the process (``Module.__setattr__`` and
# ``add_module`` call the hook): ``PreparedEval`` walks a model's modules
# again only when this count has moved, not at every call (the walk costs
# the host about three times the rest of its check).
_module_registrations = [0]


def _count_module_registration(module, name, submodule) -> None:
    _module_registrations[0] += 1


torch.nn.modules.module.register_module_module_registration_hook(
    _count_module_registration)


def conv_weight(conv: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    """A conv's weight in ``dtype`` and ``channels_last`` memory: cuDNN's
    own layout for a ``channels_last`` input, so no call copies it."""
    return conv.weight.to(dtype).contiguous(memory_format=torch.channels_last)


class PreparedEval:
    """The model's ``_prepare_eval()``, built from the tensors in use
    (under ``functional_call``, the state's) and returned by ``get``.

    Kept until a tensor in use is another object (a replaced submodule
    brings its own: the modules are walked again after any submodule is
    assigned), or its ``_version`` (an in-place update,
    ``load_state_dict``) or its ``data_ptr()`` (a ``.data`` assignment,
    ``module.to``) changes, or the device or dtype does. ``builds`` counts
    the builds, each inside a ``teacher.prepare`` span. A model whose
    tensors are inference tensors (made under ``torch.inference_mode``,
    which tracks no versions) is rebuilt at every call."""

    def __init__(self):
        self.builds = 0
        self._walked: Optional[int] = None  # _module_registrations then
        self._slots: List[tuple] = []  # (dict, name) of each tensor in use
        self._stamp: Optional[tuple] = None
        self._tensors: List[torch.Tensor] = []
        self._parts: Any = None

    def __getstate__(self) -> dict:
        return {"builds": self.builds}  # a copy starts with no cache

    def __setstate__(self, state: dict) -> None:
        self.__init__()
        self.builds = state["builds"]

    def get(self, model: nn.Module, device: torch.device) -> Any:
        if self._walked != _module_registrations[0]:
            self._walked = _module_registrations[0]
            self._slots = [(d, n) for m in model.modules()
                           for d in (m._parameters, m._buffers)
                           for n, v in d.items()
                           if v is not None and n != "num_batches_tracked"]
        tensors = [d[n] for d, n in self._slots]
        try:
            stamp = (device, model.dtype,
                     tuple([(v._version, v.data_ptr()) for v in tensors]))
        except RuntimeError:  # inference tensors keep no version
            stamp = None
        if (stamp is None or stamp != self._stamp
                or any(a is not b for a, b in zip(tensors, self._tensors))):
            with trace.span("teacher.prepare"), \
                    torch.inference_mode(False), torch.no_grad():
                self._parts = model._prepare_eval()
            self.builds += 1
            self._tensors, self._stamp = tensors, stamp
        return self._parts
