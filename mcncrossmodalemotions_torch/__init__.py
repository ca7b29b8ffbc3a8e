"""PyTorch/CUDA port of the cross-modal emotion framework for NVIDIA Hopper.

A second package beside ``mcncrossmodalemotions_tpu`` (the JAX reference,
kept unchanged). It imports ``torch`` and numpy and never ``jax`` or
``flax``: from the JAX package it uses only the numpy/ctypes host modules
(``data.audio``, ``data.native``, ``data.imdb``, ``data.external``,
``utils.logging``), whose imports reach no jax.

Layer map of the ported slice (student audio-feature extraction):

- ``ops``     spectrogram frontend (plain PyTorch) and the two kernels
              written by hand for Hopper in ``csrc/``: the fused
              spectrogram (``ops/spectrogram_kernel.py``) and the 3x3/2
              max pool (``ops/pool.py``), built at first use by
              ``ops/_build.py``.
- ``models``  eval-mode VGG-M student and the waveform->logits pipeline.
- ``zoo``     ``build_student`` and the Flax-variables -> ``state_dict``
              weight bridge.
- ``exp``     bucketed whole-clip feature extraction.
"""

__version__ = "0.1.0"

EMOTIONS = (
    "neutral",
    "happiness",
    "surprise",
    "sadness",
    "anger",
    "disgust",
    "fear",
    "contempt",
)
"""The 8 FERPlus emotion classes, in the reference's canonical order."""

NUM_EMOTIONS = len(EMOTIONS)
