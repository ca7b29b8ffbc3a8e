"""PyTorch/CUDA port of the cross-modal emotion framework for NVIDIA Hopper.

A second package beside ``mcncrossmodalemotions_tpu`` (the JAX reference,
kept unchanged). It imports ``torch`` and numpy and never ``jax`` or
``flax``: from the JAX package it uses only the numpy/ctypes host modules
(``data.audio``, ``data.native``, ``data.imdb``, ``data.external``,
``utils.logging``, and ``config_hash``/``to_dict`` of ``utils.config``),
whose imports reach no jax.

Layer map of the ported slices (student audio-feature extraction; the
student's offline distillation training):

- ``ops``     spectrogram frontend (plain PyTorch) and the kernels
              written by hand for Hopper in ``csrc/``: the fused
              spectrogram (``ops/spectrogram_kernel.py``) and the 3x3/2
              max pool with its with-index forward and backward
              (``ops/pool.py``), built at first use by ``ops/_build.py``.
- ``models``  VGG-M student (eval and train mode) and the
              waveform->logits pipeline.
- ``losses``  distillation / classification losses and metrics.
- ``zoo``     ``build_student``, ``student_loss_fn`` and the
              Flax-variables -> ``state_dict`` weight bridge.
- ``train``   train state and MatConvNet SGD step, checkpoints, the
              epoch engine with its threaded host feed.
- ``data``    synthetic-track helper and the EmoVoxCeleb batcher.
- ``exp``     bucketed whole-clip feature extraction and offline
              ``run_distillation``.
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
