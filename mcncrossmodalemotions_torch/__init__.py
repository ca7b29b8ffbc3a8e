"""PyTorch/CUDA port of the cross-modal emotion framework for NVIDIA Hopper.

A second package beside ``mcncrossmodalemotions_tpu`` (the JAX reference,
kept unchanged). It imports ``torch``, numpy and scipy, never ``jax`` or
``flax``, and nothing of the JAX package: what it needs from that
package's host modules it keeps as its own copies (``data.audio``,
``data.native``, ``data.imdb``, ``data.external``, ``utils.config``,
``utils.logging``), held equal to the originals by CPU tests.

Layer map of the ported slices (student audio-feature extraction; the
student's offline distillation training; the Mosaic lowering probes):

- ``ops``     spectrogram frontend (plain PyTorch) and the kernels
              written by hand for Hopper in ``csrc/``: the fused
              spectrogram (``ops/spectrogram_kernel.py``), the 3x3/2
              max pool with its with-index forward and backward
              (``ops/pool.py``) and the probe kernels (``ops/probes.py``),
              built at first use by ``ops/_build.py``.
- ``models``  VGG-M student (eval and train mode) and the
              waveform->logits pipeline.
- ``losses``  distillation / classification losses and metrics.
- ``zoo``     ``build_student``, ``student_loss_fn`` and the
              Flax-variables -> ``state_dict`` weight bridge.
- ``train``   train state and MatConvNet SGD step, checkpoints, the
              epoch engine with its threaded host feed.
- ``data``    wav I/O, the native reader's bindings, imdb manifests,
              synthetic tracks and the EmoVoxCeleb batcher.
- ``utils``   config hashing, ETA and metrics logs.
- ``exp``     bucketed whole-clip feature extraction and offline
              ``run_distillation``.
- ``tools``   the Mosaic lowering probes as Hopper probes.
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
