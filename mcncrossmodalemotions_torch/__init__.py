"""PyTorch/CUDA port of the cross-modal emotion framework for NVIDIA Hopper.

A second package beside ``mcncrossmodalemotions_tpu`` (the JAX reference,
kept unchanged). It imports ``torch``, numpy and scipy, never ``jax`` or
``flax``, and nothing of the JAX package: what it needs from that
package's host modules it keeps as its own copies (``data.audio``,
``data.native``, ``data.imdb``, ``data.external``, ``utils.config``,
``utils.logging``), held equal to the originals by CPU tests.

Layer map of the ported slices (student audio-feature extraction; the
student's offline distillation training; the Mosaic lowering probes; the
student's evaluation; the teacher's serving path; the teacher's FER+
training and evaluation; the whole distillation driver; the release
surface; data parallelism across ranks):

- ``ops``     spectrogram frontend (plain PyTorch) and the kernels
              written by hand for Hopper in ``csrc/``: the fused
              spectrogram (``ops/spectrogram_kernel.py``), the 3x3/2
              max pool with its with-index forward and backward
              (``ops/pool.py``) and the probe kernels (``ops/probes.py``),
              built at first use by ``ops/_build.py``; the affine warp and
              resizes of the face pipeline (``ops/warp.py``: the host's
              numpy augmentation, the device's sampling).
- ``models``  VGG-M student (eval and train mode) and the
              waveform->logits pipeline; the face teachers
              (ResNet50/SENet50, the classic VGG-VD-16 and VGG-M, eval
              and train mode), their face pipeline with the train-mode
              fliplr, and surgery on their weights.
- ``losses``  distillation / classification losses and metrics.
- ``zoo``     ``build_student``, ``student_loss_fn``, ``build_teacher``,
              ``teacher_loss_fn``, the released-weight loaders, the
              fine-tuning entry points from base releases, the
              Flax-variables -> ``state_dict`` weight bridge and the
              released-artifact registry (``zoo/artifacts.py``).
- ``train``   train state and MatConvNet SGD step, checkpoints, the
              epoch engine with its threaded host feed.
- ``parallel`` synchronous data parallelism over ``torch.distributed``
              (one process a card): the process group, the rank's mesh
              and shard of each batch, the all-reduces of the gradients
              and of the global masked BatchNorm's sums.
- ``data``    wav I/O, the native reader's bindings, imdb manifests,
              synthetic tracks and the EmoVoxCeleb batcher; the FER2013+
              imdb and its host-augmented batches; face frames
              through the port's own JPEG decoder (``data/images.py``,
              ``data/native_faces.py``, ``csrc/dataservice_faces.cc``).
- ``utils``   dotted-path config overrides and hashing, ETA and
              metrics logs.
- ``exp``     bucketed whole-clip feature extraction and offline
              ``run_distillation``; teacher features over face frames and
              the dense EmoVoxCeleb imdb build; FER+ teacher training,
              evaluation and the benchmark table (``ferplus_baselines``,
              ``reproduce_ferplus``); the release gate
              (``verify_release``).
- ``tools``   the Mosaic lowering probes as Hopper probes.
- ``cli``     ``python -m mcncrossmodalemotions_torch.cli``: every
              driver as a command with dotted overrides.
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
