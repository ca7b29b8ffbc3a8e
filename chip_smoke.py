#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels, its wav reader and its JPEG face decoder
libraries from ``mcncrossmodalemotions_torch/csrc`` (one nvcc or g++ per
source, started together -> ``build/kernels/``), holds each kernel against
its plain PyTorch version on the card, then drives the port's main paths,
the student's with the full-width VGG-M: whole-clip feature extraction
(``compute_audio_feats``, seeded weights, synthetic tracks in three
duration buckets), the distillation train step at the headline shape,
offline ``run_distillation`` end to end, extraction through the port's
own wav reader, a released student loaded from a ``.mat`` file and
trained on from it, the student's statistics and external benchmarks;
the teacher's serving path with full-width SENet50 and ResNet50 (face
frames decoded by the port, dense EmoVoxCeleb inference); the teacher's
training path (FER+ fine-tuning and evaluation of SENet50, ResNet50 and
the classic VGG face teachers); the whole distillation driver (the online
step with the frozen teacher inside it, the feed options, the remat
policies); the release surface (the artifact registry's tree,
``verify_release`` and the command line); data parallelism through
``torch.distributed`` (two ranks of this script on the one card); the
dense build in bounded worker processes and the dense-genesis soak; the
throughput bench and the convergence demo; the step, pool and FER+
studies and the worked example of all five workloads; the driver's
integration entry (``graft_entry.py``: the flagship forward and the
multi-rank dry run); and the two Mosaic probe tools; each path with and
without the kernels where a comparison applies. Phases:

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: nvcc seconds per kernel library (spectrogram, max_pool_3x3s2,
   probes) and g++ seconds for the wav reader (dataservice_audio) and the
   face decoder (dataservice_faces).
3. data: 126 synthetic wavs (``data.synthetic_track_imdb``), grouped as
   the extractor groups them; each chunk's shapes are the shapes the
   main run launches the kernels at.
4. K1 spectrogram kernel (a real FFT a frame) vs the plain frontend, max
   rel error (max |diff| / max |plain|) <= 1e-4: at [64, 64384] (T=400,
   plus one row against a float64 numpy FFT within atol 5e-4), T=150,
   T=1000, T=1 and T=33 (one frame past two 16-frame tiles, int16), at each
   chunk's int16 feed and at the train step's int16 [128, 64384]; kernel
   and plain times (CUDA events) at the last two, beside ``torch.stft``
   (cuFFT) on the same pre-emphasised rows, whose magnitudes are held to
   the plain frontend's first nfft/2+1 bins within 1e-3 of the max.
5. K2 3x3/2 max-pool kernel vs F.max_pool2d at each chunk's pool1 and
   pool2 input, bf16 and fp32, post-ReLU: bitwise equal; bf16 times.
6. slice: ``compute_audio_feats`` given CPU weights runs on the card by
   default; per-track logits finite and [1, 8]; the main run launched K1
   once and K2 twice per chunk; kernel-on logits within 2e-2 *
   max|logit| of the plain run; tracks/s. Then the extractor's mu-law
   (``emit_mulaw``) and float32 (``emit_int16=False``) feeds over the same
   tracks, each with the same launches and gate against its plain run;
   their tracks/s and their logits' max |diff| from the int16 run's.
7. k2-backward at the train step's pool1 [128,253,197,96] and pool2
   [128,61,47,256] inputs, post-ReLU in bf16 and fp32 and tie-heavy
   (small integers) in bf16, then even H and W [16,254,198,96] post-ReLU
   in bf16 and fp32 and a narrow C=12 [16,61,47,12] tie-heavy bf16 input
   (one element a lane), random dy: the with-index forward's y bitwise
   equal to F.max_pool2d's and the index-free one's, its idx equal to the
   plain version's in-window code, and dx of the backward kernel bitwise
   equal to autograd of F.max_pool2d (same winners, fp32 sums in the same
   window order); bf16 post-ReLU times of both kernels at pool1 and pool2
   against the plain with-indices forward and backward.
8. train: the full-width pipeline at int16 [128, 64384], hot-cross-ent at
   T=2, weight decay 0 (``bench.py``'s train step), from one seeded init:
   3 steps with the kernels, then 3 plain. Losses finite and within 1e-2
   relative of each other (bf16 convs, cuDNN's non-deterministic weight
   gradients, K1's fp32 summation order), conv1's 3-step update within
   0.5 relative L2 of the plain one (a mis-routed pool gradient gave 1.10
   at tiny width on the CPU); per step K1 launched once, the
   with-index K2 forward twice, the K2 backward twice and the index-free
   K2 forward never; the train-mode BatchNorm kernels (``ops/train_bn``)
   six fused forwards and backwards a step with the kernels, each of its
   six wrappers launched once a call, and six eager calls and no launch a
   plain step; mean step ms and utts/s of each mode over 10 timed steps
   after 2 warm-up steps.
9. distill: ``run_distillation`` (full width, batch 64) on the port's
   ``build_synthetic_imdb`` with 8 speakers x 20 tracks (2 full train
   batches an epoch) for 2 epochs: checkpoints 1 and 2 and
   ``metrics.jsonl`` appear, losses finite, the exact kernel launch
   counts (the train-mode BatchNorm's six fused calls a train step); a
   second call with ``num_epochs=3`` resumes at epoch 3;
   ``feed_bound_frac`` per epoch.
10. reader: the port's wav reader library (``csrc/dataservice_audio.cc``),
    not Python, serves extraction; its ``ds_read_crops`` and
    ``ds_read_crops_packed`` crops are bitwise the Python reads (and their
    ``pack_pcm16``) over the smoke's tracks, from 0 and from random
    starts; extraction's tracks/s with library reads and with Python reads
    (``MCNCME_DISABLE_NATIVE``), in turns, over windows of the smoke's
    tracks read 16 times (the window's seconds printed beside each rate,
    and the rows ``ds_read_crops_packed`` copied and decoded: a decoded
    row of the smoke's 16-bit PCM tracks fails the phase),
    each run launching K1 once and K2 twice per chunk, their logits within
    the slice gate.
11. release: a classic (v5) MatConvNet ``.mat`` written from seeded
    full-width weights with nonzero conv biases (BN means moved by them),
    loaded on the card by ``load_pretrained_student``: extraction logits
    within 2e-2 x max|logit| of the seeded weights through the bridge;
    one ``run_distillation`` epoch with ``from_scratch=False`` from the
    file (exact launch counts), and ``load_student_from_exp(..., 'best')``
    bitwise equal to the checkpoint's state.
12. analysis: ``student_stats`` over the distill phase's imdb with the
    released student, extraction with the kernels and plain, in fp32
    (per-emotion AUCs within 0.02) and in bf16, the default (bf16 rounding
    swaps near-tied tracks, and a few swaps in a partition of 7 or 20
    tracks move an AUC by more than 0.02, so per partition the kernels may
    reorder at most 2n + 1 (positive, negative) track pairs, n the pairs
    that bf16 itself reorders on the plain path against fp32); each
    partition's largest AUC gap, ``meanAuc`` of each run and the first
    reordered pairs printed; ``emo_benchmarks`` over a synthetic external
    set (60 tracks, 6 classes, 5 folds): mean and std accuracy.
13. teacher: the port's JPEG decoder on this host gives the committed
    libjpeg library's frames of every fixture (``tests/fixtures/
    torch_faces``) at crops 1/1.6 and 1.0 and PIL's RGB, bit for bit (the
    golden, ``tests/fixtures/torch_teacher_golden.npz``); full-width
    SENet50 and ResNet50 classic ``.mat`` releases written from
    ``random_teacher_variables(seed=0)`` with conv biases, loaded on the
    card by ``load_pretrained_teacher(with_pipeline=True)``: logits on the
    golden's four frames within 2e-3 x max|golden| of the JAX package's
    in fp32 (TF32 off), and in bf16 within max(2 x JAX's own bf16 error,
    1e-2 x max|golden|); full-width VGG-VD-16 as ``vgg-vd-face-fer``
    (``vgg16_golden``: ``random_vggface_variables``' seeded weights, conv
    biases, no BatchNorm) on the same frames, its fused eval forward in
    fp32 within 2e-3 x max|logit| and in bf16 within max(2 x the unfused
    bf16 forward's own error, 1e-2 x max|logit|) of its unfused fp32
    forward (TF32 off), and both within the SENet50 gates of the JAX
    package's fp32 logits (``tests/fixtures/torch_vgg16_golden.npz``); the
    dense build (``build_imdb``, SENet50 bf16,
    batch 128) over the smoke's 126 tracks with 16 fixture frames each
    (2,016 frames, the last batch padded): a 1,024-frame bounded call and
    its resume bitwise equal to one pass, which launches none of the
    kernel line's kernels; 64 of the built logits (the padded batch's
    among them) within max(2 x bf16's own error, 1e-2 x max|logit|) of the
    same teacher's fp32 forward (TF32 off) on those frames, decoded apart;
    decode-only frames/s at 8 threads and at ``os.cpu_count()`` in turns
    (a call decodes on at most its threads), teacher-only frames/s (batch
    128, bf16, CUDA events around each forward queued whole behind a
    device sleep, so the card and not the host sets the pace), dense
    frames/s end to end, the dense run's device busy share, device time
    by op (torch.profiler) and peak memory; one ``run_distillation`` epoch
    (full width, batch 64) on the built imdb, with its exact launches.
14. teacher-train: the full-width SENet50 train golden
    (``tests/fixtures/torch_teacher_train_golden.npz``: two MatConvNet SGD
    steps, lr 0.01, momentum 0.9, wd 5e-4, backbone lr x 0.1, on 4 synthetic
    FER+ images warped on the host at 48x48 and resized to 224 in the
    pipeline, 'distributions' loss, fliplr and dropout off) in float64, fp32
    with TF32 off and bf16, each against JAX's float64 run: the first loss,
    the head after the steps, and each parameter's first update (its
    gradient, weight decay and lr scale; relative L2 over a sample of 256
    entries a parameter, median and largest), float64 (on the host's
    resize) and fp32 within 1e-4 relative and 2e-3 x the head's scale,
    the update within 1e-5 in float64 and 2 x JAX's own fp32 error in fp32,
    bf16 within max(2 x JAX's own bf16 error, 1e-2 x the scale) and 2 x
    JAX's own bf16 update error (``train_golden_errors``); the batch's
    resize on the card within 1e-6 x max of the host's;
    ``ferplus_baselines`` with the
    senet50-ferplus defaults (distributions, dropout 0.5, batch 128, host
    warp and device fliplr, bf16) on ``build_synthetic_ferplus(384)`` (2
    batches an epoch): 2 epochs, a resume to 3 that runs epoch 3 alone,
    eval-only val from the latest and the best checkpoint equal to those
    epochs' val accuracy, test from the best, ``benchmark_ferplus_models``
    and again from its cache; ``load_teacher_from_exp('best')`` into
    ``compute_visual_feats`` on the 13 fixture frames, bitwise the reloaded
    teacher's own forward; a full-width classic vgg-m-face-bn base ``.mat``
    (``classic_release``: conv biases, BN means moved by them, a 2622-way
    head) through ``prepare_classic_from_base``: fp32 logits within 1e-3 x
    max of the bridge's weights with the same head, then one fine-tuning
    epoch from it and its reload with the release's mean; one profiled
    epoch of SENet50 over 11 batches of 128 (wall, images/s,
    feed_bound_frac, device busy share, device time by op) and the train
    step of SENet50, ResNet50, VGG-VD-16 and VGG-M-bn at batch 128 in bf16,
    5 steps each timed one at a time behind a device sleep (``paced_ms``),
    the card-paced count, the host's issue time, peak memory and a step's
    FLOP (``torch.utils.flop_counter``) against the bf16 peak. The path
    launches no kernel of the kernel line.
15. online: the teacher phase's SENet50 release (``dense.mat``) loaded by
    ``load_pretrained_teacher(with_pipeline=True)`` in bf16, its built imdb
    (``wav_logits`` and ``dense_frames`` over the fixture frames), the
    full-width student from a seeded init, batch 64 of 4 s crops with 4 face
    frames of 224x224 each (256 frames), hot-cross-ent at T=2, weight decay
    5e-4. (a) 3 fused steps (``train.distill.make_online_distill_step``):
    each launches K1 once and K2's with-index forward and backward twice;
    the in-step targets within max(2 x bf16's own error, 1e-2 x max|target|)
    of the same teacher's fp32 forward (TF32 off) over the same frames,
    max-aggregated; with cuDNN deterministic, the whole state (weights,
    running statistics, velocity) after the 3 fused steps bitwise equal to
    the offline step's from the same init on the same crops with those
    targets given (both run ``make_train_step``'s body; the losses' and
    conv1 update's differences printed); the fused and the offline step's
    ms (back to back) and peak memory, and the teacher alone over the 256
    frames (CUDA events behind a device sleep); the host's online batch
    (one producer thread) in ms with and without frames, the mean of an
    epoch's batches after the first. (b)
    ``run_distillation(online_teacher=True)`` for 2 epochs on the built
    imdb with its train tracks repeated to 12 train batches an epoch:
    ``-online`` in the experiment's name, checkpoints 1 and 2, finite
    losses, train batches with frames and val batches without, the exact
    launches; samples/s and ``feed_bound_frac`` per epoch; a resumed,
    profiled epoch 3 with its exact launches and the device busy share
    over its train pass. (c) One epoch each on the distill phase's
    imdb of ``speed_aug`` with a corpus of 3 synthetic numbered noise wavs,
    ``mulaw_feed`` and ``time_offsets`` (fixedSegments): exact launches,
    finite losses, a directory each; the int16 and mu-law train batches
    read by the port's wav library, bitwise the Python reads. (d) Each of
    the five remat policies at int16 [128, 64384], 3 steps against no
    policy from one init with cuDNN deterministic: the state bitwise equal
    (else the largest difference per tensor printed and held within 0.5
    relative L2), K2's with-index forward launched 2 + the recomputed
    pools a step (drop_conv1 0, drop_through_pool1 1, the rest 2), step ms
    and peak memory per policy.
16. verify: a release tree in the artifact registry's layout, hard links
    to the release phase's full-width student and the teacher phase's
    SENet50 and ResNet50 ``.mat`` files, and the dense imdb's logits
    written as a released-logits ``.mat`` in the reference schema (read
    back bitwise by ``emovox_imdb_from_mat``); ``verify_release`` on the
    card at its defaults (probes at 224x224 and 4 s, ``download=False``)
    with a sha manifest of the tree and FER+ csvs of 96 rows in the
    reference's columns: against the README table (the accuracy gate
    fails, the teachers being random), then against the measured numbers:
    PASS, every stage executed but ``container_agreement`` (no ``-v73``
    sibling: the card's host has no h5py to write one), the released
    logits' tracks and magnitude those of the imdb; each run launches K1
    once and the index-free K2 twice (the student's probe); the student's
    probe logits within 2e-2 x max|logit| of the same probe on the CPU
    (the plain versions); each release's load time on the card; FAIL on a
    zeroed student (``import_forward``), one flipped byte in the pinned
    logits file (``artifacts``, corrupt) and a manifest pin that does not
    match; ``python -m mcncrossmodalemotions_torch.cli verify-release``
    exits 0 on the tree and 1 on the bad pin; ``cli.main(["audio-feats",
    "imdb=<the logits .mat>", "model=<the student .mat>", ...])`` over the
    126 tracks bitwise ``compute_audio_feats`` (K1 once and K2 twice a
    chunk).
17. ddp: two ranks on the one card over gloo (NCCL refuses two ranks on
    one device), each this script started with ``--ddp-worker`` (the
    parent holds a CUDA context, which a fork cannot carry), against the
    same work in this process: the full-width student through ``Trainer``
    at int16 [128, 64384], hot-cross-ent at T=2, bf16, kernels on, 3 steps
    at 64 rows a rank and a ragged batch of 127 rows padded to 128 (the
    ranks' weights, running statistics and velocity bitwise equal after
    every step, the global losses within 1e-2 relative of one process,
    each rank launching K1 once and K2's with-index forward and backward
    twice a step); the online step (SENet50 bf16 from the teacher phase's
    ``dense.mat``, batch 64 x 4 frames of 224x224, 32 rows a rank, 2
    steps, bitwise equal ranks, the same launches); the dense build over
    the teacher phase's frames (every rank's logits bitwise the other's,
    within 1e-2 x max|logit| of the one-process build, no kernel of the
    line launched); one student step in a 1-rank NCCL group (its loss
    within 1e-2 of one process's first); each rank's step ms and peak
    memory beside one process's.
18. dense-chunked: ``build_imdb`` over the teacher phase's tree and
    ``dense.mat`` with ``max_frames_per_process=512`` (SENet50 bf16, batch
    128): the teacher loaded on the host, 4 worker processes
    (``exp/dense_chunked.py``) on the card, ``wav_logits`` bitwise the
    teacher phase's one-process build, the partial and job directory gone;
    each worker's seconds, frames/s beside a one-process build timed here.
    The dense-genesis soak (``tools/soak_dense_genesis.py``) at 32,768
    unique 96x96 frames, batch 128: the clean build's frames/s and RSS
    (at warm, growth after it, per batch, peak, trace), a build SIGKILLed
    at its first partial flush (batch 200 of 256) and its resume, bitwise
    the clean build.
19. bench: ``python -m mcncrossmodalemotions_torch.bench --full`` (the
    JAX package's ``bench.py`` on the card) in a fresh process with the
    card free: exit 0, the ``distillation_train_throughput`` headline above
    0 last, and every key the JAX bench's ``--full`` run writes in its
    details file (the frontend's under ``frontend_plain_ms`` and
    ``frontend_kernel_ms``), ``numerics_ok`` true (the card against the
    CPU golden); each value printed. Its launches are its processes'.
20. demo: ``tools/run_demo.main`` (the full-width student, 8 x 25
    synthetic tracks, batch 16, lr 1e-2 -> 1e-3) for 3 of its 40 epochs:
    the epoch-3 train loss below epoch 1's, ``student_stats`` over the
    three partitions, the exact launches of its epochs (10 train and 2 val
    batches each) and its extraction.
21. studies: the step, pool and FER+ studies of ``mcncrossmodalemotions_
    torch/tools`` at their JAX sizes (``STUDY_ITERS`` calls a timed
    window): ``probe_masked_bn`` (baseline, masked), ``ab_step_conv1``
    (plain, s2d) and ``probe_remat`` (nothing; the online phase times the
    other policies) each in a process of its own, with the
    exact launches of its steps, their step ms printed beside the bench
    phase's headline; ``profile_train_step`` (every ablation),
    ``probe_conv1_s2d`` (conv1 in space-to-depth form within 1e-5 x max|y|
    of the plain conv in fp32 with TF32 off and 1e-2 x max|y| in bf16, at
    [128, 1, 512, 400]), ``probe_pool_compose`` (the composed pool's
    forward bitwise the direct one's), ``bench_pool_bwd`` (the student's
    pool's y and dx bitwise autograd of ``F.max_pool2d`` at the JAX tool's
    shapes) and ``ablate_ferplus_resample`` (one seed of its three, one
    timed augmentation a size; accuracies in [0, 1]) in this process;
    every process exits 0 and K1 and every K2 kernel launch.
22. workflow: the worked example (``examples/full_workflow.py``) at its
    own tiny sizes, without figures: each of its five stages' artifacts,
    stage 3's ``meanAuc`` finite in both partitions (its teacher is the
    JAX example's), its extraction chunks those the k1 and k2 phases
    checked, K1 and every K2 kernel launched.
23. graft: the integration entry (``mcncrossmodalemotions_torch/
    graft_entry.py``). ``entry()``'s full-width forward with zero weights
    on batch 8 of 4 s crops: [8, 8], finite, K1 launched once and the
    index-free K2 twice, its ms; ``dryrun_multichip`` over the card count
    (one NCCL rank a card) and over 2 gloo ranks on the one card: in every
    rank the sharded SGD step, the fused online step, ``Trainer.fit`` for
    2 epochs with a ragged tail and the resume to epoch 3 pass, the ranks'
    states bitwise equal after each, 11 steps' launches a rank (K1 once,
    K2's with-index forward and backward twice a step); each run's seconds.
    The k1, k2 and k2-backward phases hold the kernels at the entry's and
    the dry runs' launch shapes.
24. probes: both probe tools (``tools.probe_mosaic``, ``probe_mosaic2``)
    on the card: all 17 probes RUN with ``match=True``, launching
    ``probe_gather`` 15 times and the other two probe kernels once each;
    then every probe's kernel bitwise equal to its plain version (P9's
    also exactly numpy's ``expect``), the path each gather and P12 took
    (16-byte vectors or one element a thread, 32- or 64-bit offsets)
    printed and held to the built launcher's own answer, P9 again on
    random inputs with a row stride, at the probe's shape and a ragged
    one, within 1e-5 of |a| @ |b| of float64 (its split along K sums in
    another order), P12 again on small-integer inputs where both
    candidate branches fire (their nonzero shares printed, each above 0),
    and each probe's kernel, plain and library times, each beside its
    bound and the launch floor (a one-element ``probe_gather`` timed the
    same way: the least a launch takes on the card) with its share of
    max(bound, floor). Last, the paths the probes do not take
    (``probe_path_cases``), each bitwise equal to its plain version, one
    launch, on the path expected: the gather at P4r's tile one element
    into its buffer and with a ragged inner, f32 and bf16; P12 at C = 96
    with even W and with 2 (Wh - 1) == W, at C = 5 with odd and even W,
    and with a misaligned y.
25. teacher-epilogue: the face teachers' epilogue kernels
    (``csrc/teacher_epilogue.cu``, ``ops/epilogue.py``) at every shape the
    full-width teachers launch them at, batch 128 in bf16, each within one
    bf16 unit in the last place of its plain version: ``affine_relu`` at
    the stem's output and each stage's inner width, ``affine_squeeze`` and
    the four tails (gated or not, identity or projection residual) at each
    stage's output width. At stage 1 and stage 4, ``affine_relu``,
    ``affine_squeeze`` and the gated identity tail are timed: kernel, plain
    and library times in turns (the library: ``F.batch_norm`` and what
    follows it, eagerly), each call's inputs cold in the L2, beside the
    bound of its bytes. ``affine_relu_pool2x2`` is checked and timed the
    same way at VGG-VD-16's five block-end conv outputs (``VD16_POOL_SHAPES``,
    every other channel's scale negative; the library: ``F.batch_norm``,
    ``F.relu_`` and ``F.max_pool2d``). The teacher phase counts their
    launches: 33 / 16 / 16 / 0 a SENet50 forward, 33 / 0 / 16 / 0 a
    ResNet50 one, 10 / 0 / 0 / 5 a VGG-VD-16 one.
26. train-bn: the student's train-mode BatchNorm and ReLU kernels
    (``csrc/train_bn.cu``, ``ops/train_bn.py``) at the distillation
    cell's six BatchNorm inputs, batch 64 in bf16: each layer's forward
    and backward against the eager code (y and dx within one bf16 unit,
    the parameter gradients and running statistics within fp32 order
    noise); the forward (stats, finalize, apply) and the backward
    (reduction, finalize, dx) timed against the eager code and the
    library (``F.batch_norm(training=True)`` and ``F.relu``) in turns,
    inputs cold in the L2, beside the bound of the least bytes (x in, y
    out; dy and x in, dx out), summed over the six layers; at bn1 each
    pass alone beside its own bytes; then one full-width student train
    step at batch 64: six fused forwards, six fused backwards, no eager
    BatchNorm (``train_bn.calls``), each wrapper launched six times.
    Alone: ``python3 -c "import chip_smoke;
    print(chip_smoke.train_bn_phase('H100'))"``.

Prints one JSON line of kernel results (``launches``: the K1/K2 kernels'
counted over the main runs of the slice, train, distill, reader, release,
analysis, teacher, teacher-train, online, verify, ddp, dense-chunked,
demo, studies, workflow and graft phases (the ddp and graft phases' over
every rank, the dense-chunked phase's one-process build, the studies'
processes as each reports them; the bench's processes are not counted),
the probe kernels' over the probes run, the epilogue kernels' over the
teacher phase's golden forwards and its dense build, the train-mode
BatchNorm kernels' (forward: stats, finalize, apply; backward: the
other three) over the train phase's kernel steps, the distill phase's
first call, the teacher-train phase's bf16 golden steps and the train-bn
phase's student step, each read between a reset just before and just
after it;
``ms``/``plain_ms``/``library_ms``: summed over the main runs' launch
shapes, K1's at the int16 feed, which the kernel reads as it is and the
plain version decodes, the with-index forward and the backward at the
train step's, the probes' at the probes' own; ``bound_ms``: the least
time for the same work, from the bytes each input and output must move
and the operations the function needs (K1's: an FFT's), at H100 SXM
peaks; K2's library call is its plain version), then, last, the
device line ``{"ok": true, "device": {...}}``. Exits non-zero, without the
device line, when any phase fails or no CUDA device is present. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 64
K1_REL_TOL = 1e-4             # fp32 vs fp32, summation order only
K1_GOLDEN_ATOL = 5e-4         # as tests/test_spectrogram.py
SLICE_REL_TOL = 2e-2          # bf16 convs over an fp32 frontend
TRAIN_BATCH = 128             # bench.py's train step
TRAIN_LOSS_RTOL = 1e-2        # bf16 convs, cuDNN wgrad order, K1 sum order
TRAIN_UPDATE_RTOL = 0.5       # conv1's 3-step update, relative L2: a
                              # mis-routed pool gradient gave 1.10 at
                              # tiny width on the CPU (0.087 unmutated)
TRAIN_LR = 1e-4               # bench.py's lr
TIMED_STEPS, WARMUP_STEPS = 10, 2
STFT_REL_TOL = 1e-3           # cuFFT vs the fp32 DFT product: order only
P9_RTOL = 1e-5                # of |a| @ |b|: P9 sums K in 8 slices, then
                              # the slices, another order than one chain
PROBE_ITERS = 200             # probe kernels take microseconds
QUEUE_CYCLES = 100_000_000    # ~50 ms of device sleep ahead of timed calls
N_PROBES = 17                 # P1-P11, P5b; P4r, P4s, P4b, P12, P1r
EVEN_POOL = (16, 254, 198, 96)  # k2-backward: even H and W, 16-byte vectors
NARROW_POOL = (16, 61, 47, 12)  # k2-backward: 24 bytes a bf16 pixel, one
                                # element a lane
AUC_TOL = 0.02                # per-emotion AUC, extraction kernels vs plain
READER_REPEATS = 16           # the reader phase's windows: the track list
                              # 16 times, seconds long
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12       # H100 SXM bf16 dense, tensor cores
FIXTURES = ROOT / "tests" / "fixtures"
TEACHER_GOLDEN = FIXTURES / "torch_teacher_golden.npz"
VGG16_GOLDEN = FIXTURES / "torch_vgg16_golden.npz"  # the JAX VGG-VD-16's
FACES = FIXTURES / "torch_faces"
TEACHER_BATCH = 128           # compute_visual_feats.m:83-98
TEACHER_FP32_RTOL = 2e-3      # fp32 convs, TF32 off, against the JAX golden
TEACHER_BF16_RTOL = 1e-2      # the bf16 gate's floor; else 2 x JAX's own
DENSE_FRAMES = 16             # frames a track in the dense build: 2,016
DENSE_BOUNDED = 1024          # the bounded first call of the resume check
TEACHER_TIMED = 10            # teacher-only batches timed
TEACHER_SLEEP_CYCLES = 4 * QUEUE_CYCLES  # ~200 ms of device sleep ahead of
                              # each timed forward, which takes 9-21 ms of
                              # host time to enqueue
DENSE_SAMPLE = 64             # dense frames held against an fp32 forward
TRAIN_GOLDEN = FIXTURES / "torch_teacher_train_golden.npz"
GOLDEN_STEPS, GOLDEN_LR = 2, 0.01  # the golden train steps: MatConvNet SGD,
GOLDEN_FINETUNE = 0.1         # momentum 0.9, wd 5e-4, backbone lr x 0.1
GOLDEN_LOSS_RTOL = 1e-4       # the golden's first loss, fp32 and float64
GOLDEN_SAMPLE = 256           # entries of each parameter's first update held
F64_UPDATE_RTOL = 1e-5        # float64's first update, relative L2 per
                              # parameter: 5.6e-7 at most on an H100 and on
                              # a CPU; a planted fault moves it 0.13 or more
RESIZE_RTOL = 1e-6            # the pipeline's fp32 resize on the card vs the
                              # host's, of the largest value (one unit in the
                              # last place is 6e-8)
FERPLUS_CSV_ROWS = 96         # the verify phase's FER+ csvs: 32 train, val, test
FERPLUS_IMAGES = 384          # ferplus_baselines' synthetic FER+ set: 268 train
                              # images, 2 batches of 128 an epoch
PROFILED_IMAGES = 2048        # the profiled epoch's set: 11 batches of 128
TRAIN_TIMED = 5               # paced train steps timed per teacher
TRAIN_SLEEP_CYCLES = 8 * QUEUE_CYCLES  # ~400 ms of device sleep ahead of
                              # each timed train step: the host takes up to
                              # ~160 ms to issue a SENet50 step
CLASSIC_RTOL = 1e-3           # fp32 logits, imported classic vs the bridge
TIMED_TEACHERS = ("senet50-ferplus", "resnet50-ferplus", "vgg-vd-face",
                  "vgg-m-face-bn")
ONLINE_BATCH = 64             # the online step: run_distillation.m's batch,
ONLINE_FRAMES = 4             # 4 face frames a crop: 256 a batch, 224x224
ONLINE_STEPS = 3              # fused steps against the offline step
ONLINE_TIMED = 5              # fused and offline steps timed back to back
ONLINE_EPOCH_BATCHES = 12     # train batches an online epoch at least: the
                              # built imdb's train tracks repeated
ONLINE_TRAIN_SPAN = "online train pass"  # profiler span of run_epoch
NOISE_FILES = 3               # the speed/noise run's corpus of numbered wavs
REMAT_POLICIES = ("drop_conv1", "drop_through_pool1", "save_pools", "dots",
                  "nothing")
REMAT_POOLS = {"drop_conv1": 0, "drop_through_pool1": 1, "save_pools": 2,
               "dots": 2, "nothing": 2}  # pools recomputed a step
DDP_RANKS = 2                 # the ddp phase's ranks, both on the one card
DDP_STEPS = 3                 # full student steps (64 rows a rank), then one
DDP_RAGGED = TRAIN_BATCH - 1  # ragged batch, padded to a multiple of 2
DDP_ONLINE_STEPS = 2          # online steps at batch 64 (32 rows a rank)
DDP_TIMEOUT = 600             # seconds a ddp worker process may take
CHUNK_FRAMES = 512            # dense-chunked: 4 workers of 4 batches of 128
SOAK_FRAMES = 32768           # the soak: 256 batches of 128; the kill lands at
                              # the first partial flush, batch 200 (78%)
SOAK_CPU_FRAMES = 640         # the CPU rehearsal's soak: 640 batches of 1
BENCH_TIMEOUT = 900           # seconds the bench --full subprocess may take
# what the JAX package's `bench.py --full` measures into its details file,
# under the port's names (frontend_plain_ms/kernel_ms for jnp/pallas),
# but its host-link health and the fields derived from it
BENCH_KEYS = (
    "train_step_ms", "train_step_utts_per_sec", "train_step_flops",
    "achieved_tflops", "mfu_estimate", "device_kind", "backend",
    "end_to_end_epoch_utts_per_sec", "end_to_end_epoch_samples",
    "end_to_end_feed_bound_frac", "end_to_end_feed_bytes_per_utt",
    "end_to_end_epoch_utts_per_sec_mulaw8", "end_to_end_epoch_samples_mulaw8",
    "end_to_end_feed_bound_frac_mulaw8",
    "end_to_end_feed_bytes_per_utt_mulaw8",
    "online_epoch_utts_per_sec", "online_epoch_samples",
    "online_epoch_feed_bound_frac", "online_epoch_feed_bytes_per_utt",
    "online_epoch_frames_per_crop",
    "numerics_frontend_rel", "numerics_loss_rel", "numerics_ok",
    "frontend_plain_ms", "frontend_kernel_ms",
    "teacher_inference_imgs_per_sec", "teacher_train_imgs_per_sec",
    "fused_online_step_utts_per_sec", "fused_online_step_ms",
    "fused_online_step_bs",
    "dense_inference_e2e_imgs_per_sec", "dense_inference_bytes_per_img",
    "audio_feats_tracks_per_sec", "audio_feats_batch_size",
    "audio_feats_bytes_per_track",
)
DEMO_EPOCHS = 3               # of the demo's 40 (tools/run_demo.py)
STUDY_ITERS = 5               # calls a timed window in the studies phase
STUDY_TIMEOUT = 300           # seconds a study's process may take
S2D_FP32_RTOL = 1e-5          # conv1 s2d vs plain, fp32 (TF32 off), x max|y|
S2D_BF16_RTOL = 1e-2          # the same in bf16
STEP_STUDIES = (("probe_masked_bn", "baseline"), ("probe_masked_bn", "masked"),
                ("ab_step_conv1", "plain"), ("ab_step_conv1", "s2d"),
                ("probe_remat", "nothing"))
WORKFLOW_BATCH = 4            # the worked example's distillation batch
DEMO_BATCH = 16               # the demo's batch
EPILOGUE_BATCH = 128          # the dense pass's batch
EPILOGUE_SHAPES = {"stem": (112, 64, None),    # the teachers' h = w, inner
                   "stage 1": (56, 64, 256),   # and output widths at
                   "stage 2": (28, 128, 512),  # 224x224 (the stem: its
                   "stage 3": (14, 256, 1024),  # conv's output)
                   "stage 4": (7, 512, 2048)}
EPILOGUE_TIMED = ("stage 1", "stage 4")
EPILOGUE_TAILS = ((True, False), (True, True),  # (gate, projection): SENet50's
                  (False, False), (False, True))  # tails, then ResNet50's
VD16_POOL_SHAPES = {"block 1": (224, 64),   # VGG-VD-16's block-end conv
                    "block 2": (112, 128),  # outputs at 224x224 (h = w,
                    "block 3": (56, 256),   # c), which affine_relu_pool2x2
                    "block 4": (28, 512),   # reads
                    "block 5": (14, 512)}
VD16_GOLDEN_WIDTH = 1 / 16    # the CPU rehearsal's VGG-VD-16 (full width on
                              # the card)
EPILOGUE_COLD_BYTES = 100e6   # a timed call's inputs, rotated over copies,
                              # are at least this far apart: twice the L2
TRAIN_BN_BATCH = 64           # the distillation cell's batch
TRAIN_BN_SHAPES = {"bn1": (96, 253, 197),   # the student's BatchNorm inputs
                   "bn2": (256, 61, 47),    # at 4 s crops, (c, h, w): conv1
                   "bn3": (384, 30, 23),    # to conv5, then fc6
                   "bn4": (256, 30, 23),
                   "bn5": (256, 30, 23),
                   "bn6": (4096, 1, 11)}
TRAIN_BN_PASSES_AT = "bn1"    # the layer whose six passes are timed alone
TRAIN_BN_ATOL = {"y": 1e-5, "dx": 1e-4}  # of the largest magnitude, beside
                              # one bf16 unit (tests/test_torch_kernels_gpu.py)
TRAIN_BN_TARGET_MS = 3.0      # the six layers' forward and backward a step
KERNEL_NAMES = ("spectrogram", "max_pool_3x3s2", "max_pool_3x3s2_idx",
                "max_pool_3x3s2_bwd", "probe_gather", "probe_select_matmul",
                "probe_col_candidates")  # the kernel line's own wrappers
EPILOGUE_NAMES = ("affine_relu", "affine_squeeze", "affine_gate_add_relu",
                  "affine_relu_pool2x2")
TRAIN_BN_NAMES = ("stats", "finalize", "apply", "backward_reduce",
                  "backward_finalize", "backward_apply")
STUDENT_BNS, SENET50_BNS = 6, 53  # train-mode BatchNorms a forward
GRAFT_GLOO_RANKS = 2          # the graft phase's gloo dry run: both ranks on
                              # the one card
GRAFT_STEPS = 11              # train steps a dry-run rank takes: the SGD step,
                              # the fused step, 2 fit epochs and the resumed
                              # one of 3 batches each


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@contextlib.contextmanager
def phase(name: str, walls: dict):
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    walls[name] = time.perf_counter() - t0
    print(f"[{name}] ok in {walls[name]:.2f} s", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call (the bench's ``cuda_ms``: CUDA
    events around ``iters`` calls queued behind a device-side sleep of
    ``QUEUE_CYCLES``, so a call shorter than the host's cost of issuing it
    is timed on the device, not at the host's pace)."""
    from mcncrossmodalemotions_torch.bench import cuda_ms as timed

    return timed(fn, iters, warmup, QUEUE_CYCLES)


def paced_ms(fn, iters: int, cycles: int = TEACHER_SLEEP_CYCLES) -> tuple:
    """Device milliseconds of ``iters`` calls timed one at a time, CUDA
    events around each call queued whole behind a device-side sleep: a
    call that costs the host longer to issue than the card to run (an
    eager network's forward) is timed at the card's pace, not the host's.
    Returns (the times, the host's milliseconds to issue each call, how
    many calls were issued whole before the sleep ended, that is, timed at
    the card's pace)."""
    import torch

    for _ in range(2):
        fn()
    times, issue, paced = [], [], 0
    for _ in range(iters):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        fn()
        issue.append((time.perf_counter() - t0) * 1e3)
        end.record()
        paced += not start.query()  # the card still asleep
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, issue, paced


def turns_ms(*fns, iters: int = 20) -> list:
    """Mean device ms per call of each fn, timed in turns: in order, then
    in reverse (plain, kernel, kernel, plain for two)."""
    first = [cuda_ms(f, iters) for f in fns]
    second = [cuda_ms(f, iters) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def bound_ms(nbytes: float, ops: float) -> tuple:
    """(ms, "bytes" or "operations"): the least time an H100 could take to
    move ``nbytes`` through device memory and do ``ops`` fp32 operations,
    whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spectrogram_ops(frames: int, cfg) -> tuple:
    """(least, as a DFT product): K1's function's operations over
    ``frames`` frames. The least is an FFT's 5 N log2 N a frame (N =
    nfft), which K1 does; the DFT computed as a product, 2 x win x 2
    (nfft/2+1) a frame, is printed beside it for comparison."""
    fft = frames * 5 * cfg.nfft * math.log2(cfg.nfft)
    return fft, frames * 2 * cfg.win_length * 2 * cfg.num_rbins


def stft_call(xe, cfg):
    """The library call that computes K1's magnitudes: ``torch.stft``
    (cuFFT on the card) of the pre-emphasised [B, N] rows ``xe``, Hamming
    window, ``center=False``, ``.abs()`` -> [B, nfft/2+1, T], the plain
    frontend's first nfft/2+1 bins. torch.stft centres the window in each
    nfft-sample frame, so the rows get (nfft - win) / 2 zeros on each side
    to frame the samples K1 frames."""
    import torch
    import torch.nn.functional as F

    pad = (cfg.nfft - cfg.win_length) // 2
    xp = F.pad(xe, (pad, cfg.nfft - cfg.win_length - pad))
    window = torch.hamming_window(cfg.win_length, periodic=False,
                                  dtype=xe.dtype, device=xe.device)
    return lambda: torch.stft(xp, cfg.nfft, cfg.hop_length, cfg.win_length,
                              window, center=False,
                              return_complex=True).abs()


def golden_row(x, cfg):
    """float64 runSpec of one waveform row: [nfft, T]."""
    import numpy as np

    x = np.asarray(x, np.float64)
    xe = np.concatenate([x[:1], x[1:] - cfg.preemph * x[:-1]])
    t = cfg.num_frames(len(x))
    idx = np.arange(t)[:, None] * cfg.hop_length + np.arange(cfg.win_length)
    n = cfg.win_length
    w = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / (n - 1))
    return np.abs(np.fft.fft(xe[idx] * w, cfg.nfft, axis=-1)).T


def pool_inputs(rows: int, bucket: int, nfft: int) -> dict:
    """NHWC inputs of the student's pool1 and pool2 for a [rows, nfft,
    bucket, 1] spectrogram: conv1 7x7/2, pool1 3x3/2, conv2 5x5/2."""
    def out(n, k, s):
        return (n - k) // s + 1

    h1, w1 = out(nfft, 7, 2), out(bucket, 7, 2)
    h2, w2 = out(out(h1, 3, 2), 5, 2), out(out(w1, 3, 2), 5, 2)
    return {"pool1": (rows, h1, w1, 96), "pool2": (rows, h2, w2, 256)}


def bits(t):
    """An integer view of a float tensor, for bitwise comparison."""
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def reset_counts(names) -> None:
    """Zero the launches of the wrappers ``names`` in the record of
    launches (``ops/_ffi``); with the train-mode BatchNorm's, its
    engagement counts (``ops/train_bn.calls``) too."""
    from mcncrossmodalemotions_torch.ops import _ffi, train_bn

    _ffi.reset(names)
    if set(names) & set(TRAIN_BN_NAMES):
        train_bn.calls.update(dict.fromkeys(train_bn.calls, 0))


def read_counts(names) -> dict:
    """The launches of the wrappers ``names`` since their last reset."""
    from mcncrossmodalemotions_torch.ops import _ffi

    return _ffi.launches(names)


def add_timing(timings: dict, work: dict, name: str, ms: list,
               nbytes: float, ops: float) -> str:
    """Add one launch shape's (kernel, plain[, library]) ms and its work;
    a kernel whose plain version is its library call passes two times.
    Returns the shape's bound and its share, for the shape's line."""
    k, p = ms[0], ms[1]
    lib = ms[2] if len(ms) > 2 else p
    for i, v in enumerate((k, p, lib)):
        timings[name][i] += v
    work[name][0] += nbytes
    work[name][1] += ops
    bound, by = bound_ms(nbytes, ops)
    return f"bound {bound:.5f} ms ({by}), {bound / k:.1%} of it"


def k2_backward_phase(card: str, timings: dict, errs: dict,
                      work: dict, dry_rows: list) -> None:
    """K2 with-index forward and backward vs their plain versions at the
    train step's pool inputs, at the demo's and the bench's epoch steps'
    rows and at the graft phase's dry-run shards (``dry_rows`` rows of
    crops of ``graft_entry.TINY_FRAMES``) (phase 7)."""
    import torch
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.graft_entry import TINY_FRAMES
    from mcncrossmodalemotions_torch.ops import pool

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    # post-ReLU in both dtypes, then small integers cast to bf16: ties in
    # nearly every window, where only the first maximum in row-major window
    # order gives the plain version's idx
    cases = [(label, shape, kind, dtype)
             for label, shape in pool_inputs(TRAIN_BATCH, 400, 512).items()
             for kind, dtype in (("post-ReLU", torch.bfloat16),
                                 ("post-ReLU", torch.float32),
                                 ("tie-heavy", torch.bfloat16))]
    cases += [("even H and W", EVEN_POOL, "post-ReLU", torch.bfloat16),
              ("even H and W", EVEN_POOL, "post-ReLU", torch.float32),
              ("narrow", NARROW_POOL, "tie-heavy", torch.bfloat16)]
    cases += [(f"{who} {label}", shape, "post-ReLU", torch.bfloat16)
              for who, rows in (("demo", DEMO_BATCH), ("bench epoch", BATCH),
                                ("worked example", WORKFLOW_BATCH))
              for label, shape in pool_inputs(rows, 400, 512).items()]
    cases += [(f"graft dry run {label}", shape, "post-ReLU", torch.bfloat16)
              for rows in dry_rows
              for label, shape in pool_inputs(rows, TINY_FRAMES, 512).items()]
    for label, shape, kind, dtype in cases:
        gen.manual_seed(SEED)
        if kind == "tie-heavy":
            x = torch.randint(0, 3, shape, device=dev, generator=gen).to(dtype)
        else:
            x = torch.relu(torch.randn(shape, device=dev,
                                       generator=gen)).to(dtype)
        y, idx = pool.max_pool_3x3s2_idx_cuda(x)
        dy = torch.randn(y.shape, device=dev, generator=gen).to(dtype)
        dx = pool.max_pool_3x3s2_bwd_cuda(dy, idx, *shape[1:3])
        y_free = pool.max_pool_3x3s2_cuda(x)
        ref_y, ref_idx = pool.max_pool_3x3s2_with_index(x)
        ref_y = ref_y.contiguous()
        same_y = torch.equal(bits(y), bits(ref_y))
        same_free = torch.equal(bits(y), bits(y_free))
        errs["max_pool_3x3s2_idx"] = max(
            errs["max_pool_3x3s2_idx"],
            (y.float() - ref_y.float()).abs().max().item())
        same_idx = torch.equal(idx, ref_idx)
        ref = pool.max_pool_3x3s2_backward(x, dy).contiguous()
        torch.cuda.synchronize()
        same_dx = torch.equal(bits(dx), bits(ref))
        same_mask = torch.equal(dx != 0, ref != 0)
        err = (dx.float() - ref.float()).abs().max().item()
        errs["max_pool_3x3s2_bwd"] = max(errs["max_pool_3x3s2_bwd"], err)
        print(f"  K2 backward {label} {shape} {dtype} {kind}: with-index y "
              f"{'bitwise equal' if same_y else 'DIFFERENT'} to F.max_pool2d "
              f"and {'bitwise equal' if same_free else 'DIFFERENT'} to the "
              f"index-free kernel's, idx "
              f"{'equal to' if same_idx else 'DIFFERENT from'} the plain "
              f"code; dx {'bitwise equal' if same_dx else 'DIFFERENT'} "
              f"(winner mask {'identical' if same_mask else 'DIFFERENT'}, "
              f"max abs {err:.3e})", flush=True)
        check(same_y, f"K2 with-index {label} {dtype} {kind}: y not "
              "bitwise equal to F.max_pool2d")
        check(same_free, f"K2 with-index {label} {dtype} {kind}: y not "
              "bitwise equal to the index-free kernel's")
        check(same_idx, f"K2 with-index {label} {dtype} {kind}: idx not "
              "the plain version's code")
        check(same_dx, f"K2 backward {label} {dtype} {kind}: dx not "
              "bitwise equal to autograd of F.max_pool2d")
        if label in ("pool1", "pool2") and kind == "post-ReLU" \
                and dtype == torch.bfloat16:  # timed
            nchw = x.permute(0, 3, 1, 2)
            p, k = turns_ms(lambda: F.max_pool2d(nchw, 3, 2,
                                                 return_indices=True),
                            lambda: pool.max_pool_3x3s2_idx_cuda(x))
            b = add_timing(timings, work, "max_pool_3x3s2_idx", [k, p],
                           2 * x.numel() + 3 * y.numel(), 8 * y.numel())
            print(f"  {card}: K2 with-index {label} {shape} bf16: kernel "
                  f"{k:.4f} ms, plain (max_pool2d_with_indices) {p:.4f} "
                  f"ms; {b}")
            xg = x.detach().requires_grad_(True)
            yg = F.max_pool2d(xg.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
            p, k = turns_ms(
                lambda: torch.autograd.grad(yg, xg, dy, retain_graph=True),
                lambda: pool.max_pool_3x3s2_bwd_cuda(dy, idx, *shape[1:3]))
            b = add_timing(timings, work, "max_pool_3x3s2_bwd", [k, p],
                           3 * dy.numel() + 2 * dx.numel(), 4 * dx.numel())
            print(f"  {card}: K2 backward {label} {shape} bf16: kernel "
                  f"{k:.4f} ms, plain (max_pool2d_with_indices_backward) "
                  f"{p:.4f} ms; {b}", flush=True)
            del xg, yg
        del x, y, y_free, ref_y, ref_idx, idx, dy, dx, ref
        torch.cuda.empty_cache()


def train_phase(card: str, wrappers: tuple,
                bn_launches: dict | None = None) -> dict:
    """The full-width train step with and without the kernels (phase 8);
    returns the kernel steps' launch counts and adds their train-mode
    BatchNorm launches to ``bn_launches``."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import student_loss_fn

    dev = torch.device("cuda")
    new_student, init = student_init(full=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = DEFAULT_SPEC.crop_samples(400)
    batch = {
        "data": (torch.randn(TRAIN_BATCH, n, device=dev, generator=gen)
                 * 0.1 * 32767).round().clamp(-32768, 32767).to(torch.int16),
        "logit_target": torch.randn(TRAIN_BATCH, 8, device=dev,
                                    generator=gen) * 2,
        "max_label": torch.randint(0, 8, (TRAIN_BATCH,), device=dev,
                                   generator=gen, dtype=torch.int32),
        "pad_mask": torch.ones(TRAIN_BATCH, device=dev),
    }
    loss_fn = student_loss_fn("hot-cross-ent", temperature=2.0)
    runs = {}
    for mode in ("kernels", "plain"):
        model = new_student()  # full width, bf16 compute, fp32 params
        model.load_state_dict(init)
        state = TrainState.create(model.to(dev),
                                  torch.Generator(device=dev).manual_seed(SEED))
        step = make_train_step(loss_fn, SGDConfig(weight_decay=0.0),
                               pass_pad_mask=True,
                               use_kernels=mode == "kernels")
        w0 = state.model.net.conv1.weight.detach().clone()
        reset_counts(wrappers + TRAIN_BN_NAMES)
        losses = []
        for _ in range(3):
            state, m = step(state, batch, TRAIN_LR)
            losses.append(m["loss"].item())
        counts = read_counts(wrappers)
        fused = 3 * STUDENT_BNS if mode == "kernels" else 0
        count_train_bn(f"train {mode}", fused, 3 * STUDENT_BNS - fused,
                       bn_launches if fused else None)
        update = state.model.net.conv1.weight.detach() - w0
        torch.cuda.reset_peak_memory_stats()
        for _ in range(WARMUP_STEPS):
            step(state, batch, TRAIN_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, m = step(state, batch, TRAIN_LR)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[mode] = dict(losses=losses, counts=counts, update=update,
                          step_s=step_s)
        print(f"  train {mode}: losses {losses}; launches over 3 steps "
              f"{counts}", flush=True)
        print(f"  {card}: train step {mode}: {1e3 * step_s:.3f} ms = "
              f"{TRAIN_BATCH / step_s:.2f} utts/s (mean of {TIMED_STEPS} steps "
              f"after {WARMUP_STEPS} warm-up), peak memory {peak:.2f} GiB",
              flush=True)
        del state, step, model
        torch.cuda.empty_cache()

    k, p = runs["kernels"], runs["plain"]
    check(all(np.isfinite(k["losses"] + p["losses"])), "non-finite train loss")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"]))
    upd = ((k["update"] - p["update"]).norm() / p["update"].norm()).item()
    print(f"  train kernels vs plain: max loss rel diff {rel:.3e} (gate "
          f"{TRAIN_LOSS_RTOL}); conv1 update rel L2 {upd:.3e} (gate "
          f"{TRAIN_UPDATE_RTOL})")
    check(rel <= TRAIN_LOSS_RTOL, "kernel-on train losses disagree with plain")
    check(upd <= TRAIN_UPDATE_RTOL, "kernel-on conv1 update disagrees with plain")
    want = {k: 0 for k in wrappers} | {"spectrogram": 3,
                                       "max_pool_3x3s2_idx": 6,
                                       "max_pool_3x3s2_bwd": 6}
    check(k["counts"] == want, f"train launches {k['counts']}, expected {want}")
    check(not any(p["counts"].values()), f"plain steps launched {p['counts']}")
    return k["counts"]


def distill_phase(root: Path, wrappers: tuple,
                  bn_launches: dict | None = None) -> tuple:
    """``run_distillation`` end to end, then its resume (phase 9); returns
    the first call's launch counts and the synthetic imdb, and adds its
    train-mode BatchNorm launches to ``bn_launches``."""
    import numpy as np

    from mcncrossmodalemotions_torch.data.emovox import build_synthetic_imdb
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.train.checkpoints import list_checkpoints

    imdb = build_synthetic_imdb(root / "wav", num_speakers=8,
                                tracks_per_speaker=20, seed=SEED)
    kw = dict(batch_size=64, mini_epoch_ratio=1.0, out_root=str(root / "exps"),
              seed=SEED)
    reset_counts(wrappers + TRAIN_BN_NAMES)
    t0 = time.perf_counter()
    _, history, exp_dir = run_distillation(DistillationConfig(num_epochs=2, **kw),
                                           imdb, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts(wrappers)
    steps = sum(h["train"]["num_samples"] for h in history) // 64
    count_train_bn("distill", STUDENT_BNS * steps, 0, bn_launches)
    for h in history:
        tr = h["train"]
        print(f"  distill epoch {h['epoch']}: train loss {tr['loss']:.4f}, "
              f"{tr['num_samples']} samples, {tr['samples_per_sec']:.2f} "
              f"samples/s, feed_bound_frac {tr['feed_bound_frac']}, "
              f"feed_wait_s {tr['feed_wait_s']}, device_drain_s "
              f"{tr['device_drain_s']}; val loss {h['val']['loss']:.4f} "
              f"({h['val']['num_samples']} samples)", flush=True)
    print(f"  distill: 2 epochs in {wall:.2f} s; launches {counts}")
    check([h["epoch"] for h in history] == [1, 2], "distill epochs")
    check(all(h["train"]["num_samples"] == 128 for h in history),
          "an epoch did not run 2 full batches of 64")
    check(all(np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])
              for h in history), "non-finite distill loss")
    check([e for e, _ in list_checkpoints(exp_dir)] == [1, 2],
          "checkpoints 1 and 2 missing")
    check(len((exp_dir / "metrics.jsonl").read_text().splitlines()) == 2,
          "metrics.jsonl lacks the two epochs")
    n_val = history[0]["val"]["num_samples"]
    want = epoch_launches(wrappers, 2, -(-n_val // 64), epochs=2)
    check(counts == want, f"distill launches {counts}, expected {want}")
    _, history, _ = run_distillation(DistillationConfig(num_epochs=3, **kw),
                                     imdb, device="cuda")
    print(f"  distill resume: ran epochs {[h['epoch'] for h in history]}, "
          f"feed_bound_frac {history[-1]['train']['feed_bound_frac']}")
    check([h["epoch"] for h in history] == [3], "resume did not start at epoch 3")
    check([e for e, _ in list_checkpoints(exp_dir)] == [1, 2, 3],
          "checkpoint 3 missing")
    return counts, imdb


def probe_path_cases(dev) -> list:
    """(label, kernel, plain, args, path) of the probe kernels' paths that
    the probes themselves do not take: the gather at P4r's tile (x [16,
    100, 96], P4r's index) one element into its buffer (no 16-byte
    alignment) and with a ragged inner 95, f32 and bf16, and P12's
    expansion at C = 96 with even W (196) and 2 (Wh - 1) == W (196, 99),
    at C = 5 (one channel a thread) with odd and even W, and with y one
    element into its buffer, these on small-integer ties."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.ops import probes
    from mcncrossmodalemotions_torch.tools import probe_mosaic2 as p2

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def offset(shape, dtype, draw, k=1):
        n = int(np.prod(shape))
        return draw(n + k).to(dtype)[k:].view(shape)

    def randn(n):
        return torch.randn(n, device=dev, generator=gen)

    def ties(n):
        return torch.randint(0, 3, (n,), device=dev, generator=gen).float()

    index = probes.index_map(np.repeat(np.arange(p2.WH), 2)[:p2.W], p2.WH, dev)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        cases += [
            (f"gather misaligned {tag}", probes.probe_gather, probes.gather,
             (offset((p2.T, p2.WH, p2.C), dtype, randn), index, 1),
             probes.Route(1, False)),
            (f"gather ragged inner 95 {tag}", probes.probe_gather,
             probes.gather, (offset((p2.T, p2.WH, 95), dtype, randn, 0),
                             index, 1), probes.Route(1, False))]
    for c, w, wh, k in ((96, 196, 100, 0), (96, 196, 99, 0), (5, 197, 100, 0),
                        (5, 196, 99, 0), (96, 197, 100, 1)):
        x = ties(p2.T * w * c).view(p2.T, w, c)
        y = offset((p2.T, wh, c), torch.float32, ties, k)
        dy = randn(p2.T * wh * c).view(p2.T, wh, c)
        vec = 4 if c % 4 == 0 and k == 0 else 1
        cases.append((f"P12 C={c} W={w} Wh={wh}" + (" y misaligned" if k else ""),
                      probes.probe_col_candidates, probes.col_candidates,
                      (x, y, dy), probes.Route(vec, False)))
    return cases


def probes_phase(card: str, wrappers: tuple, timings: dict, errs: dict,
                 work: dict) -> dict:
    """Both probe tools on the card, then each probe kernel against its
    plain version, on its path, and timed, then the paths the probes do
    not take (phase 24); returns the tools' launch counts."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.ops import probes
    from mcncrossmodalemotions_torch.tools import probe_mosaic, probe_mosaic2
    from mcncrossmodalemotions_torch.tools.time_probes import probe_work

    dev = torch.device("cuda")
    reset_counts(wrappers)
    results = {**probe_mosaic.main(dev), **probe_mosaic2.main(dev)}
    counts = read_counts(wrappers)
    failed = [n for n, (ran, ok) in results.items() if not (ran and ok)]
    print(f"  probes: {len(results)} run, launches {counts}", flush=True)
    check(len(results) == N_PROBES and not failed,
          f"probes that failed or did not match numpy: {failed}")
    want = {k: 0 for k in wrappers} | {"probe_gather": N_PROBES - 2,
                                       "probe_select_matmul": 1,
                                       "probe_col_candidates": 1}
    check(counts == want, f"probe launches {counts}, expected {want}")

    one, one_index = torch.zeros(1, device=dev), probes.index_map([0], 1, dev)
    floor = cuda_ms(lambda: probes.probe_gather(one, one_index, 0), PROBE_ITERS)
    print(f"  {card}: launch floor (a one-element probe_gather, queued): "
          f"{floor:.5f} ms", flush=True)
    library = {probes.probe_gather: lambda x, index, axis: torch.index_select(
                   x, axis, index.values),
               probes.probe_select_matmul: torch.matmul}
    for p in probe_mosaic.make_probes(dev) + probe_mosaic2.make_probes(dev):
        name = p.kernel.__name__
        got, ref = p.run(), p.run(plain=True)
        torch.cuda.synchronize()
        same = got.shape == ref.shape and torch.equal(bits(got), bits(ref))
        err = (got - ref).abs().max().item()
        errs[name] = max(errs[name], err)
        exact = np.array_equal(got.cpu().numpy(), p.expect)
        path = getattr(p.kernel, "route", None)
        if path is not None:  # the launcher's own path is the one named
            built = probes.library_route(p.kernel)
            check(built == path, f"{p.name}: the launcher took {built}, "
                  f"ops/probes.py names {path}")
        fns = [lambda: p.run(plain=True), lambda: p.run()]
        if p.kernel in library:
            fns.append(lambda: library[p.kernel](*p.args))
        ms = turns_ms(*fns, iters=PROBE_ITERS)
        b = add_timing(timings, work, name, [ms[1], ms[0], *ms[2:]],
                       *probe_work(p))
        least = max(bound_ms(*probe_work(p))[0], floor)
        b += (f"; launch floor {floor:.5f} ms, {least / ms[1]:.1%} of "
              f"max(bound, floor)")
        print(f"  {card}: {p.name} ({name}"
              + ("" if path is None else f", {path.vec} element(s) a load, "
                 f"{'64' if path.wide else '32'}-bit offsets")
              + f"): kernel "
              f"{'bitwise equal to' if same else 'DIFFERENT from'} plain, "
              f"{'exactly' if exact else 'not exactly'} numpy's expect; "
              f"kernel {ms[1]:.5f} ms, plain {ms[0]:.5f} ms"
              + (f", library {ms[2]:.5f} ms" if len(ms) > 2 else "")
              + f"; {b}", flush=True)
        check(same, f"{p.name}: kernel not bitwise equal to its plain version")
        if p.kernel is probes.probe_select_matmul:
            check(exact, f"{p.name}: kernel not exactly numpy's expect")

    gen = torch.Generator(device=dev)
    for m, k, n in ((16, 128, 256), (5, 37, 70)):  # the probe's, ragged
        gen.manual_seed(SEED)
        a = torch.randn(m, k + 3, device=dev, generator=gen)[:, :k]
        b = torch.randn(k, n, device=dev, generator=gen)
        got = probes.probe_select_matmul(a, b).double()
        a, b = a.double(), b.double()
        err = ((got - a @ b).abs() / (a.abs() @ b.abs())).max().item()
        print(f"  P9 on random [{m},{k}] (row stride {k + 3}) @ [{k},{n}]: "
              f"max |c - c64| / (|a| @ |b|) {err:.3e} (gate {P9_RTOL})",
              flush=True)
        check(err <= P9_RTOL, f"P9 random {m}x{k}x{n}: {err:.3e} > {P9_RTOL}")

    # P12's own inputs are independent normals, so x == y never holds and
    # its expect is all zeros; small integers make both branches fire.
    t, w, c, wh = probe_mosaic2.T, probe_mosaic2.W, probe_mosaic2.C, probe_mosaic2.WH
    gen.manual_seed(SEED)
    x = torch.randint(0, 3, (t, w, c), device=dev, generator=gen).float()
    y = torch.randint(0, 3, (t, wh, c), device=dev, generator=gen).float()
    dy = torch.randn(t, wh, c, device=dev, generator=gen)
    got = probes.probe_col_candidates(x, y, dy)
    ref = probes.col_candidates(x, y, dy)
    torch.cuda.synchronize()
    same = torch.equal(bits(got), bits(ref))
    even = (torch.arange(w, device=dev) % 2 == 0).view(1, w, 1)
    shares = []  # per branch: the share of outputs it adds a nonzero to
    for k2 in (0, 1):
        yc = torch.repeat_interleave(y[:, 1 - k2:], 2, dim=1)[:, :w]
        dyc = torch.repeat_interleave(dy[:, 1 - k2:], 2, dim=1)[:, :w]
        fired = (x == yc) & (dyc != 0)
        if k2:
            fired = fired & even
        shares.append(fired.float().mean().item())
    nonzero = (got != 0).float().mean().item()
    print(f"  P12 on small-integer inputs: kernel "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} plain; "
          f"nonzero shares: branch k2=0 {shares[0]:.4f}, k2=1 {shares[1]:.4f}, "
          f"output {nonzero:.4f}", flush=True)
    check(same, "P12 on ties: kernel not bitwise equal to its plain version")
    check(min(shares) > 0 and nonzero > 0, "P12 on ties: a branch never fired")

    # the paths the probes do not take: misaligned, ragged, C = 5, even W
    for label, kernel, plain, args, want in probe_path_cases(dev):
        before = kernel.launches
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        same = got.shape == ref.shape and torch.equal(bits(got), bits(ref))
        path, built = kernel.route, probes.library_route(kernel)
        print(f"  {label}: kernel {'bitwise equal to' if same else 'DIFFERENT from'}"
              f" plain; path {path} (launcher {built}, expected {want}); "
              f"{kernel.launches - before} launch(es)", flush=True)
        check(same, f"{label}: kernel not bitwise equal to its plain version")
        check(path == built == want, f"{label}: path {path}, launcher {built}, "
              f"expected {want}")
        check(kernel.launches == before + 1, f"{label}: not one launch")
    return counts


def sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def extraction_chunks(paths, batch: int = BATCH) -> list:
    """(rows, t_pad, bucket) of every chunk the extractor launches the
    kernels for over ``paths``: tracks grouped by (t_pad, bucket), cut
    into chunks of ``batch``."""
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        AudioFeatureExtractor,
    )

    meta = AudioFeatureExtractor(None, {})
    groups: dict = {}
    for p in paths:
        _, bucket, t_pad = meta._meta(str(p))[:3]
        groups[(t_pad, bucket)] = groups.get((t_pad, bucket), 0) + 1
    return [(min(batch, count - k), t_pad, bucket)
            for (t_pad, bucket), count in sorted(groups.items())
            for k in range(0, count, batch)]


def imdb_paths(imdb) -> list:
    """The wav paths ``compute_audio_feats`` reads for ``imdb``."""
    wav_dir = getattr(imdb, "wav_dir", "")
    return [str(Path(wav_dir) / p) for p in imdb.wav_paths]


def extraction_launches(wrappers: tuple, imdb) -> dict:
    """The launches an extraction with kernels makes over ``imdb``: K1
    once and the index-free K2 twice per chunk."""
    n = len(extraction_chunks(imdb_paths(imdb)))
    return {k: 0 for k in wrappers} | {"spectrogram": n, "max_pool_3x3s2": 2 * n}


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] += v


def state_copy(state) -> dict:
    """A train state's model state_dict (weights and running statistics)
    and its velocity (``velocity <name>``), cloned."""
    return ({k: v.detach().clone()
             for k, v in state.model.state_dict().items()}
            | {f"velocity {k}": v.detach().clone()
               for k, v in state.velocity.items()})


def student_release(path: Path, seed: int = SEED, fc6: int = 4096,
                    fc7: int = 1024, zeroed: bool = False) -> dict:
    """Write a classic (v5) MatConvNet student ``.mat`` from seeded weights,
    every conv and fc6 with a nonzero bias and its BN mean moved by that
    bias, so the release computes what the seeded weights compute (the
    importer folds the bias back: mean - bias). ``zeroed`` writes every
    filter and bias as zeros (the BatchNorms kept): a broken release whose
    logits are constant. Returns the seeded weights in the Flax layout."""
    import numpy as np
    import scipy.io

    from mcncrossmodalemotions_torch.zoo import random_student_variables
    from mcncrossmodalemotions_torch.zoo.matconvnet import BN_EPSILON

    v = random_student_variables(seed=seed, fc6=fc6, fc7=fc7)
    p, s = v["params"], v["batch_stats"]
    rng = np.random.default_rng(seed + 1)
    named = {}
    for i, conv in enumerate(("conv1", "conv2", "conv3", "conv4", "conv5",
                              "fc6"), 1):
        kernel = p[conv]["kernel"]
        bias = rng.normal(0.0, 0.5, kernel.shape[-1]).astype(np.float32)
        named[f"{conv}f"], named[f"{conv}b"] = kernel, bias
        named[f"bn{i}f"], named[f"bn{i}b"] = p[f"bn{i}"]["scale"], p[f"bn{i}"]["bias"]
        sigma = np.sqrt(s[f"bn{i}"]["var"] + BN_EPSILON)
        named[f"bn{i}m"] = np.stack([s[f"bn{i}"]["mean"] + bias, sigma], axis=1)
    named["fc7f"], named["fc7b"] = p["fc7"]["kernel"][None, None], p["fc7"]["bias"]
    named["fc8f"] = p["prediction"]["kernel"][None, None]
    named["fc8b"] = p["prediction"]["bias"]
    if zeroed:
        named = {k: np.zeros_like(w) if k[-1] in "fb" and not k.startswith("bn")
                 else w for k, w in named.items()}
    arr = np.zeros((len(named),), dtype=[("name", object), ("value", object)])
    for i, item in enumerate(named.items()):
        arr[i] = item
    scipy.io.savemat(path, {"net": {"params": arr}})
    return v


def reader_phase(card: str, imdb, wrappers: tuple, dev="cuda",
                 widths: tuple = (4096, 1024)) -> dict:
    """The port's own wav reader library (built in the build phase with the
    host's g++): it, not Python, serves extraction; its crops are bitwise
    the Python reads' over the smoke's tracks, through both
    ``ds_read_crops`` and ``ds_read_crops_packed``; extraction's tracks/s
    with it and with Python reads, in turns, over windows of the tracks
    read ``READER_REPEATS`` times, beside the rows ``ds_read_crops_packed``
    copied (16-bit PCM) and decoded: every smoke track is 16-bit PCM, so a
    decoded row fails the phase. Returns the launches of the extractions
    that read through it."""
    import os

    import numpy as np

    from mcncrossmodalemotions_torch.data import audio, native_audio
    from mcncrossmodalemotions_torch.exp import compute_audio_feats as feats
    from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.zoo import (
        random_student_variables,
        student_state_dict_from_flax,
    )

    check(feats.wav_reader() is native_audio,
          "extraction does not read through the port's wav library")
    paths = imdb_paths(imdb)
    rng = np.random.default_rng(SEED)
    meta = feats.AudioFeatureExtractor(None, {})
    by_t_pad: dict = {}
    for p in paths:
        by_t_pad.setdefault(meta._meta(p)[2], []).append(p)
    native_audio.reset_rows()
    for t_pad, group in sorted(by_t_pad.items()):
        need = DEFAULT_SPEC.crop_samples(t_pad)
        for starts in ([0] * len(group),
                       [int(rng.integers(0, audio.wav_info(p).num_samples))
                        for p in group]):
            crops = native_audio.read_crops(group, starts, need)
            packed = native_audio.read_crops_packed(group, starts, need)
            python = np.zeros_like(crops)
            for row, path, start in zip(python, group, starts):
                got, _ = audio.read_wav(path, start, need)
                row[:len(got)] = got
            same = crops.view(np.int32).tobytes() == python.view(np.int32).tobytes()
            same_packed = np.array_equal(packed, audio.pack_pcm16(python))
            print(f"  t_pad {t_pad}: {len(group)} tracks x {need} samples from "
                  f"{'0' if not any(starts) else 'random starts'}: ds_read_crops "
                  f"{'bitwise equal to' if same else 'DIFFERENT from'} the "
                  f"Python reads, ds_read_crops_packed "
                  f"{'bitwise equal to' if same_packed else 'DIFFERENT from'} "
                  f"their pack_pcm16", flush=True)
            check(same and same_packed,
                  f"the port's reader differs from Python at t_pad {t_pad}")
    packed_rows = native_audio.read_crops_packed
    check(packed_rows.decoded_rows == 0 and packed_rows.raw_rows > 0,
          f"16-bit tracks decoded: {packed_rows.decoded_rows} rows decoded, "
          f"{packed_rows.raw_rows} copied")

    fc6, fc7 = widths
    model = VGGMStudent(fc6_features=fc6, fc7_features=fc7)
    state = student_state_dict_from_flax(
        random_student_variables(seed=SEED, fc6=fc6, fc7=fc7))
    # each timed window reads the track list READER_REPEATS times over
    window = paths * READER_REPEATS
    chunks = len(extraction_chunks(window))
    want = {k: 0 for k in wrappers} | {"spectrogram": chunks,
                                        "max_pool_3x3s2": 2 * chunks}
    counts = {k: 0 for k in wrappers}
    runs = {"library": [], "python": []}
    rows = {"library": [], "python": []}  # (copied, decoded) a run
    logits = {}
    order = ("library", "python", "python", "library")
    for mode in order:
        if mode == "python":
            os.environ["MCNCME_DISABLE_NATIVE"] = "1"
        try:
            ex = feats.AudioFeatureExtractor(model, state, batch_size=BATCH,
                                             device=dev)
            reset_counts(wrappers)
            native_audio.reset_rows()
            t0 = time.perf_counter()
            out = ex.track_logits(window, verbose=False)
            sync(dev)
            runs[mode].append(time.perf_counter() - t0)
            rows[mode].append((packed_rows.raw_rows, packed_rows.decoded_rows))
        finally:
            os.environ.pop("MCNCME_DISABLE_NATIVE", None)
        check(rows[mode][-1][1] == 0,
              f"reader {mode}: {rows[mode][-1][1]} rows of 16-bit tracks decoded")
        got = read_counts(wrappers)
        check(got == want, f"reader {mode}: launches {got}, expected {want}")
        if mode == "library":
            add_counts(counts, got)
            check(ex.readers == {"native-packed"},
                  f"extraction read with {ex.readers}, not the port's library")
        else:
            check(ex.readers == {"python"}, f"python run read with {ex.readers}")
        logits.setdefault(mode, np.concatenate(out))
    a, b = logits["library"], logits["python"]
    diff = float(np.abs(a - b).max())
    print(f"  logits, library reads vs Python reads: max abs {diff:.3e} "
          f"({'bitwise equal' if np.array_equal(a, b) else 'not bitwise equal'})")
    check(diff <= SLICE_REL_TOL * float(np.abs(b).max()),
          "library-read logits disagree with Python-read ones")
    rates = {mode: ", ".join(f"{len(window) / w:.2f} in {w:.3f} s (raw_rows "
                             f"{r[0]}, decoded_rows {r[1]})"
                             for w, r in zip(walls, rows[mode]))
             for mode, walls in runs.items()}
    print(f"  {card}: extraction tracks/s, library reads {rates['library']}; "
          f"Python reads {rates['python']} (in turns: {', '.join(order)}; "
          f"{len(paths)} tracks x {READER_REPEATS} a window, batch {BATCH})",
          flush=True)
    return counts


def release_phase(card: str, root: Path, imdb, distill_imdb, wrappers: tuple,
                  dev="cuda", widths: tuple = (4096, 1024),
                  batch: int = 64) -> tuple:
    """A released student at full width: a classic ``.mat`` written from
    seeded weights with nonzero conv biases, loaded on the card by
    ``load_pretrained_student``; its extraction logits against the same
    weights through the bridge, biases already folded (the extraction
    gate); one ``run_distillation`` epoch from the file, and
    ``load_student_from_exp(..., 'best')`` bitwise equal to the
    checkpoint's state. Returns (launches, model, state)."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        load_student_from_exp,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.models.vggm import VGGMStudent
    from mcncrossmodalemotions_torch.train.checkpoints import (
        checkpoint_path,
        read_checkpoint,
    )
    from mcncrossmodalemotions_torch.zoo import (
        load_pretrained_student,
        student_state_dict_from_flax,
    )

    fc6, fc7 = widths
    mat = root / "emovoxceleb-student.mat"
    t0 = time.perf_counter()
    seeded = student_release(mat, fc6=fc6, fc7=fc7)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model, state = load_pretrained_student(mat, with_frontend=False, device=dev)
    load_s = time.perf_counter() - t0
    check(model.fc6.weight.shape[0] == fc6 and model.fc7.weight.shape[0] == fc7
          and model.prediction.weight.shape[0] == 8, "release widths")
    check(all(v.device.type == torch.device(dev).type for v in state.values()),
          "the release's state is not on the card")
    print(f"  release {mat.stat().st_size / 2**20:.1f} MiB written in "
          f"{write_s:.2f} s, loaded in {load_s:.2f} s (fc6 {fc6}, fc7 {fc7}, "
          "8 outputs)", flush=True)
    counts = {k: 0 for k in wrappers}
    reset_counts(wrappers)
    got = compute_audio_feats(imdb, model, state, batch_size=BATCH,
                              verbose=False, device=dev)
    sync(dev)
    launches = read_counts(wrappers)
    want = extraction_launches(wrappers, imdb)
    check(launches == want, f"release extraction launches {launches}, "
          f"expected {want}")
    add_counts(counts, launches)
    bare = VGGMStudent(fc6_features=fc6, fc7_features=fc7)
    ref = compute_audio_feats(imdb, bare, student_state_dict_from_flax(seeded),
                              batch_size=BATCH, verbose=False, device=dev)
    got, ref = np.concatenate(got), np.concatenate(ref)
    check(got.shape == (len(imdb.wav_paths), 8) and np.isfinite(got).all(),
          "release logits not finite [N, 8]")
    scale, diff = float(np.abs(ref).max()), float(np.abs(got - ref).max())
    print(f"  release logits vs the seeded weights through the bridge: max "
          f"abs {diff:.3e}, max |logit| {scale:.3f}, rel {diff / scale:.3e} "
          f"(gate {SLICE_REL_TOL})", flush=True)
    check(diff <= SLICE_REL_TOL * scale, "release logits disagree")

    cfg = DistillationConfig(num_epochs=1, from_scratch=False,
                             pretrained_student=str(mat), batch_size=batch,
                             mini_epoch_ratio=1.0, seed=SEED,
                             out_root=str(root / "exps-release"))
    reset_counts(wrappers)
    t0 = time.perf_counter()
    _, history, exp_dir = run_distillation(cfg, distill_imdb, device=dev)
    wall = time.perf_counter() - t0
    launches = read_counts(wrappers)
    h = history[0]
    print(f"  from-release epoch: train loss {h['train']['loss']:.4f} over "
          f"{h['train']['num_samples']} samples, val loss "
          f"{h['val']['loss']:.4f}, {wall:.2f} s; launches {launches}",
          flush=True)
    check([r["epoch"] for r in history] == [1]
          and np.isfinite(h["train"]["loss"]), "from-release epoch")
    val_batches = -(-h["val"]["num_samples"] // batch)
    train_batches = h["train"]["num_samples"] // batch
    want = {k: 0 for k in wrappers} | {
        "spectrogram": train_batches + val_batches,
        "max_pool_3x3s2": 2 * val_batches,
        "max_pool_3x3s2_idx": 2 * train_batches,
        "max_pool_3x3s2_bwd": 2 * train_batches}
    check(launches == want, f"from-release launches {launches}, expected {want}")
    add_counts(counts, launches)
    _, best = load_student_from_exp(exp_dir, "best", device=dev)
    saved = read_checkpoint(checkpoint_path(exp_dir, 1))["model"]
    same = (sorted(best) == sorted(k[len("net."):] for k in saved)
            and all(torch.equal(v.cpu(), saved["net." + k])
                    for k, v in best.items()))
    print(f"  load_student_from_exp(best): {len(best)} tensors "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} checkpoint 1's",
          flush=True)
    check(same, "load_student_from_exp does not give back the checkpoint")
    return counts, model, state


def swapped_pairs(positive, a, b) -> list:
    """(positive, negative) row pairs of two score vectors whose order
    differs between ``a`` and ``b``; each such pair moves an AUC over
    these rows by 1 / (positives x negatives)."""
    import numpy as np

    pos, neg = np.flatnonzero(positive), np.flatnonzero(~positive)
    order_a = np.sign(a[pos][:, None] - a[neg][None, :])
    order_b = np.sign(b[pos][:, None] - b[neg][None, :])
    i, j = np.nonzero(order_a != order_b)
    return [(int(pos[x]), int(neg[y])) for x, y in zip(i, j)]


def compare_stats(a: tuple, b: tuple, imdb) -> dict:
    """Two ``student_stats`` runs, each (result, [N, C] logits), partition
    by partition: {partition: (largest per-emotion AUC gap, its emotion,
    [(emotion, imdb track pairs whose order differs)], pairs compared)},
    the pairs counted over every emotion with an AUC."""
    import numpy as np

    from mcncrossmodalemotions_torch import EMOTIONS
    from mcncrossmodalemotions_torch.exp.student_stats import (
        PARTITIONS,
        softmax_np,
        teacher_labels,
    )

    labels = teacher_labels(imdb)
    (res_a, logits_a), (res_b, logits_b) = a, b
    scores_a, scores_b = softmax_np(logits_a, axis=1), softmax_np(logits_b, axis=1)
    out = {}
    for part, row in res_a.items():
        check(list(row) == list(res_b[part]), f"{part}: other emotions")
        mask = imdb.set_id == PARTITIONS[part]
        tracks = np.flatnonzero(mask)
        gap, worst, swaps, pairs = 0.0, "no emotion", [], 0
        for emotion, auc in row.items():
            if emotion == "meanAuc":
                continue
            c = EMOTIONS.index(emotion)
            positive = labels[mask] == c
            pairs += int(positive.sum()) * int((~positive).sum())
            diff = abs(auc - res_b[part][emotion])
            if diff >= gap:
                gap, worst = diff, emotion
            swaps += [(emotion, (tracks[i], tracks[j])) for i, j in
                      swapped_pairs(positive, scores_a[mask, c],
                                    scores_b[mask, c])]
        out[part] = (gap, worst, swaps, pairs)
    return out


def analysis_phase(card: str, root: Path, model, state, distill_imdb,
                   wrappers: tuple, dev="cuda",
                   widths: tuple = (4096, 1024)) -> dict:
    """The student's analysis on the card: ``student_stats`` over the
    distill phase's imdb with the released student, extraction with the
    kernels and plain. In fp32, where the two differ only by K1's
    summation order, each per-emotion AUC within 0.02. In bf16, the
    default, the rounding of the conv inputs moves logits by about 1e-2
    relative, which swaps near-tied tracks of the random student, and a
    few swaps in a partition of a few tracks move an AUC by more than
    0.02: there the kernels may reorder, partition by partition, at most
    twice as many (positive, negative) track pairs (and one) as bf16
    itself reorders on the plain path against fp32. Then
    ``emo_benchmarks`` (bf16) over a synthetic external set of 60 tracks
    in 6 classes with 5 folds. Returns the kernel runs' launches."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.data.external import (
        build_synthetic_track_imdb,
    )
    from mcncrossmodalemotions_torch.data.imdb import float_tracks
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.emo_benchmarks import emo_benchmarks
    from mcncrossmodalemotions_torch.exp.student_stats import student_stats
    from mcncrossmodalemotions_torch.models.vggm import VGGMStudent

    counts = {k: 0 for k in wrappers}
    want = extraction_launches(wrappers, distill_imdb)
    fp32 = VGGMStudent(fc6_features=widths[0], fc7_features=widths[1],
                       dtype=torch.float32)
    runs = {}  # (precision, kernels) -> (student_stats result, logits)
    for label, m in (("fp32", fp32), ("bf16", model)):
        for kernels in (True, False):
            feats = root / f"feats-{label}-{'kernels' if kernels else 'plain'}.npz"
            reset_counts(wrappers)
            t0 = time.perf_counter()
            res = student_stats(distill_imdb, model=m, state=state,
                                feat_path=str(feats), verbose=False,
                                use_kernels=kernels, device=dev)
            sync(dev)
            wall = time.perf_counter() - t0
            launches = read_counts(wrappers)
            if kernels:
                check(launches == want, f"student_stats {label} launches "
                      f"{launches}, expected {want}")
                add_counts(counts, launches)
            else:
                check(not any(launches.values()), f"plain launched {launches}")
            runs[label, kernels] = (res, np.concatenate(
                float_tracks(np.load(feats, allow_pickle=True)["logits"])))
        print(f"  student_stats {label} over {distill_imdb.num_tracks} tracks, "
              f"{wall:.2f} s plain", flush=True)
    del fp32

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    print(f"  logits max rel difference: bf16 kernels vs plain "
          f"{rel(runs['bf16', True][1], runs['bf16', False][1]):.3e}, bf16 vs "
          f"fp32 plain {rel(runs['bf16', False][1], runs['fp32', False][1]):.3e}"
          f", fp32 kernels vs plain "
          f"{rel(runs['fp32', True][1], runs['fp32', False][1]):.3e}", flush=True)
    fp32 = compare_stats(runs["fp32", True], runs["fp32", False], distill_imdb)
    bf16 = compare_stats(runs["bf16", True], runs["bf16", False], distill_imdb)
    noise = compare_stats(runs["bf16", False], runs["fp32", False], distill_imdb)
    for part, (gap, emotion, swaps, pairs) in fp32.items():
        print(f"  student_stats fp32 {part}: meanAuc "
              f"{runs['fp32', True][0][part]['meanAuc']:.4f} kernels, "
              f"{runs['fp32', False][0][part]['meanAuc']:.4f} plain; max "
              f"per-emotion AUC gap {gap:.4f} ({emotion}; gate {AUC_TOL}), "
              f"{len(swaps)} of {pairs} track pairs reordered", flush=True)
        check(gap <= AUC_TOL, f"fp32 {part}: AUC kernels vs plain {gap:.4f}")
    for part, (gap, emotion, swaps, pairs) in bf16.items():
        ref_gap, ref_emotion, ref_swaps, _ = noise[part]
        print(f"  student_stats bf16 {part}: meanAuc "
              f"{runs['bf16', True][0][part]['meanAuc']:.4f} kernels, "
              f"{runs['bf16', False][0][part]['meanAuc']:.4f} plain; max "
              f"per-emotion AUC gap {gap:.4f} ({emotion}); {len(swaps)} of "
              f"{pairs} track pairs reordered (gate {2 * len(ref_swaps) + 1}); "
              f"bf16 vs fp32 plain: max AUC gap {ref_gap:.4f} ({ref_emotion}), "
              f"{len(ref_swaps)} pairs reordered", flush=True)
        if swaps:
            print(f"    kernels vs plain reorder (emotion: positive, negative "
                  "track): " + ", ".join(f"{e}: {i}, {j}"
                                         for e, (i, j) in swaps[:8])
                  + (", ..." if len(swaps) > 8 else ""), flush=True)
        check(len(swaps) <= 2 * len(ref_swaps) + 1,
              f"bf16 {part}: kernels vs plain reorder {len(swaps)} track "
              f"pairs, bf16 itself {len(ref_swaps)}")

    ext = build_synthetic_track_imdb(root / "external", tracks_per_class=10,
                                     duration=2.0, seed=SEED)
    reset_counts(wrappers)
    logits = compute_audio_feats(ext, model, state, batch_size=BATCH,
                                 verbose=False, device=dev)
    sync(dev)
    launches = read_counts(wrappers)
    want = extraction_launches(wrappers, ext)
    check(launches == want, f"benchmark extraction launches {launches}, "
          f"expected {want}")
    add_counts(counts, launches)
    with contextlib.redirect_stdout(sys.stderr):
        res = emo_benchmarks({"synthetic-rml": dict(
            track_logits=logits, labels=ext.labels,
            classes=list(ext.classes))}, num_folds=5)["synthetic-rml"]
    print(f"  emo_benchmarks over {len(logits)} tracks, 6 classes, 5 folds: "
          f"accuracy {res.mean_accuracy:.4f} +/- {res.std_accuracy:.4f} "
          f"(folds {', '.join(f'{a:.3f}' for a in res.fold_accuracies)})",
          flush=True)
    check(len(res.fold_accuracies) == 5
          and all(0.0 <= a <= 1.0 for a in res.fold_accuracies),
          "emo_benchmarks folds")
    return counts


def teacher_release(path: Path, seed: int = SEED, use_se: bool = True,
                    stage_sizes: tuple = (3, 4, 6, 3), width: int = 64,
                    average_image=(131.0912, 103.8827, 91.4953)) -> dict:
    """Write a classic (v5) MatConvNet teacher ``.mat`` from
    ``random_teacher_variables(seed)``: every conv with a nonzero bias and
    its BN mean moved by that bias (the importer folds it back: mean -
    bias), the SE pairs and the head as 1x1 filters, ``averageImage`` the
    VGGFace2 mean (any array, or None for none). Returns the seeded
    weights in the Flax layout."""
    import numpy as np
    import scipy.io

    from mcncrossmodalemotions_torch.zoo import random_teacher_variables
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        BN_EPSILON,
        resnet50_layer_map,
    )

    v = random_teacher_variables(seed=seed, use_se=use_se,
                                 stage_sizes=stage_sizes, width=width)
    p, s = v["params"], v["batch_stats"]
    rng = np.random.default_rng(seed + 1)

    def get(tree, path):
        for part in path.split("/"):
            tree = tree[part]
        return tree

    named, biases = {}, {}
    for layer, spec in resnet50_layer_map(stage_sizes, use_se=use_se).items():
        if spec["kind"] == "conv":
            kernel = get(p, layer)["kernel"]
            biases[layer] = rng.normal(0.0, 0.5, kernel.shape[-1]).astype(
                np.float32)
            named[spec["filters"][0]] = kernel
            named[spec["bias"][0]] = biases[layer]
        elif spec["kind"] == "dense":
            named[spec["filters"][0]] = get(p, layer)["kernel"][None, None]
            named[spec["bias"][0]] = get(p, layer)["bias"]
        else:
            conv = layer.replace("bn_down", "downsample").replace("bn", "conv")
            stats = get(s, layer)
            named[spec["gamma"][0]] = get(p, layer)["scale"]
            named[spec["beta"][0]] = get(p, layer)["bias"]
            named[spec["moments"][0]] = np.stack(
                [stats["mean"] + biases[conv],
                 np.sqrt(stats["var"] + BN_EPSILON)], axis=1)
    arr = np.zeros((len(named),), dtype=[("name", object), ("value", object)])
    for i, item in enumerate(named.items()):
        arr[i] = item
    net = {"params": arr}
    if average_image is not None:
        net["meta"] = {"normalization": {
            "averageImage": np.asarray(average_image, np.float32)}}
    scipy.io.savemat(path, {"net": net})
    return v


def classic_release(path: Path, seed: int = SEED, arch: str = "m",
                    use_batchnorm: bool = True, num_outputs: int = 2622,
                    average_image=(129.1863, 104.7624, 93.594),
                    **widths) -> dict:
    """Write a classic (v5) MatConvNet VGG face ``.mat`` (the classic face
    models' naming, ``vggface_layer_map``) from
    ``random_vggface_variables(seed, arch, use_batchnorm, num_outputs,
    **widths)``: every conv with a nonzero bias (BN means moved by it where
    there is BatchNorm; the importer folds it back), the head as a 1x1
    ``fc8`` filter, ``averageImage`` the classic vgg_face mean. Returns the
    seeded weights in the Flax layout."""
    import numpy as np
    import scipy.io

    from mcncrossmodalemotions_torch.zoo import random_vggface_variables
    from mcncrossmodalemotions_torch.zoo.matconvnet import (
        BN_EPSILON,
        vggface_layer_map,
    )

    v = random_vggface_variables(seed=seed, arch=arch,
                                 use_batchnorm=use_batchnorm,
                                 num_outputs=num_outputs, **widths)
    p, s = v["params"], v.get("batch_stats", {})
    rng = np.random.default_rng(seed + 1)
    named = {}
    for layer, spec in vggface_layer_map(
            arch, use_batchnorm=use_batchnorm).items():
        if spec["kind"] == "dense":
            named[spec["filters"][0]] = p[layer]["kernel"][None, None]
            named[spec["bias"][0]] = p[layer]["bias"]
        elif spec["kind"] == "conv":
            kernel = p[layer]["kernel"]
            named[spec["filters"][0]] = kernel
            named[spec["bias"][0]] = p[layer].get(
                "bias", rng.normal(0.0, 0.5, kernel.shape[-1]).astype(
                    np.float32))
        else:
            conv = layer[len("bn_"):]
            named[spec["gamma"][0]] = p[layer]["scale"]
            named[spec["beta"][0]] = p[layer]["bias"]
            named[spec["moments"][0]] = np.stack(
                [s[layer]["mean"] + named[vggface_layer_map(arch)[conv][
                    "bias"][0]],
                 np.sqrt(s[layer]["var"] + BN_EPSILON)], axis=1)
    arr = np.zeros((len(named),), dtype=[("name", object), ("value", object)])
    for i, item in enumerate(named.items()):
        arr[i] = item
    scipy.io.savemat(path, {"net": {"params": arr, "meta": {"normalization": {
        "averageImage": np.asarray(average_image, np.float32)}}}})
    return v


def golden_train_batch() -> dict:
    """The train golden's batch: the first 4 train images of
    ``build_synthetic_ferplus(num_images=8, seed=0)`` (48x48 uint8),
    warped on the host at 48x48 by ``ferplus_batches(augment=True, seed=0)``
    as the training path warps them (the pipeline resizes them to 224 on the
    device), with their vote distributions ('CNTK') and a full
    ``pad_mask``."""
    import numpy as np

    from mcncrossmodalemotions_torch.data.ferplus import (
        build_synthetic_ferplus,
        ferplus_batches,
    )

    imdb = build_synthetic_ferplus(num_images=8, seed=SEED)
    batch = next(ferplus_batches(imdb, 1, 4, seed=SEED, augment=True))
    return dict(batch, pad_mask=np.ones(4, np.float32))


def golden_sample(named) -> list:
    """The train golden's sample of ``{parameter name: tensor}`` (the port's
    names and layouts), in its order: of each tensor flattened, up to
    ``GOLDEN_SAMPLE`` entries evenly spaced, as float64 numpy."""
    import numpy as np

    out = []
    for t in named.values():
        flat = t.detach().double().cpu().numpy().reshape(-1)
        out.append(flat[np.unique(np.linspace(
            0, flat.size - 1, min(flat.size, GOLDEN_SAMPLE)).astype(np.int64))])
    return out


def golden_train_run(dtype, dev="cuda") -> dict:
    """The train golden's run in the port: full-width SENet50 (8 outputs,
    ``random_teacher_variables(seed=0)``) in ``FaceTeacherPipeline`` at 224,
    fliplr and dropout off, ``GOLDEN_STEPS`` MatConvNet SGD steps on
    ``golden_train_batch()`` ('distributions' loss, lr 0.01, momentum 0.9,
    wd 5e-4, backbone lr x 0.1), computing in ``dtype`` (float64 with
    float64 parameters, else fp32 parameters). float64 takes the batch
    resized to 224 on the host (``resize_separable`` on the CPU gives the
    JAX package's values; the pipeline then resizes nothing), fp32 and
    bf16 resize in the pipeline on ``dev``. Returns the parameter names,
    the step losses, ``golden_sample`` of the velocity after the first step
    (each parameter's first update: its gradient, weight decay and lr
    scale) and the head after the steps (Flax layout: kernel [2048, 8])."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.models import FaceTeacherPipeline, SENet50
    from mcncrossmodalemotions_torch.ops.warp import resize_separable
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        finetune_lr_scale_fn,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import (
        random_teacher_variables,
        teacher_loss_fn,
        teacher_state_dict_from_flax,
    )

    v = random_teacher_variables(seed=SEED)
    model = FaceTeacherPipeline(SENet50(num_outputs=8, dtype=dtype),
                                augment=False)
    model.load_state_dict(teacher_state_dict_from_flax(
        {"params": {"teacher": v["params"]},
         "batch_stats": {"teacher": v["batch_stats"]}}), strict=True)
    model = model.to(dev, torch.promote_types(dtype, torch.float32))
    state = TrainState.create(model,
                              torch.Generator(device=dev).manual_seed(SEED))
    step = make_train_step(
        teacher_loss_fn("distributions"),
        SGDConfig(momentum=0.9, weight_decay=5e-4),
        lr_scale_fn=finetune_lr_scale_fn(backbone_scale=GOLDEN_FINETUNE),
        pass_pad_mask=True)
    batch = {k: torch.from_numpy(v) for k, v in golden_train_batch().items()}
    if dtype == torch.float64:
        batch["data"] = resize_separable(batch["data"].float(), 224, 224)
    batch = {k: v.to(dev) for k, v in batch.items()}
    losses = []
    for i in range(GOLDEN_STEPS):
        state, metrics = step(state, batch, GOLDEN_LR)
        losses.append(float(metrics["loss"]))
        if i == 0:
            update = golden_sample(state.velocity)
    head = model.teacher.prediction
    return {"names": list(state.velocity),
            "losses": np.asarray(losses, np.float64),
            "update": update,
            "head_kernel": head.weight.detach().t().double().cpu().numpy()}


def leaf_errors(parts: list, flat, sizes) -> list:
    """Relative L2 error of each parameter's sample in ``parts`` against
    the golden's, ``flat`` cut at ``sizes``."""
    import numpy as np

    want = np.split(np.asarray(flat, np.float64), np.cumsum(sizes)[:-1])
    return [float(np.linalg.norm(p - w) / max(np.linalg.norm(w), 1e-300))
            for p, w in zip(parts, want)]


def train_golden_errors(got: dict, gold, tag: str) -> dict:
    """{quantity: (error, gate)} of a ``golden_train_run`` in ``tag``
    ('fp64', 'fp32' or 'bf16') against JAX's float64 run: the first loss
    (a forward) and the head after the steps (largest absolute errors), and
    each parameter's first update (relative L2; their median and largest).

    float64 and fp32 hold the forward gates of the teacher phase on the
    first loss (1e-4 relative) and the head (2e-3 x its scale). float64, on the
    host's resize, holds the update within ``F64_UPDATE_RTOL``; fp32
    within 2 x JAX's own fp32 median and largest, which also covers the
    device resize's rounding (a unit in the last place of every resized
    value moves the float64 update about as far). bf16 holds max(2 x
    JAX's own bf16 error, 1e-2 x the scale) on the first loss and the
    head, and the update within 2 x JAX's own bf16 median and largest."""
    import numpy as np

    check(list(got["names"]) == [str(n) for n in gold["names"]],
          "the golden's parameters are not the port's")
    loss = float(gold["losses_fp64"][0])
    head = gold["head_kernel_fp64"]
    rel = leaf_errors(got["update"], gold["update_fp64"], gold["update_sizes"])
    err = {"first loss": abs(float(got["losses"][0]) - loss),
           "head": float(np.abs(got["head_kernel"] - head).max()),
           "update median": float(np.median(rel)),
           "update max": max(rel)}
    if tag == "fp64":
        gate = {"update median": F64_UPDATE_RTOL, "update max": F64_UPDATE_RTOL}
    else:
        own = gold[f"update_rel_jax_{tag}"]
        gate = {"update median": 2 * float(np.median(own)),
                "update max": 2 * float(own.max())}
    if tag == "bf16":
        gate["first loss"] = max(2 * float(gold["first_loss_jax_bf16_err"]),
                                 TEACHER_BF16_RTOL * abs(loss))
        gate["head"] = max(2 * float(gold["head_kernel_jax_bf16_err"]),
                           TEACHER_BF16_RTOL * float(np.abs(head).max()))
    else:
        gate["first loss"] = GOLDEN_LOSS_RTOL * abs(loss)
        gate["head"] = TEACHER_FP32_RTOL * float(np.abs(head).max())
    return {k: (err[k], gate[k]) for k in err}


def teacher_train_phase(card: str, root: Path, wrappers: tuple,
                        dev="cuda", bn_launches: dict | None = None) -> dict:
    """The teacher's training path (phase 14): the full-width SENet50 train
    golden in float64, fp32 (TF32 off) and bf16; ``ferplus_baselines``
    with the senet50-ferplus defaults on the synthetic FER+ set, 2 epochs,
    a resume to 3, eval-only from the latest and the best epoch, the
    benchmark over its cache, the trained teacher reloaded into
    ``compute_visual_feats``; a full-width classic vgg-m-face-bn base
    ``.mat`` imported and fine-tuned; paced train-step times, images/s and
    peak memory of four teachers at batch 128 in bf16, and one profiled
    epoch's feed share, device busy share and device time by op. Returns
    the launch counts of the ferplus_baselines runs (the path launches no
    kernel of the kernel line). On the card the golden's bf16 steps run
    SENet50's 53 BatchNorms through the train-mode BatchNorm kernels
    without the ReLU (fp32 and float64 through the eager code): counted,
    and the bf16 launches added to ``bn_launches``. With ``dev="cpu"`` (a
    rehearsal on a machine without a card) the golden is left to
    ``tests/test_torch_teacher_train.py`` and the rest runs tiny."""
    import dataclasses

    import numpy as np
    import torch
    from torch.func import functional_call
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from mcncrossmodalemotions_torch.data.ferplus import (
        build_synthetic_ferplus,
        ferplus_batches,
    )
    from mcncrossmodalemotions_torch.data.images import load_frame_batch
    from mcncrossmodalemotions_torch.data.imdb import TrackImdb
    from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
        compute_visual_feats,
    )
    from mcncrossmodalemotions_torch.exp.ferplus_baselines import (
        FerPlusConfig,
        benchmark_ferplus_models,
        build_pipeline,
        ferplus_baselines,
        load_teacher_from_exp,
    )
    from mcncrossmodalemotions_torch.exp.profile_extraction import (
        DEVICE_TYPES,
        busy_us,
    )
    from mcncrossmodalemotions_torch.models import VGGFace
    from mcncrossmodalemotions_torch.ops.warp import resize_separable
    from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer
    from mcncrossmodalemotions_torch.train.state import finetune_lr_scale_fn
    from mcncrossmodalemotions_torch.zoo import (
        prepare_classic_from_base,
        teacher_loss_fn,
        teacher_state_dict_from_flax,
    )

    full = dev == "cuda"
    missed = []  # golden gates missed: the phase fails at its end
    if full:
        gold = np.load(TRAIN_GOLDEN)
        for tag, dtype in (("fp64", torch.float64), ("fp32", torch.float32),
                           ("bf16", torch.bfloat16)):
            reset_counts(TRAIN_BN_NAMES)
            got = golden_train_run(dtype, dev)
            fused = GOLDEN_STEPS * SENET50_BNS * (dtype == torch.bfloat16)
            count_train_bn(f"train golden {tag}", fused,
                           GOLDEN_STEPS * SENET50_BNS - fused, bn_launches)
            errs = train_golden_errors(got, gold, tag)
            print(f"  {card}: train golden {tag} against JAX's float64: "
                  f"losses {got['losses'].tolist()} (JAX "
                  f"{gold['losses_fp64'].tolist()}); " + ", ".join(
                      f"{k} {e:.3e} (gate {g:.3e})"
                      for k, (e, g) in errs.items()), flush=True)
            missed += [f"{tag} {k} {e:.3e} > {g:.3e}"
                       for k, (e, g) in errs.items() if not e <= g]
        # the resize that float64 took on the host, on the card
        data = torch.from_numpy(golden_train_batch()["data"]).float()
        host = resize_separable(data, 224, 224)
        diff = resize_separable(data.to(dev), 224, 224).cpu() - host
        err, scale = float(diff.abs().max()), float(host.abs().max())
        print(f"  {card}: the golden batch's resize to 224 on the card vs "
              f"the host: {int((diff != 0).sum())} of {diff.numel()} values "
              f"differ, max abs {err:.3e} (gate {RESIZE_RTOL * scale:.3e})",
              flush=True)
        if not err <= RESIZE_RTOL * scale:
            missed.append(f"resize {err:.3e}")
        torch.cuda.empty_cache()
    else:
        print("  train golden: held on the CPU by "
              "tests/test_torch_teacher_train.py")

    # ferplus_baselines with the senet50-ferplus defaults (tiny on the CPU)
    size = dict() if full else dict(batch_size=8, input_size=48,
                                    tiny_model=True)
    batch = 128 if full else 8
    imdb = build_synthetic_ferplus(num_images=FERPLUS_IMAGES if full else 40)
    cfg = FerPlusConfig(lr_epochs=(2,), out_root=str(root / "ferplus"), **size)
    exp = root / "ferplus" / cfg.exp_name()
    reset_counts(wrappers)
    t0 = time.perf_counter()
    _, first = ferplus_baselines(cfg, imdb, device=dev)
    longer = dataclasses.replace(cfg, lr_epochs=(3,))
    _, resumed = ferplus_baselines(longer, imdb, device=dev)
    train_s = time.perf_counter() - t0
    history = first + resumed
    n_train = int((imdb.set_id == 1).sum()) // batch * batch
    for h in history:
        print(f"  ferplus epoch {h['epoch']}: train loss "
              f"{h['train']['loss']:.4f} ({h['train']['num_samples']} images, "
              f"{h['train']['samples_per_sec']:.1f} images/s, feed_bound_frac "
              f"{h['train']['feed_bound_frac']}), val classerror "
              f"{h['val']['classerror']:.4f}", flush=True)
    check([h["epoch"] for h in history] == [1, 2, 3],
          f"epochs run {[h['epoch'] for h in history]}: the resume did not "
          "continue at 3 alone")
    check(all(np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])
              and h["train"]["num_samples"] == n_train for h in history),
          "ferplus epochs not finite or short")
    best = min(history, key=lambda h: h["val"]["classerror"])
    evals = {}
    for label, subset, use_best in (("val latest", "val", False),
                                    ("val best", "val", True),
                                    ("test best", "test", True)):
        _, stats = ferplus_baselines(longer, imdb, evaluate_only=subset,
                                     use_best_epoch=use_best, device=dev)
        evals[label] = stats["accuracy"]
    bench_kw = dict(out_root=str(root / "ferplus"), tiny_model=cfg.tiny_model,
                    models=(("senet50-ferplus", "distributions"),),
                    base_cfg=longer, cache_dir=str(root / "ferplus-cache"),
                    device=dev)
    table = benchmark_ferplus_models(imdb, **bench_kw)
    t0 = time.perf_counter()
    cached = benchmark_ferplus_models(imdb, **bench_kw)
    cached_s = time.perf_counter() - t0
    counts = read_counts(wrappers)
    print(f"  ferplus_baselines: 2 epochs and a resume to 3 in {train_s:.2f} s; "
          f"eval-only accuracy {evals} (last val epoch "
          f"{1 - history[-1]['val']['classerror']:.6f}, best epoch "
          f"{best['epoch']}: {1 - best['val']['classerror']:.6f}); benchmark "
          f"{table}, again from its cache in {cached_s:.3f} s; launches "
          f"{counts}", flush=True)
    check(evals["val latest"] == 1 - history[-1]["val"]["classerror"],
          "eval-only from the latest checkpoint differs from the last val epoch")
    check(evals["val best"] == 1 - best["val"]["classerror"],
          "eval-only from the best checkpoint differs from its val epoch")
    check(table == cached and table["senet50-ferplus"]["valAcc"]
          == evals["val latest"], f"benchmark {table} vs cache {cached}")
    check(not any(counts.values()),
          f"the teacher's training path launched kernels: {counts}")

    # the trained teacher, reloaded, feeds the dense path
    pipe, state = load_teacher_from_exp(exp, epoch="best", device=dev)
    faces = sorted(FACES.glob("*.jpg"))
    tracks = TrackImdb(track_ids=np.arange(2), labels=np.zeros(2),
                       set_id=np.ones(2),
                       frame_paths=[[f.name for f in faces[:6]],
                                    [f.name for f in faces[6:]]])
    feats = compute_visual_feats(tracks, pipe, state, batch_size=len(faces),
                                 frame_root=str(FACES),
                                 input_size=cfg.input_size, verbose=False,
                                 device=dev)
    x = torch.from_numpy(load_frame_batch([str(f) for f in faces],
                                          cfg.input_size, 8, 1.0)).to(dev)
    with torch.inference_mode():
        own = functional_call(pipe, state, (x,)).float().cpu().numpy()
    same = np.array_equal(np.concatenate(feats), own)
    print(f"  load_teacher_from_exp('best') -> compute_visual_feats on "
          f"{len(faces)} fixture frames: logits "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} the reloaded "
          f"teacher's own forward", flush=True)
    check(same and own.shape == (len(faces), 8) and np.isfinite(own).all(),
          "compute_visual_feats of the reloaded teacher differs from its "
          "own forward")
    del pipe, state, x

    # a full-width classic base: vgg-m-face-bn with conv biases, imported,
    # held to the bridge, fine-tuned
    input_size = 224 if full else 48
    path = root / "vgg-m-face-bn.mat"
    t0 = time.perf_counter()
    v = classic_release(path, num_outputs=2622 if full else 20,
                        input_size=input_size)
    t1 = time.perf_counter()
    model, state = prepare_classic_from_base(path, "vgg-m-face-bn",
                                             input_size=input_size,
                                             device=dev)
    sync(dev)
    t2 = time.perf_counter()
    want = teacher_state_dict_from_flax(v)  # with the imported fresh head
    want.update({k: state[k].cpu() for k in ("prediction.weight",
                                              "prediction.bias")})
    bridge = VGGFace("m", use_batchnorm=True, input_size=input_size)
    bridge.load_state_dict(want, strict=True)
    bridge.to(dev)
    xs = (torch.randn(8, input_size, input_size, 3,
                      generator=torch.Generator().manual_seed(SEED)) * 50).to(dev)
    for m in (model, bridge):
        m.dtype = torch.float32
    with torch.inference_mode():
        got, ref = (m(xs).float().cpu().numpy() for m in (model, bridge))
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    print(f"  {card}: classic vgg-m-face-bn base: .mat "
          f"({path.stat().st_size / 2**20:.1f} MiB) written in {t1 - t0:.2f} s, "
          f"imported in {t2 - t1:.2f} s; fp32 logits vs the "
          f"bridge's max abs {err:.3e} (max |logit| {scale:.4f}, gate "
          f"{CLASSIC_RTOL * scale:.3e})", flush=True)
    check(got.shape == ref.shape and np.isfinite(got).all()
          and err <= CLASSIC_RTOL * scale, "the imported classic base is off "
          "the bridge's weights")
    del model, state, bridge, xs
    ccfg = FerPlusConfig(model="vgg-m-face-bn", pretrained_mat=str(path),
                         lr_epochs=(1,), out_root=str(root / "ferplus"),
                         **dict(size, tiny_model=False))
    reset_counts(wrappers)
    _, classic = ferplus_baselines(ccfg, imdb, device=dev)
    add_counts(counts, read_counts(wrappers))
    h = classic[0]
    pipe, _ = load_teacher_from_exp(root / "ferplus" / ccfg.exp_name(),
                                    device=dev)
    print(f"  vgg-m-face-bn fine-tuned from the base: train loss "
          f"{h['train']['loss']:.4f} ({h['train']['num_samples']} images), "
          f"val classerror {h['val']['classerror']:.4f}; reloaded with the "
          f"release's mean {tuple(round(c, 4) for c in pipe.mean_rgb)}",
          flush=True)
    check(np.isfinite(h["train"]["loss"]) and h["train"]["num_samples"]
          == n_train, "the classic fine-tune did not train")
    del pipe
    if full:
        torch.cuda.empty_cache()

    # one profiled epoch (SENet50, ferplus_baselines' defaults) and paced train
    # steps of four teachers at batch 128, bf16
    big = build_synthetic_ferplus(num_images=PROFILED_IMAGES if full else 40)
    pcfg = dataclasses.replace(cfg, lr_epochs=(1,))
    trainer = Trainer(build_pipeline(pcfg), teacher_loss_fn(), TrainConfig(
        num_epochs=1, batch_size=pcfg.batch_size, learning_rate=0.01),
        device=dev, lr_scale_fn=finetune_lr_scale_fn(backbone_scale=0.1))
    tstate = trainer.init_state()
    sync(dev)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if full else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        _, stats = trainer.run_epoch(tstate, ferplus_batches(
            big, 1, pcfg.batch_size, shuffle=True, seed=1, drop_remainder=True,
            augment=True), epoch=1)
        sync(dev)
        wall = time.perf_counter() - t0
    busy = busy_us(prof.events()) / 1e6
    by_op = sorted((e for e in prof.key_averages()
                    if e.device_type in DEVICE_TYPES),
                   key=lambda e: -e.self_device_time_total)
    print(f"  {card}: profiled epoch (SENet50 bf16, {stats['num_samples']} "
          f"images in batches of {pcfg.batch_size}): {wall:.3f} s, "
          f"{stats['num_samples'] / wall:.1f} images/s, feed_bound_frac "
          f"{stats['feed_bound_frac']}, device busy {busy:.3f} s = "
          f"{busy / wall:.2%} of the wall", flush=True)
    summed = sum(e.self_device_time_total for e in by_op) / 1e6
    print(f"  profiled epoch's device time by op ({summed:.3f} s summed"
          f"{', the top 10' if by_op else '; no device events'}):", flush=True)
    for e in by_op[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    del trainer, tstate
    if full:
        torch.cuda.empty_cache()

    data = next(ferplus_batches(big, 1, batch, augment=True))
    for name in TIMED_TEACHERS:
        tcfg = dataclasses.replace(pcfg, model=name)
        trainer = Trainer(build_pipeline(tcfg), teacher_loss_fn(), TrainConfig(
            batch_size=batch), device=dev,
            lr_scale_fn=finetune_lr_scale_fn(backbone_scale=0.1))
        tstate = trainer.init_state()
        _, dev_batch = trainer._host_batch(data, pin=False)
        dev_batch = {k: t.to(dev) for k, t in dev_batch.items()}

        def train_step():
            trainer._train_step(tstate, dev_batch, 0.01)

        if full:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            times, issue, paced = paced_ms(train_step, TRAIN_TIMED,
                                           TRAIN_SLEEP_CYCLES)
            peak = torch.cuda.max_memory_allocated()
            ms = sum(times) / len(times)
            # back to back, as an epoch runs them: the wall a step, and the
            # device's busy time and kernels a step (a step whose launches
            # outrun the card's launch queue cannot be paced behind a sleep)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(TRAIN_TIMED):
                    train_step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
            busy = busy_us(prof.events()) / 1e3 / TRAIN_TIMED
            kernels = sum(e.device_type in DEVICE_TYPES
                          for e in prof.events()) / TRAIN_TIMED
            how = (f"{paced} of {len(times)} card-paced, min {min(times):.3f}, "
                   f"max {max(times):.3f} ms; the host issues one in "
                   f"{min(issue):.3f}-{max(issue):.3f} ms; back to back "
                   f"{wall:.3f} ms a step = {batch / wall * 1e3:.1f} images/s, "
                   f"device busy {busy:.3f} ms a step ({busy / wall:.2%}), "
                   f"{kernels:.0f} kernels a step; peak device memory "
                   f"{peak / 2**30:.3f} GiB")
        else:
            train_step()
            t0 = time.perf_counter()
            train_step()
            wall = ms = (time.perf_counter() - t0) * 1e3
            how = "host clock"
        with FlopCounterMode(display=False) as flop:  # one more step, counted
            train_step()
        flops = flop.get_total_flops()
        print(f"  {card}: train step {name} batch {batch} bf16: paced "
              f"{ms:.3f} ms = {batch / ms * 1e3:.1f} images/s ({how}); "
              f"{flops / 1e12:.4f} TFLOP a step (2 x multiply-adds, forward "
              f"and backward), {flops / BF16_OPS_PER_S * 1e3:.3f} ms at the "
              f"bf16 peak = {flops / BF16_OPS_PER_S * 1e3 / wall:.2%} of the "
              f"back-to-back step", flush=True)
        check(all(torch.isfinite(p).all() for p in
                  tstate.model.parameters()), f"{name}: weights not finite")
        del trainer, tstate, dev_batch
        if full:
            torch.cuda.empty_cache()
    check(not any(counts.values()),
          f"the teacher's training path launched kernels: {counts}")
    check(not missed, f"train golden gates missed: {missed}")
    return counts


def thread_cpu() -> dict:
    """CPU seconds each thread of this process has used so far, by thread
    id: (name, seconds), from /proc (empty where there is none)."""
    import os

    out = {}
    tick = os.sysconf("SC_CLK_TCK")
    for task in Path("/proc/self/task").glob("*"):
        try:
            stat = (task / "stat").read_text()
            name = (task / "comm").read_text().strip()
        except OSError:  # the thread ended meanwhile
            continue
        fields = stat[stat.rindex(")") + 2:].split()
        out[task.name] = (name, (int(fields[11]) + int(fields[12])) / tick)
    return out


def dense_tree(root: Path, wav_paths: list, frames: int) -> list:
    """A VoxCeleb-style tree over the smoke's wavs: ``wavs/spkNNN/trackNNN.wav``
    (8 speakers) and ``frames/spkNNN/trackNNN/*.jpg``, ``frames`` fixture
    JPEGs a track, cycled; links, not copies. Returns the speakers."""
    import os

    faces = sorted(FACES.glob("*.jpg"))
    speakers = set()
    for i, wav in enumerate(wav_paths):
        spk, track = f"spk{i % 8:03d}", f"track{i // 8:03d}"
        speakers.add(spk)
        (root / "wavs" / spk).mkdir(parents=True, exist_ok=True)
        os.symlink(Path(wav).resolve(), root / "wavs" / spk / f"{track}.wav")
        fdir = root / "frames" / spk / track
        fdir.mkdir(parents=True)
        for f in range(frames):
            os.symlink(faces[(i * frames + f) % len(faces)],
                       fdir / f"{f:05d}.jpg")
    return sorted(speakers)


def vgg16_golden(card: str, frames, dev, epilogue_launches: dict | None
                 ) -> None:
    """VGG-VD-16 as ``vgg-vd-face-fer`` (conv biases, no BatchNorm) with
    ``random_vggface_variables``' seeded weights in a ``FaceTeacherPipeline``
    with the vgg_face mean, on the golden's frames: the fused eval forward
    (``VGGFace.fused_forward``) in fp32 and in bf16 against the same
    weights' unfused fp32 forward (autograd on, so unfused; TF32 off), fp32
    within ``TEACHER_FP32_RTOL`` x its largest logit, bf16 within max(2 x
    the unfused bf16 forward's own error, ``TEACHER_BF16_RTOL`` x it). On
    the card, at full width, both fused forwards are also held to the JAX
    package's fp32 logits of the same weights and frames
    (``VGG16_GOLDEN``): fp32 within ``TEACHER_FP32_RTOL`` x max|golden|,
    bf16 within max(2 x JAX's own bf16 error, ``TEACHER_BF16_RTOL`` x it).
    Each fused forward's epilogue launches are held to 10 affine_relu and 5
    affine_relu_pool2x2 and added to ``epilogue_launches``. Full width on
    the card; width 1/16 on the CPU (a rehearsal, no launches, no JAX
    golden)."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.models.teacher_pipeline import (
        FaceTeacherPipeline,
    )
    from mcncrossmodalemotions_torch.zoo import (
        build_teacher,
        random_vggface_variables,
        teacher_state_dict_from_flax,
    )

    full = dev == "cuda"
    tiny = {} if full else {"width_multiplier": VD16_GOLDEN_WIDTH,
                            "fc_features": 64}
    v = random_vggface_variables(seed=SEED, arch="vd", use_batchnorm=False,
                                 **tiny)
    model = FaceTeacherPipeline(build_teacher("vgg-vd-face-fer", tiny=not full),
                                mean_rgb=(129.1863, 104.7624, 93.594),
                                augment=False)
    model.load_state_dict(teacher_state_dict_from_flax(
        {"params": {"teacher": v["params"]}}), strict=True)
    model = model.to(dev).eval()
    x = frames.to(dev)
    got = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model.teacher.dtype = dtype
        with torch.enable_grad():
            got[f"unfused {tag}"] = model(x).detach().float().cpu().numpy()
        reset_counts(EPILOGUE_NAMES)
        with torch.inference_mode():
            got[tag] = model(x).float().cpu().numpy()
        count_epilogues(f"vgg16 {tag} fused forward", "vgg16", full,
                        epilogue_launches)
    ref = got["unfused fp32"]
    scale = float(np.abs(ref).max())
    err = {k: float(np.abs(got[k] - ref).max())
           for k in ("fp32", "bf16", "unfused bf16")}
    bf16_gate = max(2 * err["unfused bf16"], TEACHER_BF16_RTOL * scale)
    print(f"  {card}: vgg16 (vgg-vd-face-fer, {'full width' if full else 'width 1/16'}"
          f"): fused forward vs the unfused fp32 one (max |logit| {scale:.4f}): "
          f"fp32 max abs {err['fp32']:.3e} (gate "
          f"{TEACHER_FP32_RTOL * scale:.3e}), bf16 {err['bf16']:.3e} (gate "
          f"{bf16_gate:.3e}; the unfused bf16 forward's own "
          f"{err['unfused bf16']:.3e}); prepared weights built "
          f"{model.teacher.prepared.builds} time(s)", flush=True)
    check(bool(np.isfinite(got["bf16"]).all()), "vgg16 logits not finite")
    check(err["fp32"] <= TEACHER_FP32_RTOL * scale,
          "vgg16 fused fp32 logits off the unfused fp32 forward")
    check(err["bf16"] <= bf16_gate,
          "vgg16 fused bf16 logits off the unfused fp32 forward")
    if full:
        check(model.teacher.prepared.builds == 2,
              "vgg16: not one build a dtype")
        jgold = np.load(VGG16_GOLDEN)
        jref = jgold["logits_vgg16_fp32"]
        jscale = float(np.abs(jref).max())
        jax_bf16 = float(np.abs(jgold["logits_vgg16_bf16"] - jref).max())
        jerr = {k: float(np.abs(got[k] - jref).max()) for k in ("fp32", "bf16")}
        jgate = max(2 * jax_bf16, TEACHER_BF16_RTOL * jscale)
        print(f"  {card}: vgg16 fused forward vs the JAX golden (max |golden| "
              f"{jscale:.4f}): fp32 max abs {jerr['fp32']:.3e} (gate "
              f"{TEACHER_FP32_RTOL * jscale:.3e}), bf16 {jerr['bf16']:.3e} "
              f"(gate {jgate:.3e}; JAX's own bf16 vs fp32 {jax_bf16:.3e})",
              flush=True)
        check(jerr["fp32"] <= TEACHER_FP32_RTOL * jscale,
              "vgg16 fused fp32 logits off the JAX golden")
        check(jerr["bf16"] <= jgate,
              "vgg16 fused bf16 logits off the JAX golden")


def teacher_phase(card: str, root: Path, wav_paths: list, wrappers: tuple,
                  dev="cuda", epilogue_launches: dict | None = None
                  ) -> tuple:
    """The teacher's serving path (phase 13): the port's JPEG decoder on
    the card's host against the golden's libjpeg frames and PIL RGB (bit
    for bit); full-width SENet50 and ResNet50 loaded from classic ``.mat``
    releases with conv biases by ``load_pretrained_teacher`` on the card,
    fp32 (TF32 off) and bf16 logits against the JAX golden; the dense
    EmoVoxCeleb build over the smoke's tracks with ``frames`` fixture
    frames each (a bounded call and its resume bitwise the one-pass
    build, which launches no kernel of the kernel line; a sample of its
    logits against the teacher's own fp32 forward on those frames),
    decode-only frames/s at 8 and ``os.cpu_count()`` threads, teacher-only
    frames/s at the card's pace, dense frames/s, the dense run's device
    busy share, device time by op and peak memory; one
    ``run_distillation`` epoch on the built imdb. The epilogue kernels'
    launches over each golden forward and over the one-pass dense build
    are held to ``teacher_epilogue_launches`` (none on the CPU, where the
    plain versions run) and added to ``epilogue_launches``.
    Returns that epoch's launch counts and the built imdb (its teacher is
    ``root / "dense.mat"``). With ``dev="cpu"`` (a rehearsal on
    a machine without a card) the golden checks run as they are and the
    dense build, its timings and the epoch at tiny sizes."""
    import os

    import numpy as np
    import torch
    from torch.func import functional_call
    from torch.profiler import ProfilerActivity, profile

    from mcncrossmodalemotions_torch.data import native_faces
    from mcncrossmodalemotions_torch.data.images import load_frame_batch
    from mcncrossmodalemotions_torch.data.imdb import SET_UNHEARD_VAL
    from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
        VisualFeatureExtractor,
    )
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        CROP_RATIO,
        build_imdb,
    )
    from mcncrossmodalemotions_torch.exp.profile_extraction import (
        DEVICE_TYPES,
        busy_us,
    )
    from mcncrossmodalemotions_torch.exp.run_distillation import (
        DistillationConfig,
        run_distillation,
    )
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    full = dev == "cuda"
    stage_sizes, width = ((3, 4, 6, 3), 64) if full else ((1, 1), 8)
    frames = DENSE_FRAMES if full else 3
    batch = TEACHER_BATCH if full else 8
    bounded = DENSE_BOUNDED if full else 16
    distill_batch = 64 if full else 4
    gold = np.load(TEACHER_GOLDEN)
    names = list(gold["names"])
    faces = [str(FACES / f"{n}.jpg") for n in names]
    check(names == sorted(p.stem for p in FACES.glob("*.jpg")),
          "the fixtures are not the golden's")
    for key, ratio in (("crop0625", CROP_RATIO), ("crop1", 1.0)):
        got = native_faces.decode_faces(faces, 224, ratio)[..., 0]
        same = np.array_equal(got, gold[f"frames_{key}"])
        print(f"  decoder: {len(faces)} fixtures at crop {ratio:.4f}, 224x224: "
              f"{'bitwise equal to' if same else 'DIFFERENT from'} the "
              f"committed libjpeg library's frames", flush=True)
        check(same, f"decoded frames differ from the golden at {key}")
    rgb_same = [np.array_equal(native_faces.decode_jpeg_rgb(f),
                               gold[f"rgb_{n}"]) for f, n in zip(faces, names)]
    print(f"  decoder: RGB bitwise equal to PIL's on {sum(rgb_same)}/"
          f"{len(faces)} fixtures")
    check(all(rgb_same), "decoded RGB differs from PIL's")

    x = torch.from_numpy(gold["frames_crop0625"][gold["logit_index"]][..., None])
    for arch, use_se in (("senet50", True), ("resnet50", False)):
        path = root / f"{arch}-release.mat"
        t0 = time.perf_counter()
        teacher_release(path, use_se=use_se)
        t1 = time.perf_counter()
        model, state = load_pretrained_teacher(path, with_pipeline=True,
                                               device=dev)
        sync(dev)
        t2 = time.perf_counter()
        ref = gold[f"logits_{arch}_fp32"]
        scale = float(np.abs(ref).max())
        jax_bf16 = float(np.abs(gold[f"logits_{arch}_bf16"] - ref).max())
        errs = {}
        for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            model.teacher.dtype = dtype
            reset_counts(EPILOGUE_NAMES)
            with torch.inference_mode():
                got = model(x.to(dev)).float().cpu().numpy()
            count_epilogues(f"{arch} {tag} forward", arch, full,
                            epilogue_launches)
            check(got.shape == ref.shape and bool(np.isfinite(got).all()),
                  f"{arch} {tag}: logits not finite {ref.shape}")
            errs[tag] = float(np.abs(got - ref).max())
        bf16_gate = max(2 * jax_bf16, TEACHER_BF16_RTOL * scale)
        print(f"  {card}: {arch}: .mat ({path.stat().st_size / 2**20:.1f} MiB) "
              f"written in {t1 - t0:.2f} s, loaded on the card in {t2 - t1:.2f} "
              f"s; logits vs the JAX golden (max |golden| {scale:.4f}): fp32 "
              f"max abs {errs['fp32']:.3e} (gate {TEACHER_FP32_RTOL * scale:.3e}),"
              f" bf16 {errs['bf16']:.3e} (gate {bf16_gate:.3e}; JAX's own bf16 "
              f"vs fp32 {jax_bf16:.3e})", flush=True)
        check(errs["fp32"] <= TEACHER_FP32_RTOL * scale,
              f"{arch} fp32 logits off the golden")
        check(errs["bf16"] <= bf16_gate, f"{arch} bf16 logits off the golden")
        del model, state
    vgg16_golden(card, x, dev, epilogue_launches)
    if dev == "cuda":
        torch.cuda.empty_cache()

    # the dense build: SENet50 in bf16 (the default), batch 128
    teacher_release(root / "dense.mat", stage_sizes=stage_sizes, width=width)
    model, state = load_pretrained_teacher(root / "dense.mat",
                                           with_pipeline=True, device=dev)
    tree = root / "vox"
    speakers = dense_tree(tree, list(wav_paths), frames)
    sets = {speakers[-1]: SET_UNHEARD_VAL}
    n_frames = len(wav_paths) * frames
    kw = dict(set_assignment=sets, batch_size=batch, verbose=False, device=dev)
    partial = str(root / "dense.partial.npz")
    reset_counts(wrappers)
    check(build_imdb(tree, model, state, partial_path=partial,
                     max_frames=bounded, **kw) is None,
          "the bounded dense call finished the job")
    done = np.load(partial)["logits"].shape[0]
    resumed = build_imdb(tree, model, state, partial_path=partial, **kw)
    sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = thread_cpu()
    reset_counts(EPILOGUE_NAMES)
    t0 = time.perf_counter()
    imdb = build_imdb(tree, model, state, **kw)
    sync(dev)
    dense_s = time.perf_counter() - t0
    after = thread_cpu()
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    forwards = -(-n_frames // batch)
    count_epilogues(f"dense build ({forwards} forwards)", "senet50", full,
                    epilogue_launches, forwards=forwards)
    print(f"  dense: the teacher's prepared weights built "
          f"{model.teacher.prepared.builds} time(s) so far", flush=True)
    launches = read_counts(wrappers)
    check(not any(launches.values()),
          f"the teacher path launched kernels of the kernel line: {launches}")
    check(len(imdb.wav_paths) == len(wav_paths)
          and all(w.shape == (frames, 8) and np.all(np.isfinite(w))
                  for w in imdb.wav_logits), "dense logits not finite [F, 8]")
    same = all(np.array_equal(a, b)
               for a, b in zip(resumed.wav_logits, imdb.wav_logits))
    print(f"  dense: {n_frames} frames ({len(wav_paths)} tracks x {frames}) in "
          f"batches of {batch} (the last {n_frames % batch or batch} padded): "
          f"bounded call stopped at {done}, its resume "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} one pass",
          flush=True)
    check(same and done == (bounded // batch) * batch,
          "the resumed dense build differs from one pass")

    # the built imdb against the same teacher's own forward on a sample of
    # its frames (the first, the padded last batch's, the last), decoded
    # apart and run at another batch size, bf16 and fp32 (TF32 off): the
    # build within twice bf16's own error on these frames of the fp32
    # forward, and at least 1e-2 x its max |logit|
    rows = [(t, f) for t, fr in enumerate(imdb.dense_frames)
            for f in range(len(fr))]
    pick = np.unique(np.linspace(0, n_frames - 1, min(DENSE_SAMPLE, n_frames))
                     .round().astype(int))
    sample = [rows[i] for i in pick]
    built = np.stack([imdb.wav_logits[t][f] for t, f in sample])
    xs = torch.from_numpy(load_frame_batch(
        [str(tree / "frames" / imdb.dense_frames[t][f]) for t, f in sample],
        224, 8, CROP_RATIO)).to(dev)
    own = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        model.teacher.dtype = dtype  # ends at bf16, the build's
        with torch.inference_mode():
            own[tag] = functional_call(model, state, (xs,)).float().cpu().numpy()
    scale = float(np.abs(own["fp32"]).max())
    own_err = float(np.abs(own["bf16"] - own["fp32"]).max())
    err = float(np.abs(built - own["fp32"]).max())
    gate = max(2 * own_err, TEACHER_BF16_RTOL * scale)
    print(f"  dense: {len(sample)} of its frames against the teacher's own "
          f"forward at batch {len(sample)}: max abs {err:.3e} of fp32 (max "
          f"|logit| {scale:.4f}, spread over frames "
          f"{float(own['fp32'].std(axis=0).mean()):.4f}; gate {gate:.3e}), "
          f"the forward's own bf16 vs fp32 {own_err:.3e}", flush=True)
    check(err <= gate, "the dense build's logits are off the teacher's own")

    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        build_imdb(tree, model, state, **kw)
        sync(dev)
        prof_s = time.perf_counter() - t0
    busy = busy_us(prof.events()) / 1e6
    by_op = sorted((e for e in prof.key_averages()
                    if e.device_type in DEVICE_TYPES),
                   key=lambda e: -e.self_device_time_total)

    used = sorted(((name, sec - before.get(tid, (name, 0.0))[1])
                   for tid, (name, sec) in after.items()), key=lambda t: -t[1])
    print(f"  dense run's host CPU: {sum(u for _, u in used):.3f} s over "
          f"{dense_s:.3f} s of wall in {len(after)} threads; the busiest: "
          + ", ".join(f"{n} {u:.3f} s" for n, u in used[:6]), flush=True)

    paths = [str(tree / "frames" / f) for t in imdb.dense_frames for f in t]
    chunks = [paths[i:i + batch] for i in range(0, len(paths), batch)]
    extractor = VisualFeatureExtractor(model, state, batch_size=batch,
                                       crop_ratio=CROP_RATIO, device=dev)
    t0 = time.perf_counter()
    extractor.frame_logits(paths, verbose=False)
    sync(dev)
    engine_s = time.perf_counter() - t0
    threads = {"default (8)": 8, f"os.cpu_count() ({os.cpu_count()})":
               os.cpu_count() or 8}
    decode = {k: [] for k in threads}
    for label in list(threads) + list(threads)[::-1]:
        t0 = time.perf_counter()
        for chunk in chunks:
            load_frame_batch(chunk, 224, threads[label], CROP_RATIO)
        decode[label].append(len(paths) / (time.perf_counter() - t0))

    xb = torch.from_numpy(load_frame_batch(paths[:batch], 224, 8,
                                           CROP_RATIO)).to(dev)

    def forward():
        with torch.inference_mode():
            return functional_call(model, state, (xb,))

    if dev == "cuda":
        times, issue, paced = paced_ms(forward, TEACHER_TIMED)
        teacher_ms = sum(times) / len(times)
        how = (f"CUDA events around each forward queued whole behind a device "
               f"sleep, {paced} of {len(times)} card-paced; min "
               f"{min(times):.3f}, max {max(times):.3f} ms; the host issues "
               f"one in {min(issue):.3f}-{max(issue):.3f} ms")
    else:
        t0 = time.perf_counter()
        forward()
        teacher_ms = (time.perf_counter() - t0) * 1e3
        how = "host clock"
    print(f"  {card}: decode-only frames/s (224x224, crop 1/1.6, batches of "
          f"{batch}, in turns): " + "; ".join(
              f"{k} threads {', '.join(f'{r:.1f}' for r in v)}"
              for k, v in decode.items()), flush=True)
    print(f"  {card}: teacher-only: {teacher_ms:.3f} ms a batch of {batch} "
          f"bf16 = {batch / teacher_ms * 1e3:.1f} frames/s ({how})")
    print(f"  {card}: dense build end to end: {n_frames} frames in "
          f"{dense_s:.3f} s = {n_frames / dense_s:.1f} frames/s (its engine, "
          f"frame_logits alone over the same frames: "
          f"{n_frames / engine_s:.1f} frames/s); profiled run "
          f"{prof_s:.3f} s, device busy {busy:.3f} s = {busy / prof_s:.2%} of "
          f"the wall ({busy / -(-n_frames // batch) * 1e3:.3f} ms a batch); "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)
    summed = sum(e.self_device_time_total for e in by_op) / 1e6
    print(f"  profiled dense run's device time by op ({summed:.3f} s summed"
          f"{', the top 10' if by_op else '; no device events'}):", flush=True)
    for e in by_op[:10]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  "
              f"{e.key[:90]}", flush=True)
    del model, state, xb

    cfg = DistillationConfig(num_epochs=1, batch_size=distill_batch,
                             mini_epoch_ratio=1.0,
                             out_root=str(root / "dense-exps"), seed=SEED,
                             tiny_model=not full)
    reset_counts(wrappers)
    _, history, _ = run_distillation(cfg, imdb, device=dev)
    counts = read_counts(wrappers)
    h = history[0]
    print(f"  run_distillation on the dense imdb: epoch 1 train loss "
          f"{h['train']['loss']:.4f} ({h['train']['num_samples']} samples), "
          f"val loss {h['val']['loss']:.4f} ({h['val']['num_samples']} "
          f"samples); launches {counts}", flush=True)
    check(h["train"]["num_samples"] > 0 and np.isfinite(h["train"]["loss"])
          and np.isfinite(h["val"]["loss"]), "no finite epoch on the dense imdb")
    if dev == "cuda":
        want = epoch_launches(wrappers,
                              h["train"]["num_samples"] // distill_batch,
                              -(-h["val"]["num_samples"] // distill_batch))
        check(counts == want, f"dense-imdb epoch launches {counts}, "
              f"expected {want}")
    return counts, imdb


def epoch_launches(wrappers: tuple, train_batches: int, val_batches: int,
                   epochs: int = 1) -> dict:
    """The kernel launches of ``epochs`` epochs of the student: a train
    step launches K1 once, K2's with-index forward and its backward twice;
    a val step K1 once and the index-free K2 twice."""
    return {k: 0 for k in wrappers} | {
        "spectrogram": epochs * (train_batches + val_batches),
        "max_pool_3x3s2": epochs * 2 * val_batches,
        "max_pool_3x3s2_idx": epochs * 2 * train_batches,
        "max_pool_3x3s2_bwd": epochs * 2 * train_batches}


def student_init(full: bool) -> tuple:
    """(a fresh student pipeline, the seeded init as its state_dict):
    full width, or the tiny width on the CPU."""
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_state_dict_from_flax,
    )

    widths = {} if full else dict(fc6=64, fc7=32)
    v = random_student_variables(seed=SEED, **widths)
    return (lambda: build_student(tiny=not full),
            student_state_dict_from_flax(
                {"params": {"net": v["params"]},
                 "batch_stats": {"net": v["batch_stats"]}}))


def online_phase(card: str, root: Path, dense_imdb, distill_imdb,
                 wrappers: tuple, dev="cuda") -> dict:
    """The whole distillation driver (phase 15): the fused online step,
    ``run_distillation(online_teacher=True)``, the feed options and the
    remat policies. Returns the launch counts of its main runs (the fused
    steps, the driver's epochs and the remat steps; not the offline step
    the fused one is held to). With ``dev="cpu"`` (a rehearsal on a
    machine without a card) everything runs tiny."""
    import dataclasses
    import os

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from mcncrossmodalemotions_torch.data.audio import write_wav
    from mcncrossmodalemotions_torch.data.emovox import (
        BatchConfig,
        EmoVoxBatcher,
    )
    from mcncrossmodalemotions_torch.exp import run_distillation as rd
    from mcncrossmodalemotions_torch.exp.profile_extraction import busy_us
    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.train.checkpoints import list_checkpoints
    from mcncrossmodalemotions_torch.train.distill import (
        make_online_distill_step,
        teacher_targets,
    )
    from mcncrossmodalemotions_torch.train.state import (
        SGDConfig,
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import (
        load_pretrained_teacher,
        student_loss_fn,
    )

    full = dev == "cuda"
    batch_size = ONLINE_BATCH if full else 4
    seconds = 4.0 if full else 1.0
    frame_size = 224 if full else 48
    warmup, timed = (WARMUP_STEPS, ONLINE_TIMED) if full else (0, 1)
    total = {k: 0 for k in wrappers}
    teacher, _ = load_pretrained_teacher(root / "dense.mat", with_pipeline=True,
                                         input_size=frame_size, device=dev)
    new_student, init = student_init(full)
    loss_fn = student_loss_fn("hot-cross-ent", temperature=2.0)
    sgd = SGDConfig(weight_decay=5e-4)

    def fresh_state():
        model = new_student()
        model.load_state_dict(init)
        return TrainState.create(model.to(dev),
                                 torch.Generator(device=dev).manual_seed(SEED))

    # (a) the fused step against the offline step on its targets
    bcfg = BatchConfig(num_seconds=seconds, batch_size=batch_size,
                       frames_per_crop=ONLINE_FRAMES, frame_size=frame_size)
    host = next(iter(EmoVoxBatcher(dense_imdb, bcfg, train=True,
                                   seed=SEED).batches(1)))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    batch["pad_mask"] = torch.ones(batch_size, device=dev)
    frames = batch["frames"]
    check(tuple(frames.shape) == (batch_size, ONLINE_FRAMES, frame_size,
                                  frame_size, 1)
          and frames.dtype == torch.uint8, f"frames {tuple(frames.shape)}")
    fused = make_online_distill_step(teacher, sgd=sgd)
    offline = make_train_step(loss_fn, sgd, pass_pad_mask=True)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the two runs comparable bitwise
    try:
        state = fresh_state()
        w0 = state.model.net.conv1.weight.detach().clone()
        reset_counts(wrappers)
        fused_losses = []
        for _ in range(ONLINE_STEPS):
            state, m = fused(state, batch, TRAIN_LR)
            fused_losses.append(m["loss"].item())
        counts = read_counts(wrappers)
        add_counts(total, counts)
        fused_state = state_copy(state)
        want = {k: 0 for k in wrappers} | {
            "spectrogram": ONLINE_STEPS, "max_pool_3x3s2_idx": 2 * ONLINE_STEPS,
            "max_pool_3x3s2_bwd": 2 * ONLINE_STEPS}
        print(f"  online: {ONLINE_STEPS} fused steps (batch {batch_size} x "
              f"{ONLINE_FRAMES} frames of {frame_size}x{frame_size}): losses "
              f"{fused_losses}; launches {counts}", flush=True)
        if full:  # CPU tensors run the plain versions, which count nothing
            check(counts == want,
                  f"fused-step launches {counts}, expected {want}")

        targets = teacher_targets(teacher, frames, 8, "max")
        offline_batch = {"data": batch["data"], "logit_target": targets,
                         "max_label": targets.argmax(dim=-1),
                         "instance_weights": torch.ones_like(targets),
                         "pad_mask": batch["pad_mask"]}
        state = fresh_state()
        offline_losses = []
        for _ in range(ONLINE_STEPS):
            state, m = offline(state, offline_batch, TRAIN_LR)
            offline_losses.append(m["loss"].item())
        offline_state = state_copy(state)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    fused_update = fused_state["net.conv1.weight"] - w0
    offline_update = offline_state["net.conv1.weight"] - w0
    rel = max(abs(a - b) / abs(b) for a, b in zip(fused_losses, offline_losses))
    upd = ((fused_update - offline_update).norm()
           / offline_update.norm()).item()
    differ = [k for k, a in offline_state.items()
              if not torch.equal(a, fused_state[k])]
    verdict = f"DIFFERS in {differ}" if differ else "bitwise equal"
    print(f"  online vs offline step on the same targets (cuDNN "
          f"deterministic): losses {offline_losses}; the state after "
          f"{ONLINE_STEPS} steps {verdict} ({len(offline_state)} tensors with "
          f"the velocity); loss max rel diff {rel:.3e}, conv1 update rel L2 "
          f"{upd:.3e}", flush=True)
    check(all(np.isfinite(fused_losses)), "non-finite fused loss")
    check(not differ, "the fused step's state differs from the offline "
          "step's on the same targets")
    del fused_state, offline_state

    flat = frames.reshape((-1,) + tuple(frames.shape[2:]))
    per_frame = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        teacher.teacher.dtype = dtype  # ends at bf16, the step's
        with torch.no_grad():
            per_frame[tag] = teacher(flat).float().reshape(
                batch_size, ONLINE_FRAMES, -1)[..., :8].amax(dim=1)
    scale = per_frame["fp32"].abs().max().item()
    own = (per_frame["bf16"] - per_frame["fp32"]).abs().max().item()
    err = (targets - per_frame["fp32"]).abs().max().item()
    same = (targets - per_frame["bf16"]).abs().max().item()
    gate = max(2 * own, TEACHER_BF16_RTOL * scale)
    print(f"  online: in-step targets vs the teacher's own fp32 forward on "
          f"the {flat.shape[0]} frames, max over each crop's frames: max abs "
          f"{err:.3e} (gate {gate:.3e}, max |target| {scale:.4f}); vs its "
          f"bf16 forward apart {same:.3e}; spread over crops "
          f"{per_frame['fp32'].std(dim=0).mean().item():.4f}", flush=True)
    check(err <= gate, "in-step teacher targets off the teacher's forward")

    times = {}
    for name, step, b in (("fused", fused, batch),
                          ("offline", offline, offline_batch)):
        state = fresh_state()
        for _ in range(warmup):
            state, _ = step(state, b, TRAIN_LR)
        sync(dev)
        if full:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(timed):
            state, _ = step(state, b, TRAIN_LR)
        sync(dev)
        times[name] = ((time.perf_counter() - t0) / timed * 1e3,
                       torch.cuda.max_memory_allocated() / 2**30 if full else 0)
        del state
    if full:
        def forward():
            with torch.no_grad():
                return teacher(flat)

        paced, issue, n_paced = paced_ms(forward, TEACHER_TIMED)
        teacher_ms = sum(paced) / len(paced)
        how = (f"CUDA events behind a device sleep, {n_paced} of "
               f"{len(paced)} card-paced, {min(paced):.3f}-{max(paced):.3f} "
               f"ms; the host issues one in {min(issue):.3f}-"
               f"{max(issue):.3f} ms")
    else:
        t0 = time.perf_counter()
        teacher_targets(teacher, frames, 8, "max")
        teacher_ms, how = (time.perf_counter() - t0) * 1e3, "host clock"
    for name, (ms, peak) in times.items():
        print(f"  {card}: {name} step at batch {batch_size}: {ms:.3f} ms = "
              f"{batch_size / ms * 1e3:.2f} utts/s (mean of {timed} "
              f"back to back after {warmup}), peak memory {peak:.3f} "
              f"GiB", flush=True)
    print(f"  {card}: teacher only (SENet50 bf16 over {flat.shape[0]} "
          f"frames): {teacher_ms:.3f} ms ({how})", flush=True)
    del fused, offline, batch, offline_batch, frames, flat
    if full:
        torch.cuda.empty_cache()

    # the online runs' imdb: the built imdb with its train tracks repeated
    # to ONLINE_EPOCH_BATCHES train batches an epoch (on the card)
    train_idx = np.flatnonzero(dense_imdb.set_id == rd.SET_TRAIN)
    reps = -(-ONLINE_EPOCH_BATCHES * batch_size // len(train_idx)) if full else 1
    online_imdb = dense_imdb.subset(np.concatenate(
        [np.tile(train_idx, reps),
         np.flatnonzero(dense_imdb.set_id != rd.SET_TRAIN)]))
    feed = {}
    for label, k in (("with frames", ONLINE_FRAMES), ("without", 0)):
        batcher = EmoVoxBatcher(dense_imdb.subset(np.tile(train_idx, reps)),
                                dataclasses.replace(bcfg, frames_per_crop=k),
                                train=True, seed=SEED)
        it, ms = iter(batcher.batches(1, drop_remainder=True)), []
        while True:
            t0 = time.perf_counter()
            if next(it, None) is None:
                break
            ms.append((time.perf_counter() - t0) * 1e3)
        feed[label] = ms[1:] or ms  # the first batch warms the reader up
    print(f"  {card}: the online batch on the host (one producer thread, as "
          f"the engine runs it; mean of an epoch's {len(feed['without'])} "
          f"batches after the first): "
          f"{sum(feed['with frames']) / len(feed['with frames']):.3f} ms "
          f"with {batch_size * ONLINE_FRAMES} frames (min "
          f"{min(feed['with frames']):.3f}, max {max(feed['with frames']):.3f}"
          f"), {sum(feed['without']) / len(feed['without']):.3f} ms without; "
          f"the fused step {times['fused'][0]:.3f} ms", flush=True)

    # (b) run_distillation(online_teacher=True): 2 epochs, then a profiled
    # third; the val pass must ship no frames
    shipped = []

    class Recording(EmoVoxBatcher):
        def batches(self, *args, **kwargs):
            for b in super().batches(*args, **kwargs):
                shipped.append((self.train, "frames" in b))
                yield b

    class Marked(rd.Trainer):
        """The train passes as a profiler span, for the busy share."""

        def run_epoch(self, state, batches, epoch, train=True):
            if not train:
                return super().run_epoch(state, batches, epoch, train)
            with record_function(ONLINE_TRAIN_SPAN):
                return super().run_epoch(state, batches, epoch, train)

    kw = dict(batch_size=batch_size, num_seconds=seconds,
              mini_epoch_ratio=1.0, mini_val=1.0, seed=SEED,
              tiny_model=not full, online_teacher=True,
              frames_per_crop=ONLINE_FRAMES, frame_size=frame_size,
              out_root=str(root / "online-exps"))
    rd_trainer = rd.Trainer
    rd.EmoVoxBatcher, rd.Trainer = Recording, Marked
    try:
        reset_counts(wrappers)
        t0 = time.perf_counter()
        _, history, exp_dir = rd.run_distillation(
            rd.DistillationConfig(num_epochs=2, **kw), online_imdb,
            device=dev, teacher_model=teacher)
        wall = time.perf_counter() - t0
        counts = read_counts(wrappers)
        add_counts(total, counts)
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if full else [])
        reset_counts(wrappers)
        with profile(activities=activities) as prof:
            _, resumed, _ = rd.run_distillation(
                rd.DistillationConfig(num_epochs=3, **kw), online_imdb,
                device=dev, teacher_model=teacher)
            sync(dev)
        resumed_counts = read_counts(wrappers)
        add_counts(total, resumed_counts)
    finally:
        rd.EmoVoxBatcher, rd.Trainer = EmoVoxBatcher, rd_trainer
    for h in history + resumed:
        tr = h["train"]
        print(f"  online run_distillation epoch {h['epoch']}: train loss "
              f"{tr['loss']:.4f} ({tr['num_samples']} samples, "
              f"{tr['samples_per_sec']:.2f} samples/s, feed_bound_frac "
              f"{tr['feed_bound_frac']}, feed_wait_s {tr['feed_wait_s']}, "
              f"device_drain_s {tr['device_drain_s']}); val loss "
              f"{h['val']['loss']:.4f} ({h['val']['num_samples']} samples)",
              flush=True)
    # the span is also on the device's timeline (a user annotation over
    # the kernels it issued): the host's span sets the window, and the
    # device's copies of it are no device work
    events = [e for e in prof.events() if e.name != ONLINE_TRAIN_SPAN]
    spans = [e.time_range for e in prof.events() if e.name == ONLINE_TRAIN_SPAN
             and e.device_type == DeviceType.CPU]
    check(len(spans) == 1, f"{len(spans)} host train spans in the profiled "
          "run")
    window = (spans[0].start, spans[0].end)
    busy = busy_us(events, window) / 1e6
    span_s = (window[1] - window[0]) / 1e6
    print(f"  {card}: online: 2 epochs in {wall:.3f} s; the profiled epoch "
          f"3's train pass {span_s:.3f} s, device busy {busy:.3f} s = "
          f"{busy / span_s:.2%}; launches over epochs 1-2 {counts}, epoch 3 "
          f"{resumed_counts}", flush=True)
    check("-online" in exp_dir.name, f"{exp_dir.name} lacks -online")
    check([h["epoch"] for h in history] == [1, 2]
          and [h["epoch"] for h in resumed] == [3], "online epochs")
    check([e for e, _ in list_checkpoints(exp_dir)] == [1, 2, 3],
          "online checkpoints 1-3 missing")
    check(all(np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])
              for h in history + resumed), "non-finite online loss")
    check({f for t, f in shipped if t} == {True}
          and {f for t, f in shipped if not t} == {False},
          f"frames shipped: {sorted(set(shipped))}")
    train_b = history[0]["train"]["num_samples"] // batch_size
    val_b = -(-history[0]["val"]["num_samples"] // batch_size)
    if full:
        check(train_b >= ONLINE_EPOCH_BATCHES,
              f"{train_b} online train batches an epoch")
        for got, epochs in ((counts, 2), (resumed_counts, 1)):
            want = epoch_launches(wrappers, train_b, val_b, epochs=epochs)
            check(got == want, f"online run launches over {epochs} "
                  f"epoch(s) {got}, expected {want}")

    # (c) the feed options, one short epoch each on the distill imdb
    noise_dir = root / "noise"
    for i in range(1, NOISE_FILES + 1):
        rng = np.random.RandomState(SEED + i)
        write_wav(noise_dir / f"{i:02d}.wav",
                  (0.2 * rng.randn(int(5.5 * 16000))).astype(np.float32),
                  16000)
    offsets = np.random.RandomState(SEED).uniform(
        0.0, 2.0, distill_imdb.num_tracks)
    kw = dict(num_epochs=1, batch_size=batch_size, num_seconds=seconds,
              mini_epoch_ratio=1.0, seed=SEED, tiny_model=not full,
              out_root=str(root / "feed-exps"))
    dirs = set()
    for label, extra, run_kw in (
            ("speed + noise corpus", dict(speed_aug=True,
                                          noise_num=NOISE_FILES,
                                          noise_dir=str(noise_dir)), {}),
            ("mu-law feed", dict(mulaw_feed=True), {}),
            ("fixedSegments", {}, dict(time_offsets=offsets))):
        reset_counts(wrappers)
        t0 = time.perf_counter()
        _, history, exp_dir = rd.run_distillation(
            rd.DistillationConfig(**kw, **extra), distill_imdb, device=dev,
            **run_kw)
        wall = time.perf_counter() - t0
        counts = read_counts(wrappers)
        add_counts(total, counts)
        h = history[0]
        train_b = h["train"]["num_samples"] // batch_size
        val_b = -(-h["val"]["num_samples"] // batch_size)
        want = epoch_launches(wrappers, train_b, val_b)
        print(f"  {label}: epoch in {wall:.3f} s, train loss "
              f"{h['train']['loss']:.4f} ({h['train']['num_samples']} "
              f"samples, feed_bound_frac {h['train']['feed_bound_frac']}), val "
              f"loss {h['val']['loss']:.4f}; {exp_dir.name}; launches "
              f"{counts}", flush=True)
        check(np.isfinite(h["train"]["loss"]) and np.isfinite(h["val"]["loss"])
              and train_b > 0, f"{label}: no finite epoch")
        check([e for e, _ in list_checkpoints(exp_dir)] == [1],
              f"{label}: checkpoint 1 missing")
        check(exp_dir not in dirs, f"{label}: shares a directory")
        dirs.add(exp_dir)
        if full:
            check(counts == want, f"{label} launches {counts}, expected {want}")
    plain_dir = Path(kw["out_root"]) / rd.DistillationConfig(**kw).exp_name()
    check(plain_dir not in dirs, "a feed option took the plain directory")
    for fmt, emit in (("int16", {}), ("mulaw8", dict(emit_mulaw=True))):
        cfg = BatchConfig(num_seconds=seconds, batch_size=batch_size, **emit)
        batcher = EmoVoxBatcher(distill_imdb, cfg, train=True, seed=SEED)
        check(batcher.uses_library(), f"{fmt} batches not read by the library")
        lib = list(batcher.batches(1))
        os.environ["MCNCME_DISABLE_NATIVE"] = "1"
        try:
            python = list(batcher.batches(1))
        finally:
            del os.environ["MCNCME_DISABLE_NATIVE"]
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(lib, python)
                   for k in b) and len(lib) == len(python)
        print(f"  {fmt} feed: {len(lib)} batches read by the library "
              f"{'bitwise equal to' if same else 'DIFFERENT from'} the Python "
              f"reads", flush=True)
        check(same, f"{fmt} library batches differ from the Python reads")

    # (d) the remat policies at the train step's shape, cuDNN deterministic
    rows, n = (TRAIN_BATCH, DEFAULT_SPEC.crop_samples(400)) if full else (
        4, DEFAULT_SPEC.crop_samples(100))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    remat_batch = {
        "data": (torch.randn(rows, n, device=dev, generator=gen)
                 * 0.1 * 32767).round().clamp(-32768, 32767).to(torch.int16),
        "logit_target": torch.randn(rows, 8, device=dev, generator=gen) * 2,
        "max_label": torch.randint(0, 8, (rows,), device=dev, generator=gen,
                                   dtype=torch.int32),
        "pad_mask": torch.ones(rows, device=dev)}
    policies = REMAT_POLICIES if full else ("drop_conv1", "dots")

    def held_gib(model, policy) -> float:
        """Memory the forward leaves to the backward: allocated after the
        loss less before the forward (0 on the CPU)."""
        sync(dev)
        before = torch.cuda.memory_allocated() if full else 0
        out = model(remat_batch["data"], train=True,
                    pad_mask=remat_batch["pad_mask"], remat_policy=policy)
        loss, _ = loss_fn(out, remat_batch)
        sync(dev)
        held = (torch.cuda.memory_allocated() - before) if full else 0
        del out, loss
        return held / 2**30

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    base = None
    try:
        for policy in (None,) + tuple(policies):
            step = make_train_step(loss_fn, SGDConfig(weight_decay=0.0),
                                   remat_policy=policy, pass_pad_mask=True)
            state = fresh_state()
            reset_counts(wrappers)
            for _ in range(ONLINE_STEPS):
                state, m = step(state, remat_batch, TRAIN_LR)
            counts = read_counts(wrappers)
            add_counts(total, counts)
            final = state_copy(state)
            if full:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            sync(dev)
            t0 = time.perf_counter()
            for _ in range(timed):
                state, _ = step(state, remat_batch, TRAIN_LR)
            sync(dev)
            ms = (time.perf_counter() - t0) / timed * 1e3
            peak = torch.cuda.max_memory_allocated() / 2**30 if full else 0.0
            held = held_gib(state.model, policy)
            r = REMAT_POOLS.get(policy, 0)
            want = {k: 0 for k in wrappers} | {
                "spectrogram": ONLINE_STEPS,
                "max_pool_3x3s2_idx": ONLINE_STEPS * (2 + r),
                "max_pool_3x3s2_bwd": 2 * ONLINE_STEPS}
            print(f"  {card}: remat {policy}: step {ms:.3f} ms at "
                  f"[{rows}, {n}] (mean of {timed}, cuDNN "
                  f"deterministic), peak memory {peak:.3f} GiB, held from "
                  f"the forward for the backward {held:.3f} GiB; launches "
                  f"over {ONLINE_STEPS} steps {counts}", flush=True)
            if full:
                check(counts == want,
                      f"remat {policy} launches {counts}, expected {want}")
            del state, step
            if policy is None:
                base = final
                continue
            diffs = {k: ((a - base[k]).abs().max().item(),
                         ((a - base[k]).norm()
                          / base[k].norm().clamp_min(1e-30)).item())
                     for k, a in final.items()
                     if a.is_floating_point() and not torch.equal(a, base[k])}
            del final
            if diffs:
                worst = max(rel for _, rel in diffs.values())
                print(f"  remat {policy}: state NOT bitwise equal to no "
                      f"policy; per tensor (max abs, rel L2): {diffs}; "
                      f"largest rel L2 {worst:.3e} (gate "
                      f"{TRAIN_UPDATE_RTOL})", flush=True)
                check(worst <= TRAIN_UPDATE_RTOL,
                      f"remat {policy} state off no policy's")
            else:
                print(f"  remat {policy}: state after {ONLINE_STEPS} steps "
                      f"bitwise equal to no policy's", flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"  online phase: launches over its main runs {total}", flush=True)
    return total


def logits_release(path: Path, imdb) -> None:
    """Write ``imdb`` (an EmoVoxImdb with dense frames) as a released-logits
    ``.mat`` in the reference schema (classic container): ``images.name``,
    ``.sp``, ``.set``, the flat ``.denseFrames`` with their 1-based
    ``.denseFramesWavIds``, and the ``wavLogits`` cell."""
    import numpy as np
    import scipy.io

    cells = np.empty(len(imdb.wav_logits), dtype=object)
    for i, l in enumerate(imdb.wav_logits):
        cells[i] = np.asarray(l, np.float32)
    frames = [str(f) for track in imdb.dense_frames for f in track]
    ids = [i + 1 for i, track in enumerate(imdb.dense_frames) for _ in track]
    images = {"name": np.asarray(list(imdb.wav_paths), dtype=object),
              "sp": np.asarray(list(imdb.speaker), dtype=object),
              "set": np.asarray(imdb.set_id, np.float64),
              "denseFrames": np.asarray(frames, dtype=object),
              "denseFramesWavIds": np.asarray(ids, np.float64)}
    scipy.io.savemat(path, {"images": images, "wavLogits": cells})


def write_release_tree(tree: Path, *, student, teacher, imdb) -> dict:
    """A release tree in the artifact registry's layout
    (``<tree>/<kind>/<filename>``): ``student(path)`` and ``teacher(path,
    use_se)`` put the student's and each FER+ teacher's ``.mat`` at their
    registry paths (write, copy or link), and the released logits are
    ``imdb``'s (``logits_release``). Returns {artifact name: path}."""
    from mcncrossmodalemotions_torch.zoo.artifacts import artifact_path

    paths = {name: artifact_path(name, tree) for name in (
        "emovoxceleb-student", "resnet50-ferplus", "senet50-ferplus",
        "emovoxceleb-logits")}
    for path in paths.values():
        path.parent.mkdir(parents=True, exist_ok=True)
    student(paths["emovoxceleb-student"])
    teacher(paths["resnet50-ferplus"], False)
    teacher(paths["senet50-ferplus"], True)
    logits_release(paths["emovoxceleb-logits"], imdb)
    return paths


def fer_csvs(root: Path, rows: int, seed: int = SEED) -> tuple:
    """FER2013 and FER+ csvs in the reference's columns (Kaggle's
    ``emotion,pixels,Usage``; FERPlus's ``Usage,Image name,<10 vote
    columns>``): ``rows`` random 48x48 faces, a third each Training,
    PublicTest (val) and PrivateTest (test), each with a clear majority
    among the 8 emotions. Returns (fer_csv, ferplus_csv)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    usages = [("Training", "PublicTest", "PrivateTest")[3 * i // rows]
              for i in range(rows)]
    fer, plus = root / "fer2013.csv", root / "fer2013new.csv"
    with open(fer, "w") as f:
        f.write("emotion,pixels,Usage\n")
        for u in usages:
            pix = " ".join(map(str, rng.randint(0, 256, 48 * 48)))
            f.write(f"0,{pix},{u}\n")
    with open(plus, "w") as f:
        f.write("Usage,Image name,neutral,happiness,surprise,sadness,anger,"
                "disgust,fear,contempt,unknown,NF\n")
        for i, u in enumerate(usages):
            votes = rng.randint(0, 3, 10)
            votes[rng.randint(0, 8)] += 7
            f.write(f"{u},fer{i:07d}.png,{','.join(map(str, votes))}\n")
    return str(fer), str(plus)


def verify_phase(card: str, root: Path, dense_imdb, wrappers: tuple,
                 student_mat: Path, teacher_mats: dict, dev="cuda") -> dict:
    """The release surface (phase 16): a release tree in the registry's
    layout, linked to the release phase's student (``student_mat``) and the
    teacher phase's SENet50 and ResNet50 (``teacher_mats``, keyed by
    registry name), with the dense imdb's logits as the released-logits
    ``.mat`` (read back bitwise); ``verify_release`` at its defaults on
    ``dev`` with a sha manifest of the tree and FER+ csvs of
    ``FERPLUS_CSV_ROWS`` rows, first against the README table (the accuracy
    gate fails: the teachers are random) and then against those measured
    numbers (PASS, every stage executed but container agreement); the
    student's probe against the same probe on the CPU; three broken trees
    that must FAIL; the CLI's exit codes in a subprocess; and
    ``cli.main(["audio-feats", ...])`` bitwise the driver. Returns the
    launch counts of the two good runs and the CLI's extraction. With
    ``dev="cpu"`` (a rehearsal without a card) the same, on the files
    given."""
    import importlib.util
    import os

    import numpy as np
    import torch

    from mcncrossmodalemotions_torch import cli
    from mcncrossmodalemotions_torch.data.imdb import (
        emovox_imdb_from_mat,
        float_tracks,
    )
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.exp.verify_release import (
        RELEASE_MODELS,
        probe_logits,
        verify_release,
    )
    from mcncrossmodalemotions_torch.zoo import (
        load_pretrained_student,
        load_pretrained_teacher,
    )
    from mcncrossmodalemotions_torch.zoo.artifacts import (
        _file_sha256,
        artifact_path,
    )

    full = dev == "cuda"
    counts = {k: 0 for k in wrappers}
    tree = root / "release-tree"
    t0 = time.perf_counter()
    paths = write_release_tree(
        tree, student=lambda p: os.link(student_mat, p),
        teacher=lambda p, use_se: os.link(
            teacher_mats["senet50-ferplus" if use_se else "resnet50-ferplus"],
            p),
        imdb=dense_imdb)
    back = emovox_imdb_from_mat(paths["emovoxceleb-logits"])
    same = (list(back.wav_paths) == list(dense_imdb.wav_paths)
            and np.array_equal(back.set_id, dense_imdb.set_id)
            and all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in
                    zip(back.wav_logits, dense_imdb.wav_logits))
            and [list(f) for f in back.dense_frames]
            == [list(f) for f in dense_imdb.dense_frames])
    print(f"  release tree: {', '.join(f'{n} {p.stat().st_size / 2**20:.1f} MiB' for n, p in paths.items())}; "
          f"the logits .mat ({len(back.wav_paths)} tracks) reads back "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} the dense "
          "imdb", flush=True)
    check(same, "the released-logits .mat does not read back to the imdb")
    manifest = root / "release-pins.json"
    manifest.write_text(json.dumps({n: _file_sha256(p)
                                    for n, p in paths.items()}))
    fer_csv, ferplus_csv = fer_csvs(root, FERPLUS_CSV_ROWS)
    print(f"  tree, manifest and FER+ csvs ({FERPLUS_CSV_ROWS} rows) written "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    def run(tag: str, **kw) -> tuple:
        kw = dict(artifact_root=str(tree), download=False,
                  out_root=str(root / f"verify-{tag}"), device=dev) | kw
        reset_counts(wrappers)
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(sys.stdout):
            report = verify_release(**kw)
        sync(dev)
        return report, read_counts(wrappers), time.perf_counter() - t0

    want = {k: 0 for k in wrappers}
    if full:  # the student's probe: one batch through the frontend
        want |= {"spectrogram": 1, "max_pool_3x3s2": 2}
    good = dict(fer_csv=fer_csv, ferplus_csv=ferplus_csv,
                sha_manifest=str(manifest))
    first, launches, wall = run("readme", **good)
    check(launches == want, f"verify launches {launches}, expected {want}")
    add_counts(counts, launches)
    measured = first["stages"]["ferplus_accuracy"].get("results", {})
    print(f"  {card}: verify-release against the README table: "
          f"{'PASS' if first['pass'] else 'FAIL'} in {wall:.2f} s, failed "
          f"{first['failed']}, measured {measured}; launches {launches}",
          flush=True)
    check(first["failed"] == ["ferplus_accuracy"]
          and sorted(measured) == sorted(m for m in RELEASE_MODELS
                                         if m != "emovoxceleb-student"),
          f"the README table's run: failed {first['failed']}")
    report, launches, wall = run("measured", expected_accuracy=measured,
                                 **good)
    check(launches == want, f"verify launches {launches}, expected {want}")
    add_counts(counts, launches)
    skip = report["stages"]["container_agreement"]
    print(f"  {card}: verify-release against the measured accuracies: "
          f"{'PASS' if report['pass'] else 'FAIL'} in {wall:.2f} s, executed "
          f"{report['executed']}; container_agreement {skip['status']}: "
          f"{skip.get('reason')} (h5py on this host: "
          f"{importlib.util.find_spec('h5py') is not None}); launches "
          f"{launches}", flush=True)
    for stage in ("artifacts", "import_forward"):
        for row in report["stages"][stage]["rows"]:
            print(f"    {stage} {row['name']}: {row['status']} "
                  + ", ".join(f"{k} {row[k]}" for k in (
                      "manifest", "logit_std", "logit_absmax") if k in row))
    check(report["pass"] and report["executed"] == [
        "artifacts", "import_forward", "released_logits",
        "ferplus_accuracy"] and report["skipped"] == ["container_agreement"],
        f"verify-release on the good tree: {report['failed']}, "
        f"{report['unverified']}")
    logits = report["stages"]["released_logits"]
    check(logits["tracks"] == len(dense_imdb.wav_paths)
          and logits["logit_absmax"] == max(
              float(np.abs(w).max()) for w in dense_imdb.wav_logits),
          f"released_logits {logits}")

    # the student's probe on the card against the same probe on the CPU
    spec = dict(probe_image_size=224, probe_wav_seconds=4.0)
    t0 = time.perf_counter()
    got = probe_logits("emovoxceleb-student", paths["emovoxceleb-student"],
                       np.random.RandomState(0), device=dev, **spec)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = probe_logits("emovoxceleb-student", paths["emovoxceleb-student"],
                       np.random.RandomState(0), device="cpu", **spec)
    cpu_s = time.perf_counter() - t0
    row = next(r for r in report["stages"]["import_forward"]["rows"]
               if r["name"] == "emovoxceleb-student")
    scale, diff = float(np.abs(ref).max()), float(np.abs(got - ref).max())
    print(f"  {card}: student probe {got.shape} (load + forward {card_s:.2f} "
          f"s on {dev}, {cpu_s:.2f} s on the CPU): max abs {diff:.3e} against "
          f"the CPU's plain versions, max |logit| {scale:.3f}, rel "
          f"{diff / scale:.3e} (gate {SLICE_REL_TOL}); std {np.std(got):.6f} "
          f"vs the report's {row['logit_std']:.6f}", flush=True)
    check(diff <= SLICE_REL_TOL * scale, "the student's probe on the card "
          "disagrees with the CPU's")
    check(abs(np.std(got) - row["logit_std"]) <= 1e-3 * row["logit_std"],
          "the report's student row is not the probe's")
    loads = {}
    for name in RELEASE_MODELS:
        load = (load_pretrained_student if name == "emovoxceleb-student"
                else load_pretrained_teacher)
        t0 = time.perf_counter()
        model, _ = load(paths[name], download=False, device=dev)
        sync(dev)
        loads[name] = time.perf_counter() - t0
        del model
    print(f"  {card}: load on {dev} (s): " + ", ".join(
        f"{n} {v:.2f}" for n, v in loads.items()), flush=True)

    # broken trees
    broken = root / "broken-tree"
    zeroed = artifact_path("emovoxceleb-student", broken)
    zeroed.parent.mkdir(parents=True)
    student_release(zeroed, fc6=4096 if full else 64,
                    fc7=1024 if full else 32, zeroed=True)
    report, _, _ = run("zeroed", artifact_root=str(broken),
                       models=("emovoxceleb-student",),
                       check_logits_imdb=False)
    row = report["stages"]["import_forward"]["rows"][0]
    print(f"  zeroed student: {'PASS' if report['pass'] else 'FAIL'}, failed "
          f"{report['failed']}: {row.get('error')}", flush=True)
    check(not report["pass"] and report["failed"] == ["import_forward"]
          and "constant" in row.get("error", ""), "a zeroed student passed")
    logits_path = paths["emovoxceleb-logits"]
    blob = bytearray(logits_path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    logits_path.write_bytes(bytes(blob))
    report, _, _ = run("flipped", models=())
    row = report["stages"]["artifacts"]["rows"][0]
    print(f"  one flipped byte in the pinned logits: "
          f"{'PASS' if report['pass'] else 'FAIL'}, failed {report['failed']}, "
          f"{row['name']} {row['status']}", flush=True)
    check(not report["pass"] and report["failed"] == ["artifacts"]
          and row["status"] == "corrupt", "a flipped byte passed")
    blob[len(blob) // 2] ^= 0xFF
    logits_path.write_bytes(bytes(blob))
    bad_pins = root / "bad-pins.json"
    bad_pins.write_text(json.dumps({"emovoxceleb-student": "0" * 64}))
    report, _, _ = run("bad-pin", models=("emovoxceleb-student",),
                       check_logits_imdb=False, sha_manifest=str(bad_pins))
    row = report["stages"]["artifacts"]["rows"][0]
    print(f"  a manifest pin that does not match: "
          f"{'PASS' if report['pass'] else 'FAIL'}, failed {report['failed']}, "
          f"{row['status']}", flush=True)
    check(not report["pass"] and row["status"] == "corrupt"
          and "manifest" in row["error"], "a wrong manifest pin passed")

    # the CLI: exit codes in a subprocess, audio-feats in this process
    for tag, extra, code in (
            ("good", [], 0),
            ("bad", ["models=emovoxceleb-student", "check_logits_imdb=false",
                     f"sha_manifest={bad_pins}"], 1)):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mcncrossmodalemotions_torch.cli",
             "verify-release", f"root={tree}", "download=false",
             f"out_root={root / f'verify-cli-{tag}'}", f"device={dev}",
             *extra], cwd=ROOT, capture_output=True, text=True, timeout=600)
        verdict = [l for l in proc.stdout.splitlines()
                   if l.startswith("verify-release:")]
        print(f"  python -m mcncrossmodalemotions_torch.cli verify-release "
              f"({tag} tree): exit {proc.returncode} in "
              f"{time.perf_counter() - t0:.2f} s: {verdict}", flush=True)
        check(proc.returncode == code, f"the CLI on the {tag} tree exited "
              f"{proc.returncode}: {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    feats = root / "cli-feats.npz"
    reset_counts(wrappers)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(sys.stdout):
        rc = cli.main(["audio-feats", f"imdb={paths['emovoxceleb-logits']}",
                       f"root={Path(dense_imdb.wav_dir).parent}",
                       f"model={paths['emovoxceleb-student']}",
                       f"feats={feats}", f"batch_size={BATCH}",
                       f"device={dev}"])
    sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counts(wrappers)
    check(rc == 0, f"cli audio-feats exited {rc}")
    if full:
        want = extraction_launches(wrappers, dense_imdb)
        check(launches == want, f"cli audio-feats launches {launches}, "
              f"expected {want}")
    add_counts(counts, launches)
    got = float_tracks(np.load(feats, allow_pickle=True)["logits"])
    model, state = load_pretrained_student(paths["emovoxceleb-student"],
                                           with_frontend=False, device=dev)
    ref = compute_audio_feats(dense_imdb, model, state, batch_size=BATCH,
                              verbose=False, device=dev)
    same = len(got) == len(ref) == len(dense_imdb.wav_paths) and all(
        np.array_equal(a, b) for a, b in zip(got, ref))
    print(f"  {card}: cli audio-feats over the released logits' "
          f"{len(got)} tracks in {wall:.2f} s, launches {launches}: logits "
          f"{'bitwise equal to' if same else 'DIFFERENT from'} "
          "compute_audio_feats", flush=True)
    check(same, "cli audio-feats differs from compute_audio_feats")
    del model, state
    if full:
        torch.cuda.empty_cache()
    return counts


def ddp_batches(full: bool) -> list:
    """The ddp phase's student batches, made on the host from ``SEED`` as
    every rank makes them: ``DDP_STEPS`` full batches of int16 4 s crops
    (``TRAIN_BATCH`` rows; 4 rows of 1 s on the CPU) and a ragged one of
    one row fewer."""
    import numpy as np

    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC

    rows = TRAIN_BATCH if full else 4
    n = DEFAULT_SPEC.crop_samples(400 if full else 100)
    rng = np.random.RandomState(SEED)
    out = []
    for b in [rows] * DDP_STEPS + [rows - 1]:
        target = (rng.randn(b, 8) * 2).astype(np.float32)
        wav = (rng.randn(b, n) * 0.1 * 32767).round().clip(-32768, 32767)
        out.append({"data": wav.astype(np.int16), "logit_target": target,
                    "max_label": target.argmax(-1).astype(np.int32)})
    return out


def ddp_online_batches(full: bool) -> list:
    """The online steps' batches: ``ONLINE_BATCH`` crops with
    ``ONLINE_FRAMES`` uint8 face frames of 224x224 each (4 crops, 48x48
    frames on the CPU), from ``SEED + 1``."""
    import numpy as np

    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC

    rows, size = (ONLINE_BATCH, 224) if full else (4, 48)
    n = DEFAULT_SPEC.crop_samples(400 if full else 100)
    rng = np.random.RandomState(SEED + 1)
    return [{"data": (rng.randn(rows, n) * 3000).astype(np.int16),
             "frames": rng.randint(0, 256, (rows, ONLINE_FRAMES, size, size,
                                            1), np.uint8)}
            for _ in range(DDP_ONLINE_STEPS)]


def state_digest(state) -> str:
    """sha256 of a train state's weights, running statistics and velocity,
    bit for bit."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for t in (list(state.model.state_dict().values())
              + list(state.velocity.values())):
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def ddp_steps(trainer, state, batches, dev, wrappers) -> dict:
    """``Trainer.run_epoch`` over one batch at a time: the losses (the
    global batch's), the state's digest after each step, each step's wall
    ms (synchronised), the launches and the peak memory."""
    import torch

    losses, digests, ms = [], [], []
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(wrappers)
    for b in batches:
        sync(dev)
        t0 = time.perf_counter()
        state, stats = trainer.run_epoch(state, [b], epoch=1)
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(stats["loss"])
        digests.append(state_digest(state))
    counts = read_counts(wrappers)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if torch.device(dev).type == "cuda" else 0.0)
    return dict(losses=losses, digests=digests, ms=ms, counts=counts,
                peak_gib=peak)


def ddp_student_run(dev, wrappers: tuple, mesh=None, steps=None) -> dict:
    """The full-width student (the tiny one on the CPU) from the seeded
    init, hot-cross-ent at T=2, weight decay 0, ``TRAIN_LR``, through
    ``Trainer`` over ``ddp_batches`` (the first ``steps``): one process
    without ``mesh``, else this rank's shard of each batch."""
    import torch

    from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer
    from mcncrossmodalemotions_torch.zoo import student_loss_fn

    full = torch.device(dev).type == "cuda"
    new_student, init = student_init(full)
    model = new_student()
    model.load_state_dict(init)
    trainer = Trainer(model, student_loss_fn("hot-cross-ent", temperature=2.0),
                      TrainConfig(learning_rate=TRAIN_LR, weight_decay=0.0,
                                  log_every=1000, resume=False),
                      device=dev, mesh=mesh)
    return ddp_steps(trainer, trainer.init_state(scratch=False),
                     ddp_batches(full)[:steps], dev, wrappers)


def ddp_online_run(root: Path, dev, wrappers: tuple, mesh) -> dict:
    """The fused online step (the teacher phase's SENet50 ``dense.mat`` in
    bf16, frozen, scoring this rank's frames) through ``Trainer`` over
    ``ddp_online_batches``."""
    import torch

    from mcncrossmodalemotions_torch.train.distill import (
        make_online_distill_step,
    )
    from mcncrossmodalemotions_torch.train.engine import TrainConfig, Trainer
    from mcncrossmodalemotions_torch.train.state import SGDConfig
    from mcncrossmodalemotions_torch.zoo import (
        load_pretrained_teacher,
        student_loss_fn,
    )

    full = torch.device(dev).type == "cuda"
    teacher, _ = load_pretrained_teacher(root / "dense.mat", with_pipeline=True,
                                         input_size=224 if full else 48,
                                         device=dev)
    step = make_online_distill_step(teacher, sgd=SGDConfig(weight_decay=5e-4),
                                    mesh=mesh)
    new_student, init = student_init(full)
    model = new_student()
    model.load_state_dict(init)
    trainer = Trainer(model, student_loss_fn(),
                      TrainConfig(learning_rate=TRAIN_LR, log_every=1000,
                                  resume=False),
                      device=dev, train_step_override=step, mesh=mesh)
    return ddp_steps(trainer, trainer.init_state(scratch=False),
                     ddp_online_batches(full), dev, wrappers)


def ddp_worker(argv: list) -> int:
    """One rank of the ddp phase (``chip_smoke.py --ddp-worker <rank>
    <world> <port> <out.json> <root> <device> <backend>``): joins the
    group on ``127.0.0.1:<port>``, runs the student steps and, with two
    ranks, the online steps and the dense build, and writes what it saw
    to ``out.json`` (rank 0 the dense logits beside it)."""
    import faulthandler
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb,
    )
    from mcncrossmodalemotions_torch.parallel.mesh import (
        initialize_multihost,
        make_mesh,
    )
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    rank, world, port = (int(a) for a in argv[:3])
    out, root, dev, backend = Path(argv[3]), Path(argv[4]), argv[5], argv[6]
    faulthandler.dump_traceback_later(DDP_TIMEOUT, exit=True)
    full = torch.device(dev).type == "cuda"
    if full:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(2)
    address = f"127.0.0.1:{port}"
    if world == 1:  # initialize_multihost joins no group for one process
        if backend == "nccl":
            torch.cuda.set_device(torch.device(dev))
        dist.init_process_group(backend, init_method=f"tcp://{address}",
                                world_size=1, rank=0)
    else:
        initialize_multihost(address, world, rank, backend=backend)
    mesh = make_mesh(world, device=dev)
    wrappers = KERNEL_NAMES
    result = {"rank": rank, "backend": dist.get_backend(),
              "student": ddp_student_run(dev, wrappers, mesh,
                                         steps=1 if world == 1 else None)}
    if world > 1:
        result["online"] = ddp_online_run(root, dev, wrappers, mesh)
        model, state = load_pretrained_teacher(root / "dense.mat",
                                               with_pipeline=True, device=dev)
        reset_counts(wrappers)
        t0 = time.perf_counter()
        imdb = build_imdb(root / "vox", model, state, verbose=False,
                          batch_size=TEACHER_BATCH if full else 8, mesh=mesh)
        sync(dev)
        logits = np.concatenate(imdb.wav_logits)
        result["dense"] = {"s": time.perf_counter() - t0,
                           "frames": int(logits.shape[0]),
                           "counts": read_counts(wrappers),
                           "digest": hashlib.sha256(logits.tobytes())
                           .hexdigest()}
        if rank == 0:
            np.save(out.with_suffix(".npy"), logits)
    out.write_text(json.dumps(result))
    dist.destroy_process_group()
    return 0


def spawn_ranks(root: Path, world: int, dev: str, backend: str) -> list:
    """Run ``world`` ddp workers (this script, ``--ddp-worker``) to their
    end through the port's rank spawner (``graft_entry.spawn_ranks``: a
    new port only after a failure that says the port was taken) and return
    their results. A failing rank, with its standard error, or a timeout
    fails the phase."""
    from mcncrossmodalemotions_torch.graft_entry import spawn_ranks as spawn

    outs = [root / f"ddp-{backend}-{world}-{r}.json" for r in range(world)]

    def command(rank: int, port: int) -> list:
        return [sys.executable, str(ROOT / "chip_smoke.py"), "--ddp-worker",
                str(rank), str(world), str(port), str(outs[rank]), str(root),
                dev, backend]

    try:
        spawn(command, world, root, timeout=DDP_TIMEOUT + 60)
    except (RuntimeError, TimeoutError) as exc:
        raise SmokeFailure(f"a ddp worker ({backend}, {world} rank(s)) "
                           f"failed: {exc}") from exc
    return [json.loads(o.read_text()) for o in outs]


def ddp_phase(card: str, root: Path, dense_imdb, wrappers: tuple,
              dev="cuda") -> dict:
    """Data parallelism through ``torch.distributed`` (phase 17): the same
    work in one process and in two ranks on the one card over gloo (NCCL
    refuses two ranks on one device), each rank started as this script
    with ``--ddp-worker`` (the parent already holds a CUDA context, which
    a fork cannot carry). (a) The full-width student, int16 [128, 64384],
    hot-cross-ent at T=2, bf16, kernels on, through ``Trainer``: 3 steps
    at 64 rows a rank, then a ragged batch of 127 rows padded to 128; the
    ranks' states bitwise equal after every step, the global losses within
    ``TRAIN_LOSS_RTOL`` of the one-process run on the card, each rank
    launching K1 once and K2's with-index forward and backward twice a
    step; (b) the online step, SENet50 bf16, batch 64 x 4 frames (32 a
    rank), 2 steps, the ranks bitwise equal and launching as the student;
    (c) the dense build over the teacher phase's frames on 2 ranks: every
    rank holds all logits, bitwise the other's, within the teacher gate's
    floor (``TEACHER_BF16_RTOL`` x max|logit|) of the one-process build;
    (d) one student step in a 1-rank NCCL group, its loss within
    ``TRAIN_LOSS_RTOL`` of the one-process first step. Prints each rank's
    step ms and peak memory beside one process's. Returns the launches of
    every rank's runs. With ``dev="cpu"`` (a rehearsal without a card) the
    same at tiny sizes over gloo."""
    import numpy as np
    import torch

    full = dev == "cuda"
    rank_dev = "cuda:0" if full else "cpu"
    rows = len(ddp_batches(full)[0]["data"])
    one = ddp_student_run(dev, wrappers)
    if full:
        torch.cuda.empty_cache()  # the ranks share the card
    t0 = time.perf_counter()
    ranks = spawn_ranks(root, DDP_RANKS, rank_dev, "gloo")
    ranks_s = time.perf_counter() - t0
    nccl = spawn_ranks(root, 1, rank_dev, "nccl" if full else "gloo")[0]
    check([r["rank"] for r in ranks] == list(range(DDP_RANKS))
          and all(r["backend"] == "gloo" for r in ranks)
          and nccl["backend"] == ("nccl" if full else "gloo"),
          f"ddp groups: {[r['backend'] for r in ranks]}, {nccl['backend']}")

    def per_step(name: str, want: dict, steps: int) -> None:
        for r in ranks:
            got = r[name]["counts"]
            print(f"  ddp {name} rank {r['rank']}: launches {got}")
            if full:  # CPU tensors run the plain versions
                check(got == {k: steps * v for k, v in want.items()},
                      f"ddp {name} rank {r['rank']} launches {got}")
        digests = [r[name]["digests"] for r in ranks]
        check(len(digests[0]) == steps and all(d == digests[0]
                                               for d in digests),
              f"ddp {name}: the ranks' states differ")

    step_launches = {k: 0 for k in wrappers} | {
        "spectrogram": 1, "max_pool_3x3s2_idx": 2, "max_pool_3x3s2_bwd": 2}
    steps = DDP_STEPS + 1
    per_step("student", step_launches, steps)
    per_step("online", step_launches, DDP_ONLINE_STEPS)
    got = ranks[0]["student"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, one["losses"]))
    print(f"  ddp student: global losses {got}, one process {one['losses']}: "
          f"max rel diff {rel:.3e} (gate {TRAIN_LOSS_RTOL}); states bitwise "
          f"equal on the {DDP_RANKS} ranks after each of {steps} steps")
    check(all(np.isfinite(got)) and rel <= TRAIN_LOSS_RTOL,
          "ddp student losses off the one-process run")
    print(f"  ddp online: losses {ranks[0]['online']['losses']}, states "
          f"bitwise equal on the {DDP_RANKS} ranks after each of "
          f"{DDP_ONLINE_STEPS} steps")
    check(all(np.isfinite(ranks[0]["online"]["losses"])),
          "ddp online loss not finite")
    for r in ranks:
        s = r["student"]
        print(f"  {card}: ddp rank {r['rank']} of {DDP_RANKS} on one card "
              f"(gloo), {rows // DDP_RANKS} rows: student step ms "
              f"{[round(v, 3) for v in s['ms']]} (the last the ragged "
              f"batch), mean of steps 2-{DDP_STEPS} "
              f"{np.mean(s['ms'][1:DDP_STEPS]):.3f} ms, peak "
              f"{s['peak_gib']:.3f} GiB; online step ms "
              f"{[round(v, 3) for v in r['online']['ms']]}, peak "
              f"{r['online']['peak_gib']:.3f} GiB", flush=True)
    print(f"  {card}: one process, {rows} rows: student step ms "
          f"{[round(v, 3) for v in one['ms']]}, mean of steps 2-{DDP_STEPS} "
          f"{np.mean(one['ms'][1:DDP_STEPS]):.3f} ms, peak "
          f"{one['peak_gib']:.3f} GiB; the two ranks' processes "
          f"{ranks_s:.2f} s end to end", flush=True)

    dense = [r["dense"] for r in ranks]
    want = np.concatenate(dense_imdb.wav_logits)
    logits = np.load(root / f"ddp-gloo-{DDP_RANKS}-0.npy")
    scale = float(np.abs(want).max())
    err = float(np.abs(logits - want).max())
    print(f"  ddp dense: {dense[0]['frames']} frames in {dense[0]['s']:.3f} s "
          f"on rank 0; logits vs the one-process build: max abs {err:.3e} "
          f"(gate {TEACHER_BF16_RTOL * scale:.3e}); launches "
          f"{[d['counts'] for d in dense]}", flush=True)
    check(logits.shape == want.shape and err <= TEACHER_BF16_RTOL * scale,
          "ddp dense logits off the one-process build")
    check(all(d["digest"] == dense[0]["digest"] for d in dense),
          "ddp dense: the ranks' logits differ")
    check(not any(v for d in dense for v in d["counts"].values()),
          "the dense build launched kernels of the kernel line")

    s = nccl["student"]
    rel = abs(s["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
    print(f"  ddp {nccl['backend']}: one step in a 1-rank group, loss "
          f"{s['losses'][0]} vs one process {one['losses'][0]} (rel "
          f"{rel:.3e}); launches {s['counts']}; step {s['ms'][0]:.3f} ms",
          flush=True)
    check(rel <= TRAIN_LOSS_RTOL, "the NCCL step's loss is off")
    if full:
        check(s["counts"] == step_launches, f"NCCL launches {s['counts']}")
    total = {k: 0 for k in wrappers}
    for counts in [r[n]["counts"] for r in ranks for n in ("student", "online")
                   ] + [s["counts"]]:
        add_counts(total, counts)
    return total


def dense_chunked_phase(card: str, root: Path, dense_imdb, wrappers: tuple,
                        dev="cuda") -> dict:
    """The bounded-worker dense build and the dense-genesis soak (phase
    18). (a) ``build_imdb`` over the teacher phase's tree and teacher
    (``dense.mat``, SENet50 bf16, batch 128) with
    ``max_frames_per_process=512``: this process loads the teacher on the
    host and supervises, 4 worker processes score at most 512 frames each
    on the card over the partial; ``wav_logits`` and sets bitwise the
    teacher phase's one-process imdb, the partial and the job directory
    gone; each cycle's seconds and the build's frames/s beside a
    one-process build timed here (which launches no kernel of the line).
    (b) The soak (``tools/soak_dense_genesis.orchestrate``) at 32,768
    frames: the clean build with its RSS, the build killed at its first
    partial flush, and its resume bitwise the clean build. Returns the
    one-process build's launches. With ``dev="cpu"`` (a rehearsal without
    a card) the same at tiny sizes."""
    import io
    import re

    import numpy as np
    import torch

    from mcncrossmodalemotions_torch.exp.dense_chunked import worker_frames
    from mcncrossmodalemotions_torch.exp.fetch_emovoxceleb_imdb import (
        build_imdb,
    )
    from mcncrossmodalemotions_torch.tools import soak_dense_genesis as soak
    from mcncrossmodalemotions_torch.zoo import load_pretrained_teacher

    full = dev == "cuda"
    batch = TEACHER_BATCH if full else 8
    chunk = CHUNK_FRAMES if full else 16
    tree, mat = root / "vox", root / "dense.mat"
    n = sum(len(f) for f in dense_imdb.dense_frames)
    kw = dict(set_assignment=dict(zip(dense_imdb.speaker,
                                      dense_imdb.set_id.tolist())),
              batch_size=batch, device=dev)

    model, state = load_pretrained_teacher(mat, with_pipeline=True, device=dev)
    build_imdb(tree, model, state, verbose=False, **kw)  # warm
    sync(dev)
    reset_counts(wrappers)
    t0 = time.perf_counter()
    build_imdb(tree, model, state, verbose=False, **kw)
    sync(dev)
    one_s = time.perf_counter() - t0
    counts = read_counts(wrappers)
    check(not any(counts.values()),
          f"the dense build launched kernels of the kernel line: {counts}")
    del model, state
    if full:
        torch.cuda.empty_cache()  # the workers take the card

    model, state = load_pretrained_teacher(mat, with_pipeline=True,
                                           device="cpu")
    partial = root / "chunked.partial.npz"
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        imdb = build_imdb(tree, model, state, partial_path=str(partial),
                          max_frames_per_process=chunk,
                          teacher_spec={"pretrained": str(mat)},
                          verbose=True, **kw)
    chunked_s = time.perf_counter() - t0
    cycles = [(int(m[1]), float(m[2])) for m in re.finditer(
        r"\[dense-chunked\] cycle \d+: (\d+)/\d+ frames, ([0-9.]+) s",
        log.getvalue())]
    per = worker_frames(chunk, batch)
    print(f"  dense-chunked: {n} frames, workers of at most {per}: cycles "
          f"(frames done, s) {cycles}", flush=True)
    check(len(cycles) == -(-n // per) and cycles[-1][0] == n,
          f"dense-chunked took {len(cycles)} worker cycles, expected "
          f"{-(-n // per)}")
    same = (len(imdb.wav_logits) == len(dense_imdb.wav_logits)
            and all(np.array_equal(a, b) for a, b in
                    zip(imdb.wav_logits, dense_imdb.wav_logits))
            and np.array_equal(imdb.set_id, dense_imdb.set_id))
    print(f"  {card}: bounded-worker dense build: {len(cycles)} workers, "
          f"{chunked_s:.3f} s = {n / chunked_s:.1f} frames/s end to end "
          f"(workers' seconds {[round(s, 3) for _, s in cycles]}), against "
          f"one process's {one_s:.3f} s = {n / one_s:.1f} frames/s; "
          f"wav_logits {'bitwise equal to' if same else 'DIFFERENT from'} "
          f"the teacher phase's one-process build", flush=True)
    check(same, "the bounded-worker dense build differs from one process's")
    check(not partial.exists() and not partial.with_suffix(".job").exists(),
          "the bounded-worker build left its partial or job directory")
    del model, state

    frames = SOAK_FRAMES if full else SOAK_CPU_FRAMES
    report = soak.orchestrate(frames, root / "soak",
                              batch_size=batch if full else 1, tiny=not full)
    clean = report["clean"]

    def mb(x):
        return "n/a" if x is None else f"{x:.1f}"

    growth = clean["rss_growth_per_batch_mb"]
    print(f"  {card}: soak ({report['device']}): {report['num_frames']} frames "
          f"of 96x96, batch {report['batch_size']}: clean build "
          f"{clean['build_sec']:.3f} s = {clean['imgs_per_sec']:.1f} frames/s "
          f"(set-up {clean['init_sec']:.3f} s); RSS at warm "
          f"{mb(clean['rss_warm_mb'])} MB, growth after it "
          f"{mb(clean['rss_growth_after_warm_mb'])} MB = "
          f"{'n/a' if growth is None else f'{growth:.4f}'} MB a batch, peak "
          f"{mb(clean['rss_max_mb'])} MB, trace (s, MB) "
          f"{clean['rss_trace_mb']}; killed at {report['killed_at_frames']} "
          f"frames; the resume scored the other "
          f"{report['num_frames'] - report['killed_at_frames']} at "
          f"{report['resume']['imgs_per_sec']:.1f} frames/s; "
          f"resume vs clean max abs diff "
          f"{report['resume_vs_clean_max_abs_diff']}", flush=True)
    check(report.get("pass") is True, "the soak did not pass")
    return counts


def bench_phase(card: str, root: Path) -> float:
    """The port's throughput bench (phase 19): ``python -m
    mcncrossmodalemotions_torch.bench --full --out-dir <tmp>`` in a fresh
    process (its end-to-end and numerics workers are processes of their
    own), with the card free. It must exit 0, print the headline with a
    value above 0 last, and write every key of ``BENCH_KEYS`` with
    ``numerics_ok`` true; each value is printed with the card's name and
    power limit. Its launches happen in its processes, not in this one's
    counts. Returns its headline ``train_step_ms``."""
    out_dir = root / "bench"
    log = root / "bench.log"
    t0 = time.perf_counter()
    with open(log, "w") as f:
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "mcncrossmodalemotions_torch.bench",
                 "--full", "--out-dir", str(out_dir)], cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT, timeout=BENCH_TIMEOUT)
        except subprocess.TimeoutExpired:
            raise SmokeFailure(f"the bench took over {BENCH_TIMEOUT} s")
    wall = time.perf_counter() - t0
    text = log.read_text()
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        print(text[-6000:], flush=True)
    check(proc.returncode == 0, f"the bench exited {proc.returncode}")
    headline = json.loads(lines[-1])
    print(f"  {card}: bench --full in {wall:.1f} s; headline {headline}",
          flush=True)
    check(headline.get("metric") == "distillation_train_throughput"
          and headline.get("value", 0) > 0, f"bench headline {headline}")
    details = json.loads((out_dir / "bench_details.json").read_text())
    keys = BENCH_KEYS
    for key in keys:
        print(f"  {card}: bench {key} = {details.get(key, 'MISSING')}")
    missing = [k for k in keys if k not in details]
    check(not missing, f"the bench's details lack {missing}")
    check(details["numerics_ok"] is True,
          f"bench numerics_ok {details['numerics_ok']}")
    return details["train_step_ms"]


def demo_phase(card: str, root: Path, wrappers: tuple, dev="cuda",
               speakers: int = 8, tracks: int = 25, tiny: bool = False,
               checked_chunks=None) -> dict:
    """The convergence demo (``tools/run_demo.main``, phase 20) at full
    width for ``DEMO_EPOCHS`` of its 40 epochs over its imdb of
    ``speakers`` x ``tracks``: the last epoch's train loss below the
    first's, ``student_stats`` over the three partitions, and the exact
    launches of its epochs and its extraction, which it returns. Its
    extraction's chunks must be ``checked_chunks`` (where given), those
    the k1 and k2 phases held against the plain versions. With
    ``dev="cpu"`` (a rehearsal) ``tiny`` and a smaller imdb may be given;
    nothing launches there."""
    from mcncrossmodalemotions_torch.tools import run_demo

    work = root / "demo"
    reset_counts(wrappers)
    out = run_demo.main(work, device=dev, num_epochs=DEMO_EPOCHS,
                        num_speakers=speakers, tracks_per_speaker=tracks,
                        tiny=tiny)
    counts = read_counts(wrappers)
    traj = {t["epoch"]: t for t in out["trajectory"]}
    print(f"  {card}: demo, {DEMO_EPOCHS} epochs in {out['wall_s']} s: "
          f"trajectory {out['trajectory']}; meanAuc "
          f"{ {p: a['meanAuc'] for p, a in out['aucs'].items()} }; launches "
          f"{counts}", flush=True)
    check(sorted(traj) == [1, DEMO_EPOCHS], f"demo epochs {sorted(traj)}")
    check(traj[DEMO_EPOCHS]["train_loss"] < traj[1]["train_loss"],
          "the demo's train loss did not fall")
    check(set(out["aucs"]) == {"train", "heardVal", "unheardVal"},
          f"student_stats partitions {sorted(out['aucs'])}")
    # the last speaker is unheard, each other one's last track heard-val,
    # the rest train (whole batches only); val batches may be ragged
    chunks = extraction_chunks(sorted((work / "wavs").rglob("*.wav")))
    check(checked_chunks is None or chunks == checked_chunks,
          f"demo chunks {chunks}, checked {checked_chunks}")
    want = {k: 0 for k in wrappers}
    if dev == "cuda":
        want = epoch_launches(
            wrappers, (speakers - 1) * (tracks - 1) // DEMO_BATCH,
            -(-(speakers - 1 + tracks) // DEMO_BATCH), epochs=DEMO_EPOCHS)
        want["spectrogram"] += len(chunks)
        want["max_pool_3x3s2"] += 2 * len(chunks)
    check(counts == want, f"demo launches {counts}, expected {want}")
    return counts


def run_study(module: str, args: list, dev="cuda") -> dict:
    """One study of ``mcncrossmodalemotions_torch.tools`` in a fresh
    process (its command line takes one form a process), ``STUDY_ITERS``
    calls a timed window; it must exit 0. Returns its last line's JSON
    record."""
    cmd = [sys.executable, "-m", f"mcncrossmodalemotions_torch.tools.{module}",
           *args, "--iters", str(STUDY_ITERS)]
    if dev != "cuda":
        cmd += ["--device", dev]
    try:
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=STUDY_TIMEOUT)
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"{module} {args} took over {STUDY_TIMEOUT} s")
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
    check(proc.returncode == 0, f"{module} {args} exited {proc.returncode}")
    return json.loads(lines[-1])


def step_study_launches(wrappers: tuple, policy=None) -> dict:
    """The launches of a step study's process: ``bench.bench_train_step``
    and ``probe_remat`` each run 2 + 3 x ``STUDY_ITERS`` steps (a first
    step, ``_best_of``'s warm-up and three windows), each launching K1
    once, K2's with-index forward 2 + the pools its remat policy recomputes
    and the backward twice; ``probe_remat`` then runs one forward (K1 once,
    the with-index K2 twice) to read the memory it holds."""
    steps = 2 + 3 * STUDY_ITERS
    want = {k: 0 for k in wrappers} | {
        "spectrogram": steps, "max_pool_3x3s2_idx": 2 * steps,
        "max_pool_3x3s2_bwd": 2 * steps}
    if policy is not None:
        want["spectrogram"] += 1
        want["max_pool_3x3s2_idx"] += 2 + steps * REMAT_POOLS.get(policy, 0)
    return want


def studies_phase(card: str, wrappers: tuple, headline_ms: float, dev="cuda",
                  small: bool = False) -> dict:
    """The step, pool and FER+ studies of ``mcncrossmodalemotions_torch.
    tools`` (phase 21) at their JAX sizes: the one-form-a-process ones
    (``probe_masked_bn``, ``ab_step_conv1``, ``probe_remat`` nothing: the
    online phase times the other policies) each in its own process with
    its exact launches; ``profile_train_step``, ``probe_conv1_s2d``,
    ``probe_pool_compose``, ``bench_pool_bwd`` and
    ``ablate_ferplus_resample`` (one seed, one timed augmentation a size,
    to keep the phase short) here. Gates: every process exits 0; conv1
    in space-to-depth form within ``S2D_FP32_RTOL`` x max|y| of the plain
    conv in fp32 (TF32 off) and ``S2D_BF16_RTOL`` in bf16; the composed
    pool's forward and the student's pool's y and dx (against autograd of
    ``F.max_pool2d``) bitwise; the studies launch K1 and every K2 kernel.
    The headline-form steps are printed beside the bench's
    ``headline_ms``. Returns the launches. With ``dev="cpu"`` (a
    rehearsal) ``small`` sizes; nothing launches there."""
    from mcncrossmodalemotions_torch.tools import (
        ablate_ferplus_resample,
        bench_pool_bwd,
        probe_conv1_s2d,
        probe_pool_compose,
        profile_train_step,
    )

    total = {k: 0 for k in wrappers}
    for module, form in STEP_STUDIES:
        rec = run_study(module, [form], dev)
        policy = form if module == "probe_remat" else None
        want = (step_study_launches(wrappers, policy) if dev == "cuda"
                else {k: 0 for k in wrappers})
        got = {k: rec["launches"].get(k, 0) for k in wrappers}
        print(f"  {card}: {module} {form}: {rec}; headline step of the bench "
              f"phase {headline_ms} ms", flush=True)
        check(got == want, f"{module} {form} launches {got}, expected {want}")
        add_counts(total, got)

    iters = 1 if small else STUDY_ITERS
    reset_counts(wrappers)
    prof = profile_train_step.main(dev, iters=iters, **(
        dict(batch_size=2, num_frames=100, tiny=True) if small else {}))
    print(f"  {card}: profile_train_step (ms): {prof}", flush=True)
    conv = probe_conv1_s2d.main(dev, iters=iters, **(
        dict(batch_size=2, height=64, width=50) if small else {}))
    print(f"  {card}: probe_conv1_s2d: {conv}", flush=True)
    check(conv["max_abs_diff_fp32"] <= S2D_FP32_RTOL * conv["max_abs_y_fp32"],
          f"conv1 s2d vs plain in fp32: {conv['max_abs_diff_fp32']:.3e} of "
          f"max|y| {conv['max_abs_y_fp32']:.3e}")
    check(conv["max_abs_diff"] <= S2D_BF16_RTOL * conv["max_abs_y"],
          f"conv1 s2d vs plain in bf16: {conv['max_abs_diff']:.3e} of "
          f"max|y| {conv['max_abs_y']:.3e}")
    comp = probe_pool_compose.main(dev, **(
        dict(shape=(2, 21, 19, 8), iters=1) if small else {}))
    print(f"  {card}: probe_pool_compose: {comp}", flush=True)
    check(comp["fwd_bitwise"], "the composed pool's forward is not bitwise "
          "the direct pool's")
    pools = bench_pool_bwd.main(dev, **(
        dict(numerics_shapes=((2, 21, 19, 96),),
             timed_shapes=(("pool1", (2, 21, 19, 8)),), iters=1)
        if small else {}))
    print(f"  {card}: bench_pool_bwd: {pools}", flush=True)
    for r in pools["numerics"]:
        exact = r["fwd_exact"] and (r["grad_exact"] or dev != "cuda")
        check(exact, f"bench_pool_bwd {r}: not bitwise")
    fer = ablate_ferplus_resample.main(dev, seeds=(0,), augment_reps=1, **(
        dict(num_images=48, epochs=1, batch_size=8, input_size=48)
        if small else {}))
    print(f"  {card}: ablate_ferplus_resample: {fer}", flush=True)
    check(all(0.0 <= a <= 1.0 for accs in fer["accuracy"].values()
              for a in accs), f"FER+ accuracies {fer['accuracy']}")
    here = read_counts(wrappers)
    add_counts(total, here)
    print(f"  studies phase: launches {total} (in this process {here})",
          flush=True)
    if dev == "cuda":
        check(all(total[k] > 0 for k in ("spectrogram", "max_pool_3x3s2",
                                         "max_pool_3x3s2_idx",
                                         "max_pool_3x3s2_bwd")),
              f"the studies did not launch every kernel: {total}")
    return total


def workflow_shapes(root: Path) -> list:
    """The extraction chunks of the worked example's two extractions (its
    VoxCeleb tracks and its synthetic RML set), from their own writers."""
    from mcncrossmodalemotions_torch.data.external import (
        build_synthetic_track_imdb,
    )
    from mcncrossmodalemotions_torch.examples import full_workflow

    full_workflow.write_voxceleb(root / "voxceleb")
    rml = build_synthetic_track_imdb(root / "rml", tracks_per_class=5)
    return (extraction_chunks(sorted((root / "voxceleb" / "wavs").rglob("*.wav")))
            + extraction_chunks(imdb_paths(rml)))


def workflow_phase(card: str, root: Path, wrappers: tuple, dev="cuda",
                   checked_chunks=None) -> dict:
    """The worked example (``examples/full_workflow.main``, phase 22) at
    its own tiny sizes (without figures where matplotlib is missing, as on
    the card's host): each stage's artifacts (the imdb cache, checkpoint 20
    and ``metrics.jsonl``, the feature cache, the AUC cache with
    ``meanAuc`` finite in both partitions, the teacher
    histogram over every frame and a wav for each sampled track, the RML
    benchmark's accuracy and confusion), its extraction chunks those the k1 and k2 phases checked
    (``checked_chunks``, where given), and on the card K1 and every K2
    kernel launched. Returns the launches."""
    from mcncrossmodalemotions_torch.examples import full_workflow

    reset_counts(wrappers)
    t0 = time.perf_counter()
    out = full_workflow.main(root / "workflow", device=dev)
    wall = time.perf_counter() - t0
    counts = read_counts(wrappers)
    work = out["root"]
    final = out["history"][-1]["train"]
    print(f"  {card}: worked example in {wall:.1f} s: {out['imdb'].num_tracks} "
          f"tracks, final loss {final['loss']:.4f}, meanAuc "
          f"{ {p: a['meanAuc'] for p, a in out['aucs'].items()} }, rml "
          f"accuracy {out['results']['rml'].mean_accuracy:.3f}; launches "
          f"{counts}", flush=True)
    artifacts = [work / "emovoxceleb-imdb.npz",
                 out["exp_dir"] / "net-epoch-20.pt",
                 out["exp_dir"] / "metrics.jsonl", work / "student-feats.npz",
                 work / "aucs.json"]
    missing = [str(p) for p in artifacts if not p.is_file()]
    check(not missing, f"the worked example did not write {missing}")
    check(out["imdb"].num_tracks == len(out["logits"])
          and all(l.shape == (1, 8) for l in out["logits"])
          and math.isfinite(final["loss"]), "the worked example's stages 2-3")
    aucs = {p: a["meanAuc"] for p, a in out["aucs"].items()}
    check(sorted(aucs) == ["train", "unheardVal"]
          and all(math.isfinite(v) for v in aucs.values()),
          f"the worked example's stage 3 scored no emotion: meanAuc {aucs}")
    hist = out["teacher_hist"]["emovoxceleb"]
    picked = sum(len(v) for v in out["samples"].values())
    check(hist.sum() == sum(len(w) for w in out["imdb"].wav_logits)
          and len(list((work / "samples").rglob("*.wav"))) == picked,
          f"the worked example's stage 4: histogram {hist}, {picked} "
          "tracks sampled")
    rml = out["results"]["rml"]
    n = len(out["rml"].classes)
    check(0.0 <= rml.mean_accuracy <= 1.0 and rml.confusion.shape == (n, n),
          "the worked example's stage 5")
    chunks = (extraction_chunks(imdb_paths(out["imdb"]))
              + extraction_chunks(imdb_paths(out["rml"])))
    check(checked_chunks is None or chunks == checked_chunks,
          f"worked example chunks {chunks}, checked {checked_chunks}")
    if dev == "cuda":
        check(all(counts[k] > 0 for k in ("spectrogram", "max_pool_3x3s2",
                                          "max_pool_3x3s2_idx",
                                          "max_pool_3x3s2_bwd")),
              f"the worked example did not launch every kernel: {counts}")
    return counts


def graft_rows(cards: int) -> list:
    """The rows of a rank's shard of each batch in the graft phase's dry
    runs (``graft_entry.batch_rows``: full batches and the ragged one) over
    ``cards`` NCCL ranks and ``GRAFT_GLOO_RANKS`` gloo ranks: the K1 and K2
    launch shapes, with crops of ``graft_entry.TINY_FRAMES``."""
    from mcncrossmodalemotions_torch.graft_entry import batch_rows

    rows = set()
    for n in (cards, GRAFT_GLOO_RANKS):
        batch, samples = batch_rows(n)
        rows |= {batch // n, (samples % batch or batch) // n}
    return sorted(rows)


def graft_phase(card: str, wrappers: tuple, dev="cuda") -> dict:
    """The driver's integration entry (``graft_entry.py``, phase 23). (a)
    ``entry()``: the full-width flagship forward with zero weights on batch
    8 of 4 s crops, output [8, 8] and finite, launching K1 once and K2's
    index-free forward twice, and its ms (CUDA events); (b)
    ``dryrun_multichip(torch.cuda.device_count())``, one NCCL rank a card;
    (c) ``dryrun_multichip(2, backend="gloo")``, two ranks on the one card.
    Each dry run: the four checks in every rank (the sharded SGD step, the
    fused online step, ``Trainer.fit`` for 2 epochs with a ragged tail, the
    resume to epoch 3), the ranks' state digests equal after each, every
    rank launching K1 ``GRAFT_STEPS`` times and K2's with-index forward and
    backward twice that; each run's wall seconds and rank 0's seconds a
    stage. The k1, k2 and k2-backward phases hold the kernels at these
    launch shapes. Returns the launches of the entry and of every rank.
    With ``dev="cpu"`` (a rehearsal) the same with one and two gloo ranks
    on the CPU, where nothing launches."""
    import numpy as np
    import torch

    from mcncrossmodalemotions_torch import graft_entry

    full = dev == "cuda"
    fn, args = graft_entry.entry(dev)
    reset_counts(wrappers)
    out = fn(*args)
    sync(dev)
    counts = read_counts(wrappers)
    want = {k: 0 for k in wrappers}
    if full:
        want |= {"spectrogram": 1, "max_pool_3x3s2": 2}
    check(tuple(out.shape) == (8, 8) and bool(torch.isfinite(out).all()),
          f"entry(): output {tuple(out.shape)}, finite "
          f"{bool(torch.isfinite(out).all())}")
    check(counts == want, f"entry() launched {counts}, expected {want}")
    ms = cuda_ms(lambda: fn(*args), iters=5, warmup=1) if full else 0.0
    print(f"  {card}: entry() forward {tuple(out.shape)} {out.dtype}, batch "
          f"{graft_entry.ENTRY_BATCH} x {args[1].shape[1]} samples: "
          f"{ms:.3f} ms; launches {counts}", flush=True)
    del fn, args, out
    if full:
        torch.cuda.empty_cache()  # the ranks share the card

    total = dict(counts)
    cards = torch.cuda.device_count() if full else 1
    runs = [(cards, None, "nccl" if full else "gloo"),
            (GRAFT_GLOO_RANKS, "gloo", "gloo")]
    rank_want = {k: 0 for k in wrappers}
    if full:
        rank_want |= {"spectrogram": GRAFT_STEPS,
                      "max_pool_3x3s2_idx": 2 * GRAFT_STEPS,
                      "max_pool_3x3s2_bwd": 2 * GRAFT_STEPS}
    for n, backend, named in runs:
        t0 = time.perf_counter()
        records = graft_entry.dryrun_multichip(n, device=dev, backend=backend)
        wall = time.perf_counter() - t0
        check([r["rank"] for r in records] == list(range(n))
              and all(r["backend"] == named for r in records),
              f"dry run over {n} {named} rank(s): "
              f"{[(r['rank'], r['backend']) for r in records]}")
        check(all(r["digests"] == records[0]["digests"]
                  and len(r["digests"]) == 4 for r in records),
              f"dry run over {n} {named} rank(s): the ranks' states differ")
        losses = records[0]["losses"]
        check(all(np.isfinite([losses["step"], losses["fused"],
                               losses["resume"]] + losses["fit"])),
              f"dry run losses {losses}")
        for r in records:
            got = {k: r["launches"].get(k, 0) for k in wrappers}
            check(got == rank_want, f"dry run over {n} {named} rank(s), rank "
                  f"{r['rank']} launched {got}, expected {rank_want}")
            add_counts(total, got)
        print(f"  {card}: dryrun_multichip({n}) over {named}: {wall:.2f} s "
              f"end to end; rank 0 s a stage "
              f"{ {k: round(v, 3) for k, v in records[0]['seconds'].items()} }"
              f"; losses {losses}; launches a rank {records[0]['launches']}",
              flush=True)
    return total


def epilogue_inputs(kernel: str, b: int, hw: int, c: int, dtype, dev,
                    seed: int, gate: bool = True, proj: bool = False) -> dict:
    """One call's inputs of an epilogue kernel in NHWC: y, the
    BatchNorm's running statistics and affine (s, t) and, for the tail,
    the residual, the SE gate (``gate``) and the projection's affine
    (``proj``)."""
    import torch

    from mcncrossmodalemotions_torch.ops import epilogue

    gen = torch.Generator(device=dev).manual_seed(seed)
    d = {"y": torch.randn(b, hw, hw, c, device=dev, generator=gen).to(dtype),
         "weight": torch.randn(c, device=dev, generator=gen) * 0.5 + 1.0,
         "bias": torch.randn(c, device=dev, generator=gen),
         "mean": torch.randn(c, device=dev, generator=gen),
         "var": torch.rand(c, device=dev, generator=gen) + 0.5}
    d["s"], d["t"] = epilogue.bn_affine(d["weight"], d["bias"], d["mean"],
                                        d["var"], 1e-5)
    if kernel == "affine_relu_pool2x2":  # the affine before the max matters
        d["weight"][::2].neg_()
        d["s"][::2].neg_()
    if kernel == "affine_gate_add_relu":
        d["r"] = torch.randn(b, hw, hw, c, device=dev, generator=gen).to(dtype)
        d["gate"] = (torch.rand(b, c, device=dev, generator=gen).to(dtype)
                     if gate else None)
        d["proj"] = (epilogue.bn_affine(
            torch.randn(c, device=dev, generator=gen) * 0.5 + 1.0,
            torch.randn(c, device=dev, generator=gen),
            torch.randn(c, device=dev, generator=gen),
            torch.rand(c, device=dev, generator=gen) + 0.5, 1e-5)
            if proj else None)
    return d


def epilogue_calls(kernel: str, d: dict) -> tuple:
    """(kernel, plain, library) calls on the inputs ``d``; the library's is
    the eager composition the kernel replaces (``F.batch_norm``, then
    ``F.relu``; the squeeze's mean; the gate's multiply and the residual
    add), which the port's fused path never calls."""
    import torch
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.ops import epilogue

    y, s, t = d["y"], d["s"], d["t"]

    def bn():
        return F.batch_norm(y.permute(0, 3, 1, 2), d["mean"], d["var"],
                            d["weight"], d["bias"], False, 0.0, 1e-5)

    if kernel == "affine_relu":
        out = y.new_empty(y.shape)
        return (lambda: epilogue.affine_relu(y, s, t, out=out),
                lambda: epilogue.affine_relu_plain(y, s, t),
                lambda: F.relu_(bn()))
    if kernel == "affine_squeeze":
        return (lambda: epilogue.affine_squeeze(y, s, t),
                lambda: epilogue.affine_squeeze_plain(y, s, t),
                lambda: bn().mean(dim=(2, 3), dtype=torch.float32))
    if kernel == "affine_relu_pool2x2":
        return (lambda: epilogue.affine_relu_pool2x2(y, s, t),
                lambda: epilogue.affine_relu_pool2x2_plain(y, s, t),
                lambda: F.max_pool2d(F.relu_(bn()), 2, 2))
    out, r, g, proj = y.new_empty(y.shape), d["r"], d["gate"], d["proj"]
    if g is None or proj is not None:
        library = None  # timed only gated with an identity residual
    else:
        def library():
            return F.relu_(bn() * g[:, :, None, None] + r.permute(0, 3, 1, 2))
    return (lambda: epilogue.affine_gate_add_relu(
                y, s, t, r, gate=g, residual_affine=proj, out=out),
            lambda: epilogue.affine_gate_add_relu_plain(
                y, s, t, r, gate=g, residual_affine=proj),
            library)


def epilogue_case(kernel: str, label: str, batch: int, hw: int, c: int,
                  dev, gate: bool = True, proj: bool = False) -> float:
    """One shape of an epilogue kernel against its plain version, within
    one bf16 unit in the last place and 1e-5 of the largest value, in one
    launch; returns its max abs error."""
    import torch

    from mcncrossmodalemotions_torch.ops import epilogue

    d = epilogue_inputs(kernel, batch, hw, c, torch.bfloat16, dev,
                        SEED + hw + c + 2 * gate + proj, gate, proj)
    call, plain, _ = epilogue_calls(kernel, d)
    wrapper = getattr(epilogue, kernel)
    before = wrapper.launches
    got, ref = call().float(), plain().float()
    sync(dev)
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    ok = not ((got - ref).abs() > 2.0 ** -7 * ref.abs()
              + 1e-5 * scale).any().item()
    tail = (f" ({'gated' if gate else 'no gate'}, "
            f"{'projection' if proj else 'identity'})"
            if kernel == "affine_gate_add_relu" else "")
    print(f"  {kernel}{tail} {label} [{batch}, {hw}, {hw}, {c}] bf16: max "
          f"abs {err:.3e} of max |plain| {scale:.3f}", flush=True)
    check(ok, f"{kernel}{tail} {label}: off its plain version")
    check(wrapper.launches == before + (dev == "cuda"),
          f"{kernel}{tail} {label}: not one launch")
    return err


def epilogue_bytes(kernel: str, b: int, hw: int, c: int, itemsize: int) -> int:
    """The least bytes of one call: each input and output moved once."""
    act, vec = b * hw * hw * c * itemsize, b * c * itemsize
    return {"affine_relu": 2 * act, "affine_squeeze": act + vec,
            "affine_gate_add_relu": 3 * act + vec,
            "affine_relu_pool2x2": act + act // 4}[kernel]


def epilogue_phase(card: str, dev="cuda", batch: int = EPILOGUE_BATCH,
                   shapes: dict = EPILOGUE_SHAPES,
                   timed: tuple = EPILOGUE_TIMED,
                   pool_shapes: dict = VD16_POOL_SHAPES) -> dict:
    """The teachers' epilogue kernels (phase 25) at every shape the
    full-width teachers launch them at (``shapes``: label -> (h = w, inner
    width, output width or None); ``pool_shapes``: label -> (h = w, c) of
    VGG-VD-16's block-end conv outputs), batch 128, bf16, each against its
    plain version (``epilogue_case``): ``affine_relu`` at the inner width,
    ``affine_squeeze`` and the four tails at the output width,
    ``affine_relu_pool2x2`` at each block end. At the ``timed`` shapes, on
    the card, ``affine_relu``, ``affine_squeeze`` and the gated identity
    tail, and ``affine_relu_pool2x2`` at every block end: the kernel, plain
    and library times in turns, each timed call's inputs rotated over
    enough copies that no call finds them in the L2
    (``EPILOGUE_COLD_BYTES``), beside the bound of its bytes. Returns, per
    kernel, [kernel ms, plain ms, library ms, bytes] summed over the timed
    shapes and the max abs error over every case (times 0 on the CPU, a
    rehearsal)."""
    import torch

    rows = {k: [0.0, 0.0, 0.0, 0, 0.0] for k in EPILOGUE_NAMES}

    def timing(kernel: str, label: str, hw: int, c: int) -> None:
        nbytes = epilogue_bytes(kernel, batch, hw, c, 2)
        rows[kernel][3] += nbytes
        if dev != "cuda":
            return
        copies = max(1, math.ceil(EPILOGUE_COLD_BYTES / nbytes))
        sets = [epilogue_inputs(kernel, batch, hw, c, torch.bfloat16, dev,
                                SEED + i) for i in range(copies)]
        calls = [epilogue_calls(kernel, d) for d in sets]
        turn = [0]

        def rotate(which):
            def call():
                turn[0] = (turn[0] + 1) % copies
                return calls[turn[0]][which]()
            return call

        k, p, lib = turns_ms(rotate(0), rotate(1), rotate(2))
        for i, v in enumerate((k, p, lib)):
            rows[kernel][i] += v
        bound, by = bound_ms(nbytes, 0)
        print(f"  {card}: {kernel} {label}: kernel {k:.4f} ms, plain "
              f"{p:.4f} ms, library {lib:.4f} ms; bound {bound:.4f} ms "
              f"({by}, {nbytes / 1e6:.1f} MB), {bound / k:.1%} of it; "
              f"{copies} input set(s)", flush=True)
        del sets, calls

    for label, (hw, inner, out_c) in shapes.items():
        cases = [("affine_relu", inner, True, False)]
        if out_c is not None:
            cases.append(("affine_squeeze", out_c, True, False))
            cases += [("affine_gate_add_relu", out_c, g, p)
                      for g, p in EPILOGUE_TAILS]
        for kernel, c, gate, proj in cases:
            err = epilogue_case(kernel, label, batch, hw, c, dev, gate, proj)
            rows[kernel][4] = max(rows[kernel][4], err)
        if label in timed:
            for kernel in ("affine_relu", "affine_squeeze",
                           "affine_gate_add_relu"):
                timing(kernel, label, hw, inner if kernel == "affine_relu"
                       else out_c)
    for label, (hw, c) in pool_shapes.items():
        err = epilogue_case("affine_relu_pool2x2", label, batch, hw, c, dev)
        rows["affine_relu_pool2x2"][4] = max(rows["affine_relu_pool2x2"][4],
                                             err)
        timing("affine_relu_pool2x2", label, hw, c)
    if dev == "cuda":
        torch.cuda.empty_cache()
    return rows


def count_epilogues(label: str, kind: str, on_card: bool,
                    total: dict | None, forwards: int = 1) -> None:
    """Hold the epilogue launches since the last reset to ``forwards``
    full-width ``kind`` forwards' (none off the card) and add them to
    ``total``."""
    got = read_counts(EPILOGUE_NAMES)
    want = teacher_epilogue_launches(kind, forwards * on_card)
    print(f"  {label}: epilogue launches {got}", flush=True)
    check(got == want, f"{label}: epilogue launches {got}, expected {want}")
    if total is not None:
        for k, v in got.items():
            total[k] = total.get(k, 0) + v


def teacher_epilogue_launches(kind: str, forwards: int) -> dict:
    """The epilogue launches of ``forwards`` full-width eval forwards of
    ``kind`` on the card: SENet50 and ResNet50 launch affine_relu after the
    stem and twice a bottleneck (1 + 2 x 16), a squeeze a bottleneck with
    SE and a tail a bottleneck; VGG-VD-16 affine_relu after each of its 8
    mid-block convs, fc6 and fc7, and affine_relu_pool2x2 after each of
    its 5 block-end convs."""
    per = {"senet50": (33, 16, 16, 0), "resnet50": (33, 0, 16, 0),
           "vgg16": (10, 0, 0, 5)}[kind]
    return {k: n * forwards for k, n in zip(EPILOGUE_NAMES, per)}


def count_train_bn(label: str, fused: int, plain: int,
                   total: dict | None = None) -> dict:
    """Hold the train-mode BatchNorm since the last reset to ``fused``
    fused forwards and as many backwards, each wrapper launched once a
    call, and ``plain`` eager calls on the card; add the launches to
    ``total`` and return them."""
    from mcncrossmodalemotions_torch.ops import train_bn as tb

    got = read_counts(TRAIN_BN_NAMES)
    calls = dict(tb.calls)
    want = dict.fromkeys(TRAIN_BN_NAMES, fused)
    want_calls = {"fused": fused, "fused_backward": fused, "plain": plain}
    print(f"  {label}: train-mode BatchNorm launches {got}, calls {calls}",
          flush=True)
    check(got == want and calls == want_calls,
          f"{label}: train-mode BatchNorm launches {got} and calls {calls}, "
          f"expected {fused} a wrapper and {want_calls}")
    if total is not None:
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    return got


def train_bn_inputs(batch: int, c: int, h: int, w: int, dev, seed: int,
                    masked: bool = True) -> dict:
    """One BatchNorm call's inputs: x and dy bf16 ``channels_last`` [batch,
    c, h, w] (x with per-channel means and spreads), a BatchNorm with drawn
    parameters and running statistics, and the pad mask (all rows real,
    as the cell's full batches are; None with ``masked`` False)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    spread = torch.rand(1, c, 1, 1, device=dev, generator=gen) * 2 + 0.25
    mean = torch.randn(1, c, 1, 1, device=dev, generator=gen)
    cl = torch.channels_last
    x = torch.randn(batch, c, h, w, device=dev, generator=gen) * spread + mean
    dy = torch.randn(batch, c, h, w, device=dev, generator=gen)
    bn = torch.nn.BatchNorm2d(c).to(dev)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=gen)
        bn.bias.uniform_(-0.3, 0.3, generator=gen)
        bn.running_mean.uniform_(-1.0, 1.0, generator=gen)
        bn.running_var.uniform_(0.5, 2.0, generator=gen)
    return {"x": x.to(torch.bfloat16).contiguous(memory_format=cl),
            "dy": dy.to(torch.bfloat16).contiguous(memory_format=cl),
            "bn": bn,
            "mask": torch.ones(batch, device=dev) if masked else None}


def train_bn_calls(d: dict) -> dict:
    """The timed calls on the inputs ``d``, by name: the kernels' forward
    and backward (three wrappers each, the backward from one forward's
    saved statistics) and each pass alone; the eager code (``vggm.
    _batch_norm_train`` and ``F.relu``, what the card ran before) and the
    library (``F.batch_norm(training=True)`` and ``F.relu``, unmasked,
    which the port never calls), each forward and, through autograd on a
    kept graph, backward."""
    import copy

    import torch
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch.models import vggm
    from mcncrossmodalemotions_torch.ops import train_bn as tb

    x, dy, bn, mask = d["x"], d["dy"], d["bn"], d["mask"]
    b, c, h, w = x.shape
    xn, dyn = x.permute(0, 2, 3, 1), dy.permute(0, 2, 3, 1)
    affine = (bn.weight.detach(), bn.bias.detach(), bn.running_mean,
              bn.running_var, bn.eps, vggm.BN_MOMENTUM, True)

    def stats():
        return tb.stats(xn, mask)

    part = stats()

    def finalize():
        return tb.finalize(part, mask, b, h * w, *affine)

    sc, sh, saved = finalize()

    def apply():
        return tb.apply(xn, sc, sh, True)

    def reduce():
        return tb.backward_reduce(dyn, xn, sc, sh, saved, True)

    grad_part = reduce()

    def grad_finalize():
        return tb.backward_finalize(grad_part, saved, affine[0], sc, bn.eps)

    coef = grad_finalize()

    def dx():
        return tb.backward_apply(dyn, xn, sc, sh, coef, mask, True)

    def kernel_forward():
        p = tb.stats(xn, mask)
        s, t, _ = tb.finalize(p, mask, b, h * w, *affine)
        return tb.apply(xn, s, t, True)

    def kernel_backward():
        p = tb.backward_reduce(dyn, xn, sc, sh, saved, True)
        k = tb.backward_finalize(p, saved, affine[0], sc, bn.eps)
        return tb.backward_apply(dyn, xn, sc, sh, k, mask, True)

    eager_bn, library_bn = copy.deepcopy(bn), copy.deepcopy(bn)

    def eager(xr):
        return F.relu(vggm._batch_norm_train(xr, eager_bn, mask, True, None))

    def library(xr):
        return F.relu(F.batch_norm(xr, library_bn.running_mean,
                                   library_bn.running_var, library_bn.weight,
                                   library_bn.bias, True, 0.1, bn.eps))

    def forward(fn):
        def call():
            with torch.no_grad():
                return fn(x)
        return call

    def backward(fn, module):
        xr = x.detach().requires_grad_()
        y = fn(xr)
        leaves = (xr, module.weight, module.bias)
        return lambda: torch.autograd.grad(y, leaves, dy, retain_graph=True)

    return {"stats": stats, "finalize": finalize, "apply": apply,
            "reduce": reduce, "grad_finalize": grad_finalize, "dx": dx,
            "forward": (kernel_forward, forward(eager), forward(library)),
            "backward": (kernel_backward, backward(eager, eager_bn),
                         backward(library, library_bn))}


def train_bn_units_off(got, want, atol_share: float) -> tuple:
    """(elements off by more than one bf16 unit in the last place of the
    larger magnitude plus ``atol_share`` of want's largest, the largest
    difference in such units)."""
    import torch

    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    unit = torch.exp2(torch.floor(torch.log2(big)) - 7)
    diff = (g - w).abs()
    off = (diff > unit + atol_share * w.abs().max()).sum().item()
    return int(off), (diff / unit).max().item()


def train_bn_case(label: str, d: dict, dev) -> float:
    """One layer's forward and backward through the program's dispatch
    (``vggm.batch_norm_train(..., relu=True)``: the kernels on the card,
    counted, and the eager code itself on the CPU, a rehearsal) against
    the eager code on the same bf16 inputs: y and dx within one bf16 unit
    (and ``TRAIN_BN_ATOL`` near zero), the parameter gradients and running
    statistics within fp32 order noise; returns the largest difference in
    bf16 units."""
    import copy

    import torch

    from mcncrossmodalemotions_torch.models import vggm

    runs = []
    for fused in (True, False):
        bn = copy.deepcopy(d["bn"])
        xr = d["x"].detach().clone().requires_grad_()
        if fused:
            reset_counts(TRAIN_BN_NAMES)
            y = vggm.batch_norm_train(xr, bn, d["mask"], relu=True)
        else:
            y = torch.relu(vggm._batch_norm_train(xr, bn, d["mask"], True,
                                                  None))
        grads = torch.autograd.grad(y, (xr, bn.weight, bn.bias), d["dy"])
        if fused:
            count_train_bn(f"train-bn {label}",
                           int(torch.device(dev).type == "cuda"), 0)
        runs.append((y.detach(),) + grads + (bn.running_mean,
                                             bn.running_var))
    sync(dev)
    worst = 0.0
    notes = []
    for name, got, want in zip(("y", "dx"), runs[0][:2], runs[1][:2]):
        off, units = train_bn_units_off(got, want, TRAIN_BN_ATOL[name])
        worst = max(worst, units)
        notes.append(f"{name} {units:.2f} units")
        check(off == 0, f"train-bn {label}: {name} {off} elements off the "
                        f"eager code")
    for name, got, want, rtol in zip(
            ("dweight", "dbias", "running_mean", "running_var"),
            runs[0][2:], runs[1][2:], (1e-3, 1e-3, 1e-4, 1e-4)):
        gap = ((got - want).abs().max() / want.abs().max()).item()
        notes.append(f"{name} {gap:.2e}")
        check(gap <= rtol, f"train-bn {label}: {name} {gap:.3e} off")
    b, c, h, w = d["x"].shape
    print(f"  train-bn {label} [{b}, {c}, {h}, {w}] bf16 against the eager "
          f"code: " + ", ".join(notes), flush=True)
    return worst


def train_bn_step(dev, batch: int) -> None:
    """One student train step at ``batch`` (4 s int16 crops, a pad mask;
    full width on the card, the tiny student on the CPU)."""
    import torch

    from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
    from mcncrossmodalemotions_torch.train.state import (
        TrainState,
        make_train_step,
    )
    from mcncrossmodalemotions_torch.zoo import build_student, student_loss_fn

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n = DEFAULT_SPEC.crop_samples(400)
    data = torch.randn(batch, n, device=dev, generator=gen) * 3000
    step_batch = {"data": data.to(torch.int16),
                  "logit_target": torch.randn(batch, 8, device=dev,
                                              generator=gen),
                  "max_label": torch.randint(0, 8, (batch,), device=dev,
                                             generator=gen, dtype=torch.int32),
                  "pad_mask": torch.ones(batch, device=dev)}
    model = build_student(tiny=torch.device(dev).type != "cuda",
                          generator=torch.Generator().manual_seed(SEED))
    state = TrainState.create(model.to(dev),
                              torch.Generator(device=dev).manual_seed(SEED))
    step = make_train_step(student_loss_fn("hot-cross-ent", temperature=2.0),
                           pass_pad_mask=True)
    step(state, step_batch, TRAIN_LR)
    sync(dev)


def train_bn_phase(card: str, dev="cuda", batch: int = TRAIN_BN_BATCH,
                   shapes: dict = TRAIN_BN_SHAPES,
                   passes_at: str = TRAIN_BN_PASSES_AT,
                   bn_launches: dict | None = None) -> dict:
    """The student's train-mode BatchNorm and ReLU kernels
    (``csrc/train_bn.cu``, ``ops/train_bn.py``; phase 26) at the
    distillation cell's six BatchNorm inputs (``shapes``, batch 64 in
    bf16): each layer's fused forward and backward against the eager code
    (``train_bn_case``); on the card the forward (stats, finalize, apply)
    and the backward (reduction, finalize, dx) timed against the eager
    code and the library (``train_bn_calls``) in turns, each timed call's
    inputs rotated over copies so that none is in the L2, beside the bound
    of the least bytes (x in and y out; dy and x in and dx out); at
    ``passes_at`` each pass alone beside its own bytes; then one student
    train step (full width at ``batch``) counted: six fused forwards, six
    fused backwards, each wrapper launched six times (added to
    ``bn_launches``), no eager BatchNorm (all zero on the CPU, whose
    tensors take the eager code, uncounted). Returns, for the forward and the
    backward, [kernel ms, eager ms, library ms, least bytes, largest
    difference in bf16 units] summed over the layers (times 0 on the
    CPU, a rehearsal)."""
    import torch

    rows = {"train_bn_forward": [0.0, 0.0, 0.0, 0, 0.0],
            "train_bn_backward": [0.0, 0.0, 0.0, 0, 0.0]}
    on_card = torch.device(dev).type == "cuda"
    for label, (c, h, w) in shapes.items():
        elems = batch * c * h * w
        d = train_bn_inputs(batch, c, h, w, dev, SEED + c + h + w)
        units = train_bn_case(label, d, dev)
        for key, per in (("train_bn_forward", 4), ("train_bn_backward", 6)):
            rows[key][3] += per * elems
            rows[key][4] = max(rows[key][4], units)
        if not on_card:
            continue
        copies = max(1, math.ceil(EPILOGUE_COLD_BYTES / (2 * elems)))
        sets = [d] + [train_bn_inputs(batch, c, h, w, dev, SEED + c + i)
                      for i in range(1, copies)]
        calls = [train_bn_calls(s) for s in sets]
        turn = [0]

        def rotate(name, which=None):
            def call():
                turn[0] = (turn[0] + 1) % copies
                fn = calls[turn[0]][name]
                return fn() if which is None else fn[which]()
            return call

        for key, name, per in (("train_bn_forward", "forward", 4),
                               ("train_bn_backward", "backward", 6)):
            k, p, lib = turns_ms(*(rotate(name, i) for i in range(3)))
            for i, v in enumerate((k, p, lib)):
                rows[key][i] += v
            bound, _ = bound_ms(per * elems, 0)
            print(f"  {card}: train-bn {name} {label} [{batch}, {c}, {h}, "
                  f"{w}]: kernels {k:.4f} ms, eager {p:.4f} ms, library "
                  f"{lib:.4f} ms; bound {bound:.4f} ms (bytes, "
                  f"{per * elems / 1e6:.1f} MB), {bound / k:.1%} of it; "
                  f"{copies} input set(s)", flush=True)
        if label == passes_at:
            for name, per in (("stats", 2), ("finalize", 0), ("apply", 4),
                              ("reduce", 4), ("grad_finalize", 0),
                              ("dx", 6)):
                ms = cuda_ms(rotate(name))
                if per:
                    bound, _ = bound_ms(per * elems, 0)
                    share = f"bound {bound:.4f} ms, {bound / ms:.1%} of it"
                else:
                    share = "per-channel work"
                print(f"  {card}: train-bn {label} pass {name}: {ms:.4f} ms; "
                      f"{share}", flush=True)
        del sets, calls
        torch.cuda.empty_cache()
    fwd, bwd = rows["train_bn_forward"][0], rows["train_bn_backward"][0]
    print(f"  {card}: train-bn the six layers a step: forward {fwd:.4f} ms + "
          f"backward {bwd:.4f} ms = {fwd + bwd:.4f} ms (target "
          f"{TRAIN_BN_TARGET_MS} ms); eager "
          f"{rows['train_bn_forward'][1] + rows['train_bn_backward'][1]:.4f} "
          f"ms; least bytes' bound "
          f"{bound_ms(rows['train_bn_forward'][3] + rows['train_bn_backward'][3], 0)[0]:.4f} ms",
          flush=True)
    reset_counts(TRAIN_BN_NAMES)
    train_bn_step(dev, batch)
    count_train_bn(f"train-bn one student step at batch {batch}",
                   STUDENT_BNS * on_card, 0, bn_launches)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import mcncrossmodalemotions_torch as port

    check(Path(port.__file__).resolve().parent.parent == ROOT,
          f"imported {port.__file__}, not the package beside this script")
    import numpy as np
    import torch.nn.functional as F

    from mcncrossmodalemotions_torch import graft_entry
    from mcncrossmodalemotions_torch.bench import audio_feats_wavs
    from mcncrossmodalemotions_torch.data import synthetic_track_imdb
    from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
        AudioFeatureExtractor,
        compute_audio_feats,
    )
    from mcncrossmodalemotions_torch.ops import _build, pool
    from mcncrossmodalemotions_torch.ops.spectrogram import (
        DEFAULT_SPEC,
        preemphasis,
        spectrogram,
    )
    from mcncrossmodalemotions_torch.ops.spectrogram_kernel import spectrogram_cuda
    from mcncrossmodalemotions_torch.tools import run_demo
    from mcncrossmodalemotions_torch.zoo import (
        build_student,
        random_student_variables,
        student_state_dict_from_flax,
    )

    walls: dict = {}
    cfg = DEFAULT_SPEC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    wrappers = KERNEL_NAMES

    with phase("device", walls):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        card = smi.stdout.strip().splitlines()[0]
        print(card, flush=True)
        name = torch.cuda.get_device_name(0)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
              f"device 0: {name}, {torch.cuda.device_count()} device(s)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    with phase("build", walls):
        libs = ("spectrogram", "max_pool_3x3s2", "probes", "train_bn",
                "dataservice_audio", "dataservice_faces")
        _build.load(*libs)  # one compiler each, all started together
        for lib in libs:
            log = _build.library_path(lib).with_suffix(".log").read_text()
            for line in log.splitlines():
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    print(f"  {lib}: {line.strip()}")
            compiler = "g++" if lib.startswith("dataservice") else "nvcc"
            print(f"  {lib}: {compiler} {_build.build_seconds[lib]:.2f} s",
                  flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        with phase("data", walls):
            imdb = synthetic_track_imdb(Path(tmp))
            paths = list(imdb.wav_paths)
            # (rows, t_pad, bucket) of every chunk the extractor launches
            chunks = extraction_chunks(paths)
            print(f"  {len(paths)} tracks; chunks (rows, t_pad, bucket): "
                  f"{chunks}")
            check(len({b for _, _, b in chunks}) >= 3, "fewer than three buckets")
            # the demo's and the bench's extraction chunks (their own
            # seeded tracks): the k1 and k2 phases check the kernels there
            demo_chunks = extraction_chunks(imdb_paths(
                run_demo.build_imdb(Path(tmp) / "demo-shapes")))
            feats_chunks = extraction_chunks(
                audio_feats_wavs(Path(tmp) / "bench-shapes"))
            print(f"  demo chunks {demo_chunks}; bench audio-feats chunks "
                  f"{feats_chunks}")
            workflow_chunks = workflow_shapes(Path(tmp) / "workflow-shapes")
            print(f"  worked example chunks {workflow_chunks}")
            # the graft phase's dry runs: a rank's rows of each batch
            dry_rows = graft_rows(torch.cuda.device_count())
            print(f"  graft dry-run rows a rank {dry_rows}, crops of "
                  f"{graft_entry.TINY_FRAMES} frames")

        timings = {k: [0.0, 0.0, 0.0] for k in wrappers}  # kernel, plain, library
        work = {k: [0.0, 0.0] for k in wrappers}  # bytes, operations
        errs = {k: 0.0 for k in wrappers}
        with phase("k1", walls):
            bench_n = cfg.crop_samples(400)
            cases = [("bench crop", BATCH, bench_n, torch.float32, False),
                     ("ragged tile", BATCH, cfg.crop_samples(150),
                      torch.float32, False),
                     ("t_pad=1000", BATCH, cfg.crop_samples(1000),
                      torch.float32, False),
                     ("one frame", BATCH, cfg.crop_samples(1), torch.float32,
                      False),
                     ("ragged FT tile", BATCH, cfg.crop_samples(33),
                      torch.int16, False)]
            cases += [(f"slice t_pad={t_pad}", rows, cfg.crop_samples(t_pad),
                       torch.int16, True) for rows, t_pad, _ in chunks]
            cases.append(("train crop", TRAIN_BATCH, bench_n, torch.int16, True))
            # the demo's and the bench's launch shapes, checked, not timed
            cases += [(f"{who} t_pad={t_pad}", rows, cfg.crop_samples(t_pad),
                       torch.int16, False)
                      for who, some in (("demo", demo_chunks),
                                        ("bench audio-feats", feats_chunks),
                                        ("worked example", workflow_chunks))
                      for rows, t_pad, _ in some]
            cases += [("demo step", DEMO_BATCH, bench_n, torch.int16, False),
                      ("worked example step", WORKFLOW_BATCH, bench_n,
                       torch.int16, False),
                      ("bench epoch step", BATCH, bench_n, torch.int16, False),
                      ("bench headline", TRAIN_BATCH, bench_n, torch.float32,
                       False)]
            cases += [("graft entry", graft_entry.ENTRY_BATCH,
                       cfg.crop_samples(graft_entry.ENTRY_FRAMES),
                       torch.float32, False)]
            cases += [(f"graft dry run, {rows} row(s) a rank", rows,
                       cfg.crop_samples(graft_entry.TINY_FRAMES),
                       torch.float32, False) for rows in dry_rows]
            for label, rows, n, dtype, timed in cases:
                gen.manual_seed(SEED)
                x = torch.randn(rows, n, device=dev, generator=gen)
                if dtype == torch.int16:  # the slice's PCM16 feed
                    x = (x * 0.25 * 32767).round().clamp(-32768, 32767).to(dtype)
                got = spectrogram_cuda(x, cfg)
                ref = spectrogram(x, cfg)
                torch.cuda.synchronize()
                check(got.shape == ref.shape == (rows, cfg.nfft, cfg.num_frames(n)),
                      f"K1 {label}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
                err = (got - ref).abs().max().item()
                rel = err / ref.abs().max().item()
                errs["spectrogram"] = max(errs["spectrogram"], err)
                print(f"  K1 {label} {tuple(x.shape)} {dtype} "
                      f"(T={cfg.num_frames(n)}): max abs {err:.3e}, "
                      f"max rel {rel:.3e}", flush=True)
                check(rel <= K1_REL_TOL,
                      f"K1 {label}: rel err {rel:.3e} > {K1_REL_TOL}")
                if label == "bench crop":
                    gold = golden_row(x[0].cpu().numpy(), cfg)
                    gerr = float(np.abs(got[0].cpu().numpy() - gold).max())
                    print(f"  K1 {label} row 0 vs float64 FFT: max abs {gerr:.3e}")
                    check(gerr <= K1_GOLDEN_ATOL, f"K1 golden: {gerr:.3e}")
                if timed:
                    stft = stft_call(preemphasis(x, cfg.preemph), cfg)
                    mag = stft()
                    half = ref[:, :cfg.num_rbins]
                    srel = ((mag - half).abs().max() / half.abs().max()).item()
                    print(f"  K1 {label}: torch.stft magnitudes vs plain: max "
                          f"rel {srel:.3e}")
                    check(mag.shape == half.shape and srel <= STFT_REL_TOL,
                          f"torch.stft {label}: {tuple(mag.shape)}, rel {srel:.3e}")
                    p, k, lib = turns_ms(lambda: spectrogram(x, cfg),
                                         lambda: spectrogram_cuda(x, cfg), stft)
                    nbytes = 2 * x.numel() + 4 * got.numel()
                    ops, dft_ops = spectrogram_ops(rows * cfg.num_frames(n), cfg)
                    b = add_timing(timings, work, "spectrogram", [k, p, lib],
                                   nbytes, ops)
                    dft, dft_by = bound_ms(nbytes, dft_ops)
                    print(f"  {card}: K1 {label} {tuple(x.shape)} int16: "
                          f"kernel {k:.4f} ms, plain {p:.4f} ms, torch.stft "
                          f"(pre-emphasised f32 rows) {lib:.4f} ms; {b}; "
                          f"with a DFT product's operations the bound would "
                          f"be {dft:.5f} ms ({dft_by})")
                    del stft, mag, half
            del x, got, ref

        with phase("k2", walls):
            # the slice's chunks (timed), then the other (rows, bucket) of
            # the demo's and the bench's extraction and the demo's val step
            seen = {(rows, bucket) for rows, _, bucket in chunks}
            k2_cases = [(rows, bucket, True) for rows, _, bucket in chunks]
            k2_cases += [(rows, bucket, False) for rows, bucket in dict.fromkeys(
                [(rows, bucket) for rows, _, bucket
                 in demo_chunks + feats_chunks + workflow_chunks]
                + [(DEMO_BATCH, 400), (WORKFLOW_BATCH, 400),
                   (graft_entry.ENTRY_BATCH, graft_entry.ENTRY_FRAMES)])
                if (rows, bucket) not in seen]
            for rows, bucket, timed in k2_cases:
                for label, shape in pool_inputs(rows, bucket, cfg.nfft).items():
                    for dtype, ibits in ((torch.bfloat16, torch.int16),
                                         (torch.float32, torch.int32)):
                        gen.manual_seed(SEED)
                        x = torch.relu(torch.randn(shape, device=dev,
                                                   generator=gen)).to(dtype)
                        got = pool.max_pool_3x3s2_cuda(x)
                        ref = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(
                            0, 2, 3, 1).contiguous()
                        torch.cuda.synchronize()
                        same = got.shape == ref.shape and torch.equal(
                            got.view(ibits), ref.view(ibits))
                        err = (got.float() - ref.float()).abs().max().item()
                        errs["max_pool_3x3s2"] = max(
                            errs["max_pool_3x3s2"], err)
                        print(f"  K2 bucket {bucket} {label} {shape} {dtype}: "
                              f"bitwise {'equal' if same else 'DIFFERENT'} "
                              f"(max abs {err:.3e})", flush=True)
                        check(same, f"K2 bucket {bucket} {label} {dtype}: "
                              "not bitwise equal")
                        if timed and dtype == torch.bfloat16:  # the slice's
                            p, k = turns_ms(lambda: pool.max_pool_3x3s2(x),
                                            lambda: pool.max_pool_3x3s2_cuda(x))
                            b = add_timing(timings, work, "max_pool_3x3s2",
                                           [k, p], 2 * (x.numel() + got.numel()),
                                           8 * got.numel())
                            print(f"  {card}: K2 bucket {bucket} {label} "
                                  f"{shape} bf16: kernel {k:.4f} ms, "
                                  f"plain {p:.4f} ms; {b}")
                        del x, got, ref
            torch.cuda.empty_cache()

        with phase("slice", walls):
            # full width, bf16; weights on the host: the extractor moves
            # them to the card, its default device
            model = build_student(with_frontend=False)
            state = student_state_dict_from_flax(
                random_student_variables(seed=SEED))

            t0 = time.perf_counter()
            compute_audio_feats(imdb, model, state, batch_size=BATCH,
                                verbose=False)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0

            reset_counts(wrappers)
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(sys.stdout):
                logits = compute_audio_feats(imdb, model, state, batch_size=BATCH)
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
            launches = read_counts(wrappers)

            t0 = time.perf_counter()
            plain = compute_audio_feats(imdb, model, state, batch_size=BATCH,
                                        use_kernels=False, verbose=False)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0

            check(len(logits) == len(paths), "missing tracks")
            check(all(l.shape == (1, 8) and np.all(np.isfinite(l))
                      for l in logits), "logits not finite [1, 8]")
            expected = {k: 0 for k in wrappers} | {
                "spectrogram": len(chunks), "max_pool_3x3s2": 2 * len(chunks)}
            print(f"  launches in the main run: {launches}, "
                  f"expected {expected}")
            check(launches == expected,
                  f"the main path did not launch the kernels once per "
                  f"spectrogram and pool: {launches}")
            got, ref = np.concatenate(logits), np.concatenate(plain)
            scale = float(np.abs(ref).max())
            diff = float(np.abs(got - ref).max())
            print(f"  logits kernel vs plain: max abs {diff:.3e}, "
                  f"max |logit| {scale:.3f}, rel {diff / scale:.3e}")
            check(diff <= SLICE_REL_TOL * scale, "kernel-on logits disagree")
            print(f"  {card}: first run {first_s:.3f} s, main run {main_s:.3f} s "
                  f"= {len(paths) / main_s:.2f} tracks/s (kernels), plain run "
                  f"{plain_s:.3f} s = {len(paths) / plain_s:.2f} tracks/s",
                  flush=True)

            # the extractor's other two feeds over the same tracks
            wavs = imdb_paths(imdb)
            for feed, emit in (("mu-law", dict(emit_mulaw=True)),
                               ("float32", dict(emit_int16=False))):
                reset_counts(wrappers)
                t0 = time.perf_counter()
                fed = AudioFeatureExtractor(model, state, batch_size=BATCH,
                                            **emit).track_logits(
                    wavs, verbose=False)
                torch.cuda.synchronize()
                feed_s = time.perf_counter() - t0
                feed_launches = read_counts(wrappers)
                fed_plain = AudioFeatureExtractor(
                    model, state, batch_size=BATCH, use_kernels=False,
                    **emit).track_logits(wavs, verbose=False)
                check(len(fed) == len(paths)
                      and all(l.shape == (1, 8) and np.all(np.isfinite(l))
                              for l in fed), f"{feed} logits not finite [1, 8]")
                check(feed_launches == expected, f"the {feed} feed launched "
                      f"{feed_launches}, expected {expected}")
                add_counts(launches, feed_launches)
                fgot, fref = np.concatenate(fed), np.concatenate(fed_plain)
                fscale = float(np.abs(fref).max())
                fdiff = float(np.abs(fgot - fref).max())
                print(f"  {card}: {feed} feed: {feed_s:.3f} s = "
                      f"{len(paths) / feed_s:.2f} tracks/s (kernels); logits "
                      f"kernel vs plain max abs {fdiff:.3e} (rel "
                      f"{fdiff / fscale:.3e}), vs the int16 run's max abs "
                      f"{float(np.abs(fgot - got).max()):.3e}; launches "
                      f"{feed_launches}", flush=True)
                check(fdiff <= SLICE_REL_TOL * fscale,
                      f"{feed} feed: kernel-on logits disagree")
            del model, state
            torch.cuda.empty_cache()

        with phase("k2-backward", walls):
            k2_backward_phase(card, timings, errs, work, dry_rows)

        with phase("train", walls):
            bn_launches = {}  # the train-mode BatchNorm wrappers' launches
            train_counts = train_phase(card, wrappers, bn_launches)

        with phase("distill", walls):
            distill_counts, distill_imdb = distill_phase(Path(tmp), wrappers,
                                                         bn_launches)

        with phase("reader", walls):
            reader_counts = reader_phase(card, imdb, wrappers)

        with phase("release", walls):
            release_counts, student, student_state = release_phase(
                card, Path(tmp), imdb, distill_imdb, wrappers)

        with phase("analysis", walls):
            analysis_counts = analysis_phase(card, Path(tmp), student,
                                             student_state, distill_imdb,
                                             wrappers)
            del student, student_state

        with phase("teacher", walls):
            epilogue_launches = {}
            teacher_counts, dense_imdb = teacher_phase(
                card, Path(tmp), imdb_paths(imdb), wrappers,
                epilogue_launches=epilogue_launches)

        with phase("teacher-train", walls):
            teacher_train_counts = teacher_train_phase(
                card, Path(tmp), wrappers, bn_launches=bn_launches)

        with phase("online", walls):
            online_counts = online_phase(card, Path(tmp), dense_imdb,
                                         distill_imdb, wrappers)
            torch.cuda.empty_cache()

        with phase("verify", walls):
            verify_counts = verify_phase(
                card, Path(tmp), dense_imdb, wrappers,
                Path(tmp) / "emovoxceleb-student.mat",
                {f"{arch}-ferplus": Path(tmp) / f"{arch}-release.mat"
                 for arch in ("senet50", "resnet50")})

        with phase("ddp", walls):
            ddp_counts = ddp_phase(card, Path(tmp), dense_imdb, wrappers)

        with phase("dense-chunked", walls):
            torch.cuda.empty_cache()  # the workers find the card free
            dense_chunked_counts = dense_chunked_phase(card, Path(tmp),
                                                       dense_imdb, wrappers)
            del dense_imdb

        with phase("bench", walls):
            torch.cuda.empty_cache()  # the bench's processes find the card free
            headline_ms = bench_phase(card, Path(tmp))

        with phase("demo", walls):
            demo_counts = demo_phase(card, Path(tmp), wrappers,
                                     checked_chunks=demo_chunks)

        with phase("studies", walls):
            torch.cuda.empty_cache()  # the study processes find the card free
            studies_counts = studies_phase(card, wrappers, headline_ms)

        with phase("workflow", walls):
            workflow_counts = workflow_phase(card, Path(tmp), wrappers,
                                             checked_chunks=workflow_chunks)

        with phase("graft", walls):
            torch.cuda.empty_cache()  # the ranks find the card free
            graft_counts = graft_phase(card, wrappers)

        with phase("probes", walls):
            probe_counts = probes_phase(card, wrappers, timings, errs, work)

        with phase("teacher-epilogue", walls):
            epilogue_rows = epilogue_phase(card)

        with phase("train-bn", walls):
            train_bn_rows = train_bn_phase(card, bn_launches=bn_launches)

    print("  phase walls (s): " + ", ".join(f"{k} {v:.2f}"
                                            for k, v in walls.items()))
    print(f"  {card}: kernel times summed over the main runs' launch shapes "
          f"(ms, kernel / plain / library): " + ", ".join(
              f"{k} {v[0]:.5f} / {v[1]:.5f} / {v[2]:.5f}"
              for k, v in timings.items()))
    source = "mcncrossmodalemotions_torch/csrc/"
    probe_tools = "tools/probe_mosaic.py:39"
    replaces = {
        "spectrogram": ("spectrogram.cu",
                        "mcncrossmodalemotions_tpu/ops/pallas_spectrogram.py:117"),
        "max_pool_3x3s2": ("max_pool_3x3s2.cu",
                           "mcncrossmodalemotions_tpu/ops/pallas_pool.py:95"),
        "max_pool_3x3s2_idx": ("max_pool_3x3s2.cu",
                               "mcncrossmodalemotions_tpu/ops/pallas_pool.py:95"),
        "max_pool_3x3s2_bwd": ("max_pool_3x3s2.cu",
                               "mcncrossmodalemotions_tpu/ops/pallas_pool.py:144"),
        "probe_gather": ("probes.cu", f"{probe_tools}, "
                         "tools/probe_mosaic2.py:32,111"),
        "probe_select_matmul": ("probes.cu", f"{probe_tools} (P9)"),
        "probe_col_candidates": ("probes.cu", "tools/probe_mosaic2.py:32 (P12)"),
    }
    library = {"spectrogram": "torch.stft", "probe_gather": "index_select",
               "probe_select_matmul": "torch.matmul"}
    library |= dict.fromkeys(("max_pool_3x3s2", "max_pool_3x3s2_idx",
                              "max_pool_3x3s2_bwd"), "its plain version")
    kernels = []
    for name, (src, rep) in replaces.items():
        bound, bound_by = bound_ms(*work[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source + src,
            "replaces": rep,
            "launches": (launches[name] + train_counts[name]
                         + distill_counts[name] + reader_counts[name]
                         + release_counts[name] + analysis_counts[name]
                         + teacher_counts[name] + teacher_train_counts[name]
                         + online_counts[name] + verify_counts[name]
                         + ddp_counts[name] + dense_chunked_counts[name]
                         + demo_counts[name] + studies_counts[name]
                         + workflow_counts[name] + graft_counts[name]
                         + probe_counts[name]),
            "max_abs_err": errs[name], "ms": timings[name][0],
            "plain_ms": timings[name][1], "bound_ms": bound,
            "bound_by": bound_by,
            "library_ms": timings[name][2] if name in library else None})
        print(f"  {card}: {name}: {timings[name][0]:.5f} ms against a bound "
              f"of {bound:.5f} ms ({bound_by}; {bound / timings[name][0]:.1%} "
              f"of it), library call: {library.get(name)}")
    for name, (k, p, lib, nbytes, err) in epilogue_rows.items():
        bound, bound_by = bound_ms(nbytes, 0)
        kernels.append({
            "name": name, "route": "cuda",
            "source": source + "teacher_epilogue.cu", "replaces": None,
            "launches": epilogue_launches.get(name, 0), "max_abs_err": err,
            "ms": k, "plain_ms": p, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib})
        print(f"  {card}: {name}: {k:.5f} ms against a bound of {bound:.5f} "
              f"ms ({bound_by}; {bound / k:.1%} of it), library call: "
              f"F.batch_norm and what follows it, eagerly")
    for (name, (k, p, lib, nbytes, err)), names in zip(
            train_bn_rows.items(), (TRAIN_BN_NAMES[:3], TRAIN_BN_NAMES[3:])):
        bound, bound_by = bound_ms(nbytes, 0)
        kernels.append({
            "name": name, "route": "cuda",
            "source": source + "train_bn.cu", "replaces": None,
            "launches": sum(bn_launches.get(n, 0) for n in names),
            "max_abs_err": err,
            "ms": k, "plain_ms": p, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": lib})
        print(f"  {card}: {name}: {k:.5f} ms against a bound of {bound:.5f} "
              f"ms ({bound_by}; {bound / k:.1%} of it), library call: "
              f"F.batch_norm(training=True) and F.relu")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(sys.argv[2:]))
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", flush=True)
        sys.exit(1)
