"""FER2013+ dataset construction (``getFerPlusImdb`` equivalent).

The port's own copy of ``mcncrossmodalemotions_tpu/data/ferplus.py``
(numpy and csv only): for the same files and seeds every function returns
what the original does, bit for bit (``tests/test_torch_ferplus.py``).

Parses the public csv pair into the FerPlusImdb schema:

- ``fer2013.csv``: emotion,pixels,Usage — 48x48 grayscale pixel strings
  with the original FER2013 labels and Training/PublicTest/PrivateTest
  splits.
- ``fer2013new.csv`` (FERPlus): Usage,Image name,neutral,happiness,
  surprise,sadness,anger,disgust,fear,contempt,unknown,NF — 10 rater
  vote counts per image.

Reference semantics (ferplus_baselines.m:153-221): the 'CNTK' dataType
keeps the 8 emotion columns (NF/unknown dropped, :167-172); hard label =
majority vote; images whose votes are all NF/unknown are excluded;
sets map Training->1, PublicTest->2 (val), PrivateTest->3 (test).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional

import numpy as np

from mcncrossmodalemotions_torch import EMOTIONS
from mcncrossmodalemotions_torch.data.imdb import FerPlusImdb
from mcncrossmodalemotions_torch.ops.warp import augment_batch_np

FERPLUS_VOTE_COLUMNS = EMOTIONS + ("unknown", "NF")
_USAGE_TO_SET = {"Training": 1, "PublicTest": 2, "PrivateTest": 3}
IMAGE_SIZE = 48


def parse_ferplus_csvs(fer_csv: str | Path, ferplus_csv: str | Path,
                       limit: Optional[int] = None) -> FerPlusImdb:
    """Join fer2013.csv pixels with fer2013new.csv votes row-by-row."""
    pixels, sets = [], []
    with open(fer_csv) as f:
        reader = csv.reader(f)
        header = next(reader)
        pix_col = header.index("pixels")
        usage_col = header.index("Usage")
        for row in reader:
            arr = np.asarray(row[pix_col].split(), np.uint8)
            pixels.append(arr.reshape(IMAGE_SIZE, IMAGE_SIZE))
            sets.append(_USAGE_TO_SET[row[usage_col]])
            if limit and len(pixels) >= limit:
                break
    votes = []
    with open(ferplus_csv) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            votes.append(np.asarray(row[2:12], np.float32))
            if limit and len(votes) >= limit:
                break
    assert len(pixels) == len(votes), (len(pixels), len(votes))
    data = np.stack(pixels)[..., None]  # [N, 48, 48, 1]
    votes = np.stack(votes)  # [N, 10]
    sets = np.asarray(sets, np.int32)
    # Exclude images with no emotion votes (all mass on unknown/NF).
    emo_votes = votes[:, :8]
    keep = emo_votes.sum(axis=1) > 0
    data, votes, sets, emo_votes = (
        data[keep], votes[keep], sets[keep], emo_votes[keep]
    )
    hard = emo_votes.argmax(axis=1).astype(np.int32)
    return FerPlusImdb(data=data, hard_labels=hard, votes=votes,
                       set_id=sets, classes=EMOTIONS)


def vote_distributions(votes: np.ndarray, data_type: str = "CNTK") -> np.ndarray:
    """Normalise rater votes to class distributions.

    ``data_type in ('CNTK', 'clean')`` keeps the 8 emotion columns
    (NF/unknown dropped — ferplus_baselines.m:167-172, both 8-class
    labelling schemes, :87-90/:161-163); ``'full'`` keeps all 10 columns
    (the reference's 10-class dataType, ferplus_baselines.m:91).
    """
    cols = 10 if data_type == "full" else 8
    emo = votes[:, :cols].astype(np.float32)
    total = emo.sum(axis=1, keepdims=True)
    return emo / np.maximum(total, 1e-8)


def process_votes_official(votes_row: np.ndarray,
                           mode: str = "majority") -> np.ndarray:
    """One image's FERPlus official label processing (Barsoum et al.).

    Implements the published label-cleaning of "Training Deep Networks
    for Facial Expression Recognition with Crowd-Sourced Label
    Distribution" (Barsoum, Zhang, Canton Ferrer, Zhang; ICMI 2016,
    arXiv:1608.01041) as released in the FERPlus repository's
    ``_process_data``, including its quirks:

    1. **Outlier removal**: zero every count below ``1 + 1% of the
       remaining total`` — the published loop re-sums *inside* the
       condition, so zeroing lowers the threshold for later columns
       (order-dependent in principle; with FER+'s 10-rater integer
       counts it reduces to "drop single votes").
    2. Per-mode distribution over the 10 columns (8 emotions + unknown
       + NF), with all-mass-on-unknown as the discard signal:

       - ``majority``: the top class keeps its count iff it holds a
         strict majority of the remaining votes; otherwise unknown.
       - ``probability`` / ``crossentropy``: greedily take top classes
         until 75 % of the votes are covered or 3 classes are taken;
         hitting unknown/NF at the top stops the take — and if real
         emotions already lead, the unknown/NF take is rolled back
         (both its mass and its ``count``, so an eviction at count 4
         does NOT trip the discard); if the kept mass is <= 50 % of
         the votes, or more than 3 real classes tied in, the image is
         unknown. Semantics pinned by a 10k-table differential fuzz
         against an independent transliteration of the official code
         (tests/ferplus_official_oracle.py).
       - ``multi_target``: keep every class holding >= 30 % of the
         votes; unknown unless some class holds >= 50 %.

    Returns the normalised [10] distribution; a result peaking on
    column 8 (unknown) marks the image for discard (the official readers
    skip images whose argmax is not a real emotion).

    The reference's 'clean' dataType delegates to mcnDatasets'
    getFerPlusImdb (external; ferplus_baselines.m:27-29,87-92), which
    follows these official FERPlus rules — reimplemented here from the
    paper/public release, not from that repo.
    """
    raw = [float(v) for v in votes_row]
    size = len(raw)
    unknown = [0.0] * size
    unknown[-2] = 1.0
    # (1) outlier removal, published inline-re-sum semantics
    for i in range(size):
        if raw[i] < 1.0 + sum(raw) * 0.01:
            raw[i] = 0.0
    sum_list = sum(raw)
    emotion = [0.0] * size
    if sum_list <= 0:
        emotion = unknown
    elif mode == "majority":
        maxval = max(raw)
        if maxval > 0.5 * sum_list:
            emotion[int(np.argmax(raw))] = maxval
        else:
            emotion = unknown
    elif mode in ("probability", "crossentropy"):
        sum_part, count, valid = 0.0, 0, True
        while sum_part < 0.75 * sum_list and count < 3 and valid:
            maxval = max(raw)
            for i in range(size):
                if raw[i] == maxval:
                    emotion[i] = maxval
                    raw[i] = 0.0
                    sum_part += maxval
                    count += 1
                    if i >= 8:  # unknown/NF tied into the take
                        valid = False
                        if sum(emotion) > maxval:  # real emotions lead
                            emotion[i] = 0.0
                            # official code rolls back count, NOT
                            # sum_part (sum_part is dead here: valid
                            # already ends the while loop) — so an
                            # unknown evicted at count 4 leaves count 3
                            # and the sample SURVIVES the count>3
                            # discard. Round-4 had this inverted; the
                            # differential fuzz vs the independent
                            # oracle (tests/ferplus_official_oracle.py)
                            # caught it on eviction-at-count-4 tables.
                            count -= 1
                        break
        if sum(emotion) <= 0.5 * sum_list or count > 3:
            emotion = unknown
    elif mode == "multi_target":
        threshold = 0.3
        for i in range(size):
            if raw[i] >= threshold * sum_list:
                emotion[i] = raw[i]
        if max(emotion) < 0.5 * sum_list:
            emotion = unknown
    else:
        raise ValueError(f"unknown FERPlus mode {mode!r}; choose from "
                         "majority | probability | crossentropy | "
                         "multi_target")
    total = sum(emotion)
    return np.asarray([e / total for e in emotion], np.float32)


def official_clean_labels(votes: np.ndarray, mode: str = "majority"):
    """Vectorised official processing: (distributions [N, 10], keep mask).

    ``keep`` is True where the processed distribution peaks on a real
    emotion (argmax < 8) — the official readers' skip rule.
    """
    dists = np.stack([process_votes_official(row, mode) for row in votes])
    keep = dists.argmax(axis=1) < 8
    return dists, keep


def clean_subset(imdb: FerPlusImdb, rule: str = "official",
                 mode: str = "majority",
                 min_consensus: float = 0.5) -> FerPlusImdb:
    """The 'clean' dataType's aggressive filtering (ferplus_baselines.m:
    27-29: "the dataset has been quite aggressively cleaned").

    ``rule='official'`` (default) applies the FERPlus release's
    published label-cleaning (:func:`process_votes_official`,
    Barsoum et al. 2016): outlier votes removed, images whose processed
    label is unknown/NF discarded, and ``hard_labels`` REWRITTEN to the
    processed majority class (outlier-removed argmax), which can differ
    from the raw-vote argmax. Raw ``votes`` are kept for the surviving
    rows so the 'distributions' loss still sees rater mass.

    ``rule='consensus'`` keeps the earlier in-repo approximation as a
    documented fallback: the majority EMOTION must hold at least
    ``min_consensus`` of the TOTAL votes (heavy NF/unknown mass also
    disqualifies); labels are left untouched.
    """
    if rule == "consensus":
        emo = imdb.votes[:, :8].astype(np.float64)
        total = imdb.votes.sum(axis=1)
        keep = emo.max(axis=1) >= min_consensus * np.maximum(total, 1e-8)
        return imdb.subset(np.where(keep)[0])
    if rule != "official":
        raise ValueError(f"unknown clean rule {rule!r}: "
                         "official | consensus")
    dists, keep = official_clean_labels(imdb.votes, mode)
    idx = np.where(keep)[0]
    out = imdb.subset(idx)
    out.hard_labels[:] = dists[idx, :8].argmax(axis=1).astype(np.int32)
    return out


def build_synthetic_ferplus(num_images: int = 120, seed: int = 0,
                            image_size: int = IMAGE_SIZE) -> FerPlusImdb:
    """Synthetic FER+ mini-imdb (the opts.dev pattern, ferplus_baselines.m:59).

    Each image's dominant emotion drives a distinctive gradient pattern so
    tiny teachers can overfit it in tests.
    """
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 8, num_images)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32)
    data = np.zeros((num_images, image_size, image_size, 1), np.uint8)
    votes = np.zeros((num_images, 10), np.float32)
    for i, lab in enumerate(labels):
        pattern = 127 + 120 * np.sin(
            2 * np.pi * (lab + 1) * (xx + (lab % 3) * yy) / (8 * image_size)
        )
        noise = rng.randn(image_size, image_size) * 10
        data[i, :, :, 0] = np.clip(pattern + noise, 0, 255).astype(np.uint8)
        votes[i, lab] = 7 + rng.randint(0, 3)
        other = rng.randint(0, 8)
        votes[i, other] += 2
        labels[i] = votes[i, :8].argmax()
    n_train = int(num_images * 0.7)
    n_val = int(num_images * 0.15)
    sets = np.full(num_images, 3, np.int32)
    sets[:n_train] = 1
    sets[n_train:n_train + n_val] = 2
    return FerPlusImdb(data=data, hard_labels=labels.astype(np.int32),
                       votes=votes, set_id=sets, classes=EMOTIONS)


def ferplus_batches(imdb: FerPlusImdb, subset: int, batch_size: int,
                    shuffle: bool = False, seed: int = 0,
                    drop_remainder: bool = False,
                    data_type: str = "CNTK",
                    augment: bool = False,
                    augment_out_size=None):
    """Yield host batches: uint8 images + hard labels + vote distributions.

    The host ships native-resolution (48x48) uint8 — 2.3 kB/image. With
    ``augment=True`` (train) the zoom/rotate/skew affine warp runs HERE at
    48x48 (computeAugs parameters, applied to a random half of each
    batch, ferplus_baselines.m:194-199,232-268); fliplr, the resize to
    network resolution and normalisation run on device inside the teacher
    pipeline. See models/teacher_pipeline.py for why the affine part is
    host-side.
    """
    idx = np.where(imdb.set_id == subset)[0]
    rng = np.random.RandomState(seed)
    if shuffle:
        idx = rng.permutation(idx)
    for i in range(0, len(idx), batch_size):
        chunk = idx[i:i + batch_size]
        if drop_remainder and len(chunk) < batch_size:
            break
        data = imdb.data[chunk]
        if augment:
            data = augment_batch_np(data, rng, out_size=augment_out_size)
        yield {
            "data": data,
            "hard_label": imdb.hard_labels[chunk],
            "label_dist": vote_distributions(imdb.votes[chunk], data_type),
        }
