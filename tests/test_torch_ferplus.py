"""The port's ``data/ferplus.py`` against the JAX package's, bit for bit.

The same csv files, vote tables and seeds through both copies:
``parse_ferplus_csvs`` (with and without ``limit``, all-NF rows dropped),
``vote_distributions`` for the three dataTypes, the official FERPlus label
processing (every mode, on random and hand-picked vote rows, and its
refusal of an unknown mode), ``clean_subset`` under both rules,
``build_synthetic_ferplus`` and ``ferplus_batches`` (shuffled, ragged or
dropped tail, each dataType, host augmentation at 48 and straight to the
network size). Every array equal, dtypes included.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from mcncrossmodalemotions_torch.data import ferplus
from mcncrossmodalemotions_tpu.data import ferplus as jferplus


def _same(a, b, what=""):
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f.name)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _csvs(tmp_path, n: int = 30, seed: int = 0):
    """A fer2013.csv / fer2013new.csv pair: 48x48 pixel strings, the three
    usages, vote rows with some all-NF/unknown ones."""
    rng = np.random.RandomState(seed)
    usages = ["Training", "PublicTest", "PrivateTest"]
    fer, plus = tmp_path / "fer2013.csv", tmp_path / "fer2013new.csv"
    with open(fer, "w") as f:
        f.write("emotion,pixels,Usage\n")
        for i in range(n):
            pix = " ".join(str(v) for v in rng.randint(0, 256, 48 * 48))
            f.write(f"{rng.randint(0, 7)},{pix},{usages[i % 3]}\n")
    with open(plus, "w") as f:
        f.write("Usage,Image name,neutral,happiness,surprise,sadness,anger,"
                "disgust,fear,contempt,unknown,NF\n")
        for i in range(n):
            votes = rng.randint(0, 4, 10)
            if i % 7 == 3:
                votes[:8] = 0  # all mass on unknown/NF: dropped
            f.write(f"{usages[i % 3]},fer{i:07d}.png,"
                    + ",".join(str(v) for v in votes) + "\n")
    return fer, plus


@pytest.mark.parametrize("limit", [None, 11])
def test_parse_ferplus_csvs_equal(tmp_path, limit):
    fer, plus = _csvs(tmp_path)
    got = ferplus.parse_ferplus_csvs(fer, plus, limit=limit)
    ref = jferplus.parse_ferplus_csvs(fer, plus, limit=limit)
    _same(got, ref)
    assert got.num_images < (limit or 30)  # the all-NF rows went
    assert ferplus.FERPLUS_VOTE_COLUMNS == jferplus.FERPLUS_VOTE_COLUMNS
    assert ferplus.IMAGE_SIZE == jferplus.IMAGE_SIZE == 48


@pytest.mark.parametrize("data_type", ["CNTK", "clean", "full"])
def test_vote_distributions_equal(data_type):
    votes = np.random.RandomState(1).randint(0, 5, (50, 10)).astype(np.float32)
    votes[3] = 0  # no votes at all
    _same(ferplus.vote_distributions(votes, data_type),
          jferplus.vote_distributions(votes, data_type))


# rows that take the official rules' corners: strict majority or not, ties
# into unknown/NF at the top, eviction of an unknown at count 4, outliers
_ROWS = [[10, 0, 0, 0, 0, 0, 0, 0, 0, 0], [5, 5, 0, 0, 0, 0, 0, 0, 0, 0],
         [4, 3, 3, 0, 0, 0, 0, 0, 0, 0], [3, 3, 2, 0, 0, 0, 0, 0, 2, 0],
         [2, 2, 2, 2, 0, 0, 0, 0, 2, 0], [1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
         [0, 0, 0, 0, 0, 0, 0, 0, 6, 4], [6, 1, 0, 0, 0, 0, 0, 0, 3, 0],
         [3, 0, 0, 0, 0, 0, 0, 0, 3, 4], [0] * 10]


@pytest.mark.parametrize("mode", ["majority", "probability", "crossentropy",
                                  "multi_target"])
def test_official_label_processing_equal(mode):
    rng = np.random.RandomState(2)
    votes = np.concatenate([np.asarray(_ROWS, np.float32),
                            rng.randint(0, 6, (200, 10)).astype(np.float32)])
    for row in votes:
        _same(ferplus.process_votes_official(row, mode),
              jferplus.process_votes_official(row, mode))
    got, ref = (m.official_clean_labels(votes, mode)
                for m in (ferplus, jferplus))
    _same(got[0], ref[0])
    _same(got[1], ref[1])
    with pytest.raises(ValueError, match="unknown FERPlus mode"):
        ferplus.process_votes_official(votes[0], "median")


@pytest.mark.parametrize("rule,mode", [("official", "majority"),
                                       ("official", "crossentropy"),
                                       ("consensus", "majority")])
def test_clean_subset_equal(rule, mode):
    ours, theirs = (m.build_synthetic_ferplus(80, seed=4)
                    for m in (ferplus, jferplus))
    rng = np.random.RandomState(4)
    noise = rng.randint(0, 3, ours.votes.shape).astype(np.float32)
    ours.votes += noise
    theirs.votes += noise
    got = ferplus.clean_subset(ours, rule=rule, mode=mode)
    _same(got, jferplus.clean_subset(theirs, rule=rule, mode=mode))
    assert 0 < got.num_images < 80
    with pytest.raises(ValueError, match="unknown clean rule"):
        ferplus.clean_subset(ours, rule="loose")


@pytest.mark.parametrize("num,seed,size", [(120, 0, 48), (37, 5, 48),
                                           (10, 1, 20)])
def test_build_synthetic_ferplus_equal(num, seed, size):
    _same(ferplus.build_synthetic_ferplus(num, seed, size),
          jferplus.build_synthetic_ferplus(num, seed, size))


@pytest.mark.parametrize("kw", [
    dict(subset=1, batch_size=16),
    dict(subset=1, batch_size=16, shuffle=True, seed=3, drop_remainder=True),
    dict(subset=2, batch_size=7, data_type="full"),
    dict(subset=1, batch_size=16, shuffle=True, seed=9, augment=True),
    dict(subset=1, batch_size=10, seed=2, augment=True, augment_out_size=64),
    dict(subset=3, batch_size=32, data_type="clean"),
])
def test_ferplus_batches_equal(kw):
    ours, theirs = (m.build_synthetic_ferplus(90, seed=1)
                    for m in (ferplus, jferplus))
    got = list(ferplus.ferplus_batches(ours, **kw))
    ref = list(jferplus.ferplus_batches(theirs, **kw))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert sorted(a) == sorted(b) == ["data", "hard_label", "label_dist"]
        for key in a:
            _same(a[key], b[key], key)
    if kw.get("augment_out_size"):
        assert got[0]["data"].shape[1:] == (64, 64, 1)
