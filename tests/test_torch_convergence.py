"""Distillation learns, on the port: the JAX package's convergence
regression (``tests/test_full_workflow.py::
test_distillation_convergence_regression``) and a short run of the
full-scale demo (``tools/run_demo.py``), on the CPU with torch at two
threads.
"""

from __future__ import annotations

import json

import pytest
import torch

from mcncrossmodalemotions_torch.tools import run_demo, sweep_convergence


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_distillation_convergence_regression(tmp_path):
    """A seeded tiny-student run on the synthetic imdb (6 speakers x 8
    tracks, seed 0; 12 epochs of batch 8 over 2 s crops at lr 0.1 ->
    0.03; ``sweep_convergence.run_seed``, the JAX test's recipe) must end
    at a train loss below 1.9 (from ln 8 = 2.079), with a lower train
    classerror than its first epoch's, and reach unheardVal meanAuc above
    0.7 on the speaker it never saw: the paper's claim, as CI.

    The margins, from ``python -m mcncrossmodalemotions_torch.tools.
    sweep_convergence 0 1 2 3 4 5 6 7 8 9 10 11 --device cpu`` (two threads)
    (12 training seeds, the imdb at its seed 0)::

      seed  first_err  final_loss  final_err  unheardVal_meanAuc  heardVal_meanAuc
         0     0.7812      1.4049     0.4062              0.8571            0.6944
         1     0.8750      1.4592     0.4375              0.8571            0.6944
         2     0.9375      1.4553     0.5000              1.0000            0.7778
         3     0.9375      1.4725     0.5312              1.0000            0.9167
         4     0.8438      1.5612     0.5938              0.8452            0.8056
         5     0.9062      1.3840     0.3438              0.8571            0.6944
         6     0.9688      1.5202     0.5000              0.8571            0.7500
         7     0.8125      1.3656     0.4062              1.0000            0.6944
         8     0.8750      1.4092     0.4062              0.8571            0.6944
         9     0.9062      1.4722     0.4375              0.8571            0.6944
        10     0.8750      1.3311     0.4062              1.0000            0.9167
        11     0.8125      1.4789     0.4688              0.8571            0.7500

    The worst seed is 4 on every gate: loss 1.5612 (margin 0.339 under
    1.9), classerror down 0.25 (0.8438 -> 0.5938), unheardVal meanAuc
    0.8452 (margin 0.145 over 0.7). The JAX package's sweep
    (``tools/sweep_convergence.py``) found loss 1.286-1.578 and meanAuc
    0.857-1.000 over its 12 seeds; every gate holds on every seed here.
    """
    row = sweep_convergence.run_seed(0, work=tmp_path, device="cpu")
    history = row["history"]
    assert [e for e, _, _ in history] == list(range(1, 13))
    assert row["final_loss"] < 1.9, (
        f"final train loss {row['final_loss']:.3f} >= 1.9: distillation is "
        "not descending (the loss, batcher or engine regressed)")
    assert history[-1][2] < history[0][2], "train classerror did not fall"
    assert row["unheardVal_meanAuc"] > 0.7, (
        f"unheardVal meanAuc {row['unheardVal_meanAuc']:.3f} <= 0.7: "
        "distillation stopped learning")


def test_run_demo_writes_its_result(tmp_path):
    out = run_demo.main(tmp_path, device="cpu", num_epochs=2, num_speakers=4,
                        tracks_per_speaker=8, tiny=True)
    saved = json.loads((tmp_path / "demo_result.json").read_text())
    assert saved == out
    assert sorted(saved) == ["aucs", "trajectory", "wall_s"]
    assert [t["epoch"] for t in saved["trajectory"]] == [1, 2]
    assert all(sorted(t) == ["epoch", "train_err", "train_loss", "val_err"]
               for t in saved["trajectory"])
    assert sorted(saved["aucs"]) == ["heardVal", "train", "unheardVal"]
    assert all("meanAuc" in a for a in saved["aucs"].values())
