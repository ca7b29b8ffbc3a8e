"""The port's epoch engine (``train/engine.py``) on the CPU, with a small
linear model in place of the student: feed attribution, the engine-level
``epoch_size`` cap, the zero-batch error, the NaN tripwire and the
torch.profiler trace."""

import json

import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch.train import engine
from mcncrossmodalemotions_torch.zoo import student_loss_fn


class _Linear(torch.nn.Module):
    """The forward contract the engine relies on, without the student."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 8)

    def reset_parameters(self, generator=None):
        torch.nn.init.normal_(self.fc.weight, 0.0, 0.1, generator=generator)
        torch.nn.init.zeros_(self.fc.bias)

    def forward(self, x, train=False, pad_mask=None, use_kernels=True,
                generator=None):
        return self.fc(x.float())


def _batches(n_batches, bsz=3, seed=0):
    rng = np.random.RandomState(seed)
    return [{"data": rng.randn(bsz, 4).astype(np.float32),
             "logit_target": rng.randn(bsz, 8).astype(np.float32),
             "max_label": rng.randint(0, 8, bsz).astype(np.int32)}
            for _ in range(n_batches)]


def _trainer(tmp_path, loss_fn=None, **cfg):
    cfg = engine.TrainConfig(exp_dir=str(tmp_path), learning_rate=0.1,
                             log_every=1, **cfg)
    return engine.Trainer(_Linear(), loss_fn or student_loss_fn(), cfg,
                          class_names=tuple("abcdefgh"), device="cpu")


def test_run_epoch_trains_and_attributes_the_wall(tmp_path):
    trainer = _trainer(tmp_path)
    state = trainer.init_state()
    losses = []
    for epoch in (1, 2, 3):
        state, stats = trainer.run_epoch(state, _batches(4), epoch)
        losses.append(stats["loss"])
    assert losses[-1] < losses[0] and state.step == 12
    assert stats["num_samples"] == 12
    for key in ("feed_wait_s", "device_drain_s", "feed_bound_frac",
                "samples_per_sec", "meanAcc", "aPop"):
        assert np.isfinite(stats[key]), key
    assert 0.0 <= stats["feed_bound_frac"] <= 1.0
    _, val = trainer.run_epoch(state, _batches(2), 3, train=False)
    assert val["num_samples"] == 6 and state.step == 12  # eval: no update


def test_epoch_size_caps_train_but_not_val(tmp_path):
    trainer = _trainer(tmp_path, epoch_size=5)
    state = trainer.init_state()
    state, stats = trainer.run_epoch(state, _batches(4), 1)
    assert stats["num_samples"] == 6  # stops at the first batch reaching 5
    _, val = trainer.run_epoch(state, _batches(4), 1, train=False)
    assert val["num_samples"] == 12


def test_pad_mask_rows_drop_out_of_the_count(tmp_path):
    trainer = _trainer(tmp_path)
    batches = _batches(2)
    batches[1]["pad_mask"] = np.array([1, 0, 0], np.float32)
    _, stats = trainer.run_epoch(trainer.init_state(), batches, 1)
    assert stats["num_samples"] == 4


def test_zero_batches_raise(tmp_path):
    trainer = _trainer(tmp_path)
    with pytest.raises(ValueError, match="ZERO batches"):
        trainer.run_epoch(trainer.init_state(), [], 1)


def test_nan_tripwire(tmp_path):
    def nan_loss(logits, batch):
        return logits.sum() * float("nan"), {}

    trainer = _trainer(tmp_path, loss_fn=nan_loss)
    with pytest.raises(FloatingPointError):
        trainer.run_epoch(trainer.init_state(), _batches(2), 1)


def test_producer_errors_surface(tmp_path):
    def broken():
        yield _batches(1)[0]
        raise OSError("unreadable wav")

    trainer = _trainer(tmp_path)
    with pytest.raises(OSError, match="unreadable wav"):
        trainer.run_epoch(trainer.init_state(), broken(), 1)


def test_profile_dir_writes_a_trace_of_epoch_one(tmp_path):
    trainer = _trainer(tmp_path, profile_dir=str(tmp_path / "prof"))
    state = trainer.init_state()
    trainer.run_epoch(state, _batches(2), 1)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
