"""The port's integration entry (``mcncrossmodalemotions_torch/
graft_entry.py``) against ``__graft_entry__.py`` on the CPU.

- ``entry(device="cpu")``: the forward's output has the shape and dtype of
  ``jax.eval_shape`` of the JAX entry (shape only: a full-width JAX CPU
  compile takes minutes), its example parameters and running statistics
  are zeros of the JAX entry's sizes, and the port's forward at the
  entry's full shapes is finite;
- ``dryrun_multichip(2, device="cpu")``: two gloo rank processes pass the
  four checks (a sharded SGD step, the fused online step, ``Trainer.fit``
  for two epochs with a ragged tail and its resume to a third), print
  them in the JAX wording, and agree bitwise after each stage;
- a rank that fails makes the parent raise with that rank's error, even
  while another rank is still running;
- more NCCL ranks than cards raise before any process starts.

The spawned runs take about 20 s of one worker at two torch threads a
rank.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import __graft_entry__ as jentry  # noqa: E402
from mcncrossmodalemotions_torch import graft_entry  # noqa: E402

CHECK_LINES = ("dryrun_multichip(2): ok, loss=",
               "dryrun_multichip(2): fused online step ok, loss=",
               "dryrun_multichip(2): Trainer.fit 2 epochs ok (3 batches/epoch "
               "incl. ragged tail, losses=",
               "dryrun_multichip(2): checkpoint resume -> epoch 3 ok, loss=")


@pytest.fixture(scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_entry_matches_the_jax_entry(few_threads):
    fn, args = graft_entry.entry("cpu")
    out = fn(*args)
    jfn, jargs = jentry.entry()
    want = jax.eval_shape(jfn, *jargs)
    assert tuple(out.shape) == tuple(want.shape) == (8, 8)
    assert str(out.dtype).split(".")[-1] == str(want.dtype)
    assert bool(torch.isfinite(out).all())
    variables, wav = args
    np.testing.assert_array_equal(wav.numpy(), np.asarray(jargs[1]))
    assert all(not v.any() for v in variables.values())
    sizes = sum(v.numel() for k, v in variables.items()
                if not k.endswith("num_batches_tracked"))
    assert sizes == sum(int(np.prod(leaf.shape))
                        for leaf in jax.tree.leaves(jargs[0]))


def test_entry_forward_with_weights_is_finite(few_threads):
    """The zero weights give zero logits; with the student's scratch init
    the same forward at the entry's full shapes is finite and not zero."""
    fn, (variables, wav) = graft_entry.entry("cpu")
    gen = torch.Generator().manual_seed(0)
    weights = {k: torch.randn(v.shape, generator=gen) * 0.05
               if v.is_floating_point() and not k.endswith("running_var")
               else (torch.ones_like(v) if k.endswith("running_var") else v)
               for k, v in variables.items()}
    out = fn(weights, wav)
    assert out.shape == (8, 8) and bool(torch.isfinite(out).all())
    assert bool(out.abs().sum() > 0)


def test_dryrun_two_ranks_on_the_cpu(capsys):
    records = graft_entry.dryrun_multichip(2, device="cpu")
    printed = capsys.readouterr().out
    for line in CHECK_LINES:
        assert line in printed, (line, printed)
    assert [r["rank"] for r in records] == [0, 1]
    assert all(r["backend"] == "gloo" and r["device"] == "cpu"
               for r in records)
    assert records[0]["digests"] == records[1]["digests"]
    assert len(records[0]["digests"]) == 4
    assert records[0]["losses"] == records[1]["losses"]
    losses = records[0]["losses"]
    assert np.isfinite([losses["step"], losses["fused"], losses["resume"]]
                       + losses["fit"]).all()
    # CPU tensors run the plain versions: no kernel launches
    assert all(not any(r["launches"].values()) for r in records)
    assert set(records[0]["launches"]) == {
        "spectrogram", "max_pool_3x3s2", "max_pool_3x3s2_idx",
        "max_pool_3x3s2_bwd"}


def test_a_failing_rank_makes_the_parent_raise(tmp_path):
    """Rank 1 raises while rank 0 waits as in a collective: the parent
    stops rank 0 and raises with rank 1's error."""
    def command(rank, port):
        code = ("import time; time.sleep(120)" if rank == 0
                else "raise ValueError('rank one cannot go on')")
        return [sys.executable, "-c", code]

    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        graft_entry.spawn_ranks(command, 2, tmp_path, timeout=60)
    assert "rank one cannot go on" in str(err.value)


def test_a_rank_that_cannot_join_fails_the_dry_run(monkeypatch):
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "no-such-interface0")
    with pytest.raises(RuntimeError, match="rank [01] of 2 failed"):
        graft_entry.dryrun_multichip(2, device="cpu")


def test_too_few_cards_raise_before_spawning(monkeypatch):
    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(graft_entry.subprocess, "Popen", no_spawn)
    with pytest.raises(ValueError, match="2 NCCL ranks need 2 cards, this "
                                         "host has 1"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(ValueError, match="needs gloo"):
        graft_entry.dryrun_multichip(2, device="cpu", backend="nccl")
    # ranks that share the card over gloo are started
    with pytest.raises(AssertionError, match="a rank was started"):
        graft_entry.dryrun_multichip(2, backend="gloo")


def test_entry_and_dry_run_run_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA device"):
        graft_entry.dryrun_multichip(1)
