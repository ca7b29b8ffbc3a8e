"""Each cell end to end at its tiny ``rehearse`` size on the CPU (the
harness's test switch; the program's plain paths stand in for its
kernels): a run prints a well-formed result and comes out correct; the
control (the reference in float8 in the program's place) and every fault
the cell can have, planted in the program underneath the timed path, come
out not correct; a measuring run without a card fails without a result.
"""

import json
import time

import numpy as np
import pytest
import torch

from perfbench.harness import cli
from perfbench.tests.cells import CELLS, load as load_cell

TRAINING = [c for c in CELLS if load_cell(c).workload["driver"] in ("distill", "fertrain")]
SERVING = [c for c in CELLS if c not in TRAINING]
SEED = 3_000_000_013


def rehearse(cell, trace=False, variants=(None,), seconds=0.5):
    c = load_cell(cell, rehearse=True)
    cli.set_cache_dirs()
    out = cli.execute(c, SEED, seconds, trace, torch.device("cpu"), True,
                      time.perf_counter(), variants)
    return c, cli.result_line(c, out, trace, torch.device("cpu"), c.chips)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_rehearses_correct(cell, trace):
    c, res = rehearse(cell, trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        assert set(res["metrics"]) <= {m["name"] for m in c.per_layer}
        assert "breakdown" in res and "window_s" in res["device"]
    else:
        assert set(res["metrics"]) == {m["name"] for m in c.end_to_end}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    _, res = rehearse(cell, variants=("control",))
    assert not res["correct"], res["checks"]


def _keep_state(*args, **kwargs):
    return None


@pytest.mark.parametrize("cell", TRAINING)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(cell, monkeypatch):
    from mcncrossmodalemotions_torch.train import state

    monkeypatch.setattr(state, "apply_sgd_update", _keep_state)
    _, res = rehearse(cell)
    assert not res["correct"]
    change = next(k for k in res["checks"] if k.endswith("update_gap"))
    assert res["checks"][change]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAINING)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    from mcncrossmodalemotions_torch.train.engine import Trainer

    host_batch = Trainer._host_batch

    def half(self, batch, pin):
        n, host = host_batch(self, batch, pin)
        keep = host["pad_mask"].clone()
        keep[keep.shape[0] // 2:] = 0
        return int(keep.sum()), dict(host, pad_mask=keep)

    monkeypatch.setattr(Trainer, "_host_batch", half)
    _, res = rehearse(cell)
    assert not res["correct"], res["checks"]


def _patch_answers(monkeypatch, cell, how):
    if load_cell(cell).workload["driver"] == "extract":
        from mcncrossmodalemotions_torch.exp.compute_audio_feats import (
            AudioFeatureExtractor as cls)
        name = "track_logits"
    else:
        from mcncrossmodalemotions_torch.exp.compute_visual_feats import (
            VisualFeatureExtractor as cls)
        name = "frame_logits"
    original = getattr(cls, name)

    def broken(self, paths, *args, **kwargs):
        return how(original(self, paths, *args, **kwargs))

    monkeypatch.setattr(cls, name, broken)


def _alter(out):
    out = list(out) if isinstance(out, list) else np.array(out)
    out[0] = np.asarray(out[0]) + 1.0
    return out


def _drop_half(out):
    if isinstance(out, list):
        return out[:len(out) // 2] + [None] * (len(out) - len(out) // 2)
    return out[:len(out) // 2]


@pytest.mark.parametrize("cell", SERVING)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    _patch_answers(monkeypatch, cell, _alter)
    _, res = rehearse(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", SERVING)
def test_half_the_answers_left_out_is_not_correct(cell, monkeypatch):
    _patch_answers(monkeypatch, cell, _drop_half)
    _, res = rehearse(cell)
    assert not res["correct"] and res["failed"] > 0


def test_a_measuring_run_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    rc = cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert "{" not in capsys.readouterr().out


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(cell, cuda_card):
    c = load_cell(cell)
    out = cli.execute(c, SEED, 5.0, False, cuda_card, False, time.perf_counter())
    res = cli.result_line(c, out, False, cuda_card, c.chips)
    assert res["correct"], res["checks"]
