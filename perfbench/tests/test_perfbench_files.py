"""Every file a cell names is found by its name, and BENCHMARK.json keeps
to the shape the harness reads."""

import json
import re

import numpy as np
import pytest

from perfbench.harness.spec import BENCH, ROOT, metric_reader
from perfbench.tests.cells import BENCHMARK, CELLS, MERGED, load as load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    c = load_cell(cell)
    entry = next(w for w in MERGED["workloads"] if w["name"] == cell)
    assert c.config["name"] == entry["config"]
    assert (BENCH / "drivers" / f"{c.workload['driver']}.py").is_file()
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) == 2 and c.per_layer
    assert set(c.workload["limits"]) and all(v > 0 for v in c.workload["limits"].values())


@pytest.mark.parametrize("metric", [m["name"] for m in MERGED["per_layer"]])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(metric_reader(metric).read)
    assert metric_reader(metric).read({}) is None


@pytest.mark.parametrize("config", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_each_config_file_is_under_paths(config):
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith("perfbench/")
    assert json.loads(path.read_text())["name"] == config["name"]


@pytest.mark.parametrize("bench", [BENCHMARK, MERGED], ids=["listed", "with_left_out"])
def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        mover = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mover.get("workloads", cells))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_traffic_sizes_do_not_depend_on_the_seed():
    from perfbench.traffic import generate

    mix = generate.load_mix("vox1-crops-b64")
    a = generate.durations(mix)
    assert len(a) == 1760 and a.min() >= 4.0 and a.max() <= 19.9
    assert abs(a.mean() - 8.2) < 0.2


def test_linked_tracks_keep_one_set_of_sizes_and_write_each_recording_once(tmp_path):
    from perfbench.traffic import generate

    mix = dict(generate.load_mix("vox1-crops-b64"), tracks=12, distinct=4)
    a = generate.wav_tracks(mix, 2_000_000_017, tmp_path / "a")
    b = generate.wav_tracks(mix, 5, tmp_path / "b")
    assert sorted(a.num_samples) == sorted(b.num_samples)
    assert len(set(a.rel_paths)) == 12 and np.bincount(np.unique(
        a.num_samples, return_inverse=True)[1]).tolist() == [3] * 4
    inodes = {(tmp_path / "a" / p).stat().st_ino for p in a.rel_paths}
    assert len(inodes) == 4
    assert a.bytes_written == int(np.unique(a.num_samples).sum() * 2 + 44 * 4)
    assert len({lg.tobytes() for lg in a.logits}) == 12
