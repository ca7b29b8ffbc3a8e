"""The port's throughput bench (``mcncrossmodalemotions_torch/bench.py``)
on the CPU, against the JAX package's ``bench.py``.

- The numerics gate passes on its own golden, fails on a perturbed loss or
  frontend and records nothing without a golden (``tests/
  test_bench_utils.py``'s checks); the numerics worker writes the golden
  in a fresh process.
- The port's ``_numerics_probe`` from JAX's tiny-student init (bridged by
  ``zoo/bridge.py``) against JAX's ``_numerics_probe``: frontend within
  1e-5 of its max (measured 2.0e-6) and losses within 1e-4 relative
  (measured 1.0e-6), ten and 500 times tighter than the bench's gates.
- Each sub-benchmark at small sizes with ``device="cpu"`` writes the keys
  its JAX counterpart writes (read from ``bench.py``'s source; the
  frontend's ``jnp``/``pallas`` become ``plain``/``kernel``), and each
  end-to-end worker's fields are its keymap's.
- ``main`` runs every sub-benchmark, prints the headline and exits 1 when
  one raises, a worker or the reader build fails or ``numerics_ok`` is not
  true; 2 without a CUDA device unless asked for the CPU; it writes only
  under ``--out-dir``. The reader probe reads through the port's own
  libraries and fails where they are switched off.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcncrossmodalemotions_torch import bench
from mcncrossmodalemotions_torch.ops.spectrogram import DEFAULT_SPEC
from mcncrossmodalemotions_torch.zoo import student_state_dict_from_flax
from mcncrossmodalemotions_tpu.zoo import build_student as jbuild_student

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jbench():
    """The JAX package's ``bench.py``, loaded as ``tests/test_bench_utils.py``
    loads it."""
    spec = importlib.util.spec_from_file_location("jax_bench_module",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules["jax_bench_module"] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


PROBE = {"frontend": np.linspace(-2.0, 2.0, 64).reshape(2, 32),
         "losses": np.asarray([2.08, 2.05, 2.01], np.float64)}


def test_numerics_gate_passes_self_and_fails_perturbed(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "_numerics_probe", lambda device: PROBE)
    good = tmp_path / "golden.npz"
    np.savez(good, **PROBE)
    details = {}
    bench.bench_numerics(details, str(good), "cpu")
    assert details["numerics_ok"] is True
    assert details["numerics_frontend_rel"] == 0.0
    assert details["numerics_loss_rel"] == 0.0

    bad = tmp_path / "bad.npz"
    np.savez(bad, frontend=PROBE["frontend"],
             losses=PROBE["losses"] * (1 + 2 * bench._NUMERICS_LOSS_RTOL))
    details = {}
    bench.bench_numerics(details, str(bad), "cpu")
    assert details["numerics_ok"] is False

    bad2 = tmp_path / "bad2.npz"
    np.savez(bad2, losses=PROBE["losses"], frontend=PROBE["frontend"]
             + 2 * bench._NUMERICS_FRONTEND_RTOL * 2.0)
    details = {}
    bench.bench_numerics(details, str(bad2), "cpu")
    assert details["numerics_ok"] is False

    details = {}
    bench.bench_numerics(details, str(tmp_path / "absent.npz"), "cpu")
    assert details == {}
    bench.bench_numerics(details, None, "cpu")
    assert details == {}


def test_numerics_tolerances_are_jaxs(jbench):
    assert bench._NUMERICS_FRONTEND_RTOL == jbench._NUMERICS_FRONTEND_RTOL
    assert bench._NUMERICS_LOSS_RTOL == jbench._NUMERICS_LOSS_RTOL


def test_numerics_worker_writes_the_cpu_golden(tmp_path):
    path = tmp_path / "golden.npz"
    assert bench._run_worker(["--numerics-worker", str(path)], "cpu") == {
        "golden": str(path)}
    golden = np.load(path)
    assert golden["frontend"].shape == (2, 512, 100, 1)
    assert golden["losses"].shape == (3,)
    # another process's MKL may sum the DFT in another order: the DC bin
    # (pre-emphasis leaves 3% of it) has moved by 3e-4 relative, within
    # the gate
    details = {}
    bench.bench_numerics(details, path, "cpu")
    assert details["numerics_ok"] is True


def test_numerics_probe_equals_jaxs_on_jaxs_init(jbench):
    want = jbench._numerics_probe()
    wav = np.random.RandomState(0).randn(
        2, DEFAULT_SPEC.crop_samples(100)).astype(np.float32) * 0.1
    init = jax.jit(jbuild_student(tiny=True).init)(jax.random.PRNGKey(0),
                                                   jnp.asarray(wav))
    got = bench._numerics_probe("cpu",
                                variables=student_state_dict_from_flax(init))
    scale = float(np.abs(want["frontend"]).max())
    front = float(np.abs(got["frontend"] - want["frontend"]).max()) / scale
    loss = float(np.max(np.abs(got["losses"] - want["losses"])
                        / np.abs(want["losses"])))
    print(f"frontend rel {front:.3e}, losses rel {loss:.3e}")
    assert got["frontend"].shape == want["frontend"].shape
    assert front <= 1e-5
    assert loss <= 1e-4


def _jax_keys(name: str) -> set:
    """The ``details[...]`` keys ``bench.py``'s function ``name`` writes,
    its frontend's f-string keys under the port's names."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    keys = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                and getattr(node.value, "id", None) == "details"):
            if isinstance(node.slice, ast.Constant):
                keys.add(node.slice.value)
            else:  # f"frontend_{name}_ms" over ("jnp", ...), ("pallas", ...)
                keys |= {"frontend_plain_ms", "frontend_kernel_ms"}
    return keys


SMALL = {
    "bench_train_step": dict(batch_size=2, num_frames=100, tiny=True, iters=1),
    "bench_frontend": dict(batch_size=2, num_frames=100, iters=1),
    "bench_teacher": dict(batch_size=2, tiny=True, iters=1),
    "bench_fused_online": dict(batch_size=2, num_frames=100, tiny=True,
                               iters=1),
    "bench_dense_inference": dict(num_frames=6, frame_size=40, batch_size=4,
                                  tiny=True),
    "bench_audio_feats": dict(num_speakers=2, tracks_per_speaker=2, tiny=True),
}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_sub_benchmarks_write_the_jax_keys(name, tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    details = {"device_kind": "NVIDIA H100 80GB HBM3"}  # a card in the table
    getattr(bench, name)(details, "cpu", **SMALL[name])
    # its frames and wavs removed (torch may leave its own caches there)
    assert not list(tmp_path.glob("bench_*"))
    written = set(details) - {"device_kind"}
    want = _jax_keys(name) - {"device_kind"}  # main() writes it here
    assert written == want, (written, want)
    # (mfu_estimate rounds to 0.0 at the CPU's pace)
    assert all(np.isfinite(v) and v >= 0 for k, v in details.items()
               if k != "device_kind"), details


@pytest.mark.parametrize("flag", sorted(bench.E2E_KEYMAPS))
def test_end_to_end_workers_fill_their_keymaps(jbench, flag, tmp_path,
                                               monkeypatch):
    import inspect

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    small = dict(num_speakers=2, tracks_per_speaker=3, batch_size=2, tiny=True)
    res = (bench._online_epoch_worker("cpu", **small) if flag == "online"
           else bench._e2e_epoch_worker(flag == "mulaw8", "cpu", **small))
    assert not list(tmp_path.glob("bench_*"))  # its imdb and exp dir removed
    keys = bench.E2E_KEYMAPS[flag]
    assert set(res) == set(keys)
    assert len(set(keys.values())) == len(keys)
    assert res["num_samples"] == 6 and res["utts_per_sec"] > 0
    assert 0 <= res["feed_bound_frac"] <= 1
    if flag == "online":
        assert res["frames_per_crop"] == 2
    src = inspect.getsource(jbench.bench_end_to_end_epoch)
    assert all(f'"{k}"' in src for k in keys.values())


def _stub_main(monkeypatch, fail=(), numerics_ok=True):
    """Every measurement of ``main`` stubbed; ``fail`` names the ones that
    raise. Returns the names called, in order."""
    called = []

    def stub(name, fill=None):
        def fn(details, *args, **kwargs):
            called.append(name)
            if name in fail:
                raise RuntimeError(f"{name} broke")
            details.update(fill or {})
            return 100.0
        return fn

    def readers():
        called.append("readers")
        if "readers" in fail:
            raise RuntimeError("readers: g++ failed")

    monkeypatch.setattr(bench, "_ensure_readers_built", readers)

    def worker(args, device):
        name = args[1] if args[0] == "--e2e-worker" else "golden"
        called.append(name)
        if name in fail:
            raise RuntimeError(f"worker {name} died")
        if name == "golden":
            return {"golden": args[1]}
        return {"utts_per_sec": 5.0, "num_samples": 64}

    monkeypatch.setattr(bench, "_run_worker", worker)
    monkeypatch.setattr(bench, "bench_train_step", stub("train_step"))
    monkeypatch.setattr(bench, "bench_numerics",
                        stub("numerics", {"numerics_ok": numerics_ok}))
    monkeypatch.setattr(bench, "SUB_BENCHMARKS", tuple(
        (name, stub(name), full_only)
        for name, _, full_only in bench.SUB_BENCHMARKS))
    return called


def _run_main(argv, capsys):
    rc = bench.main(argv, device="cpu")
    out, err = capsys.readouterr()
    return rc, out.strip().splitlines(), err


def test_main_runs_everything_and_writes_under_its_out_dir(tmp_path, capsys,
                                                           monkeypatch):
    root_files = {p: p.read_bytes() for p in (REPO / "bench_details.json",
                                              REPO / "bench_history.jsonl")}
    called = _stub_main(monkeypatch)
    rc, out, _ = _run_main(["--full", "--out-dir", str(tmp_path)], capsys)
    assert rc == 0
    assert called == ["readers", "int16", "mulaw8", "online", "golden",
                      "train_step", "numerics", "frontend",
                      "teacher", "fused_online", "dense_inference",
                      "audio_feats"]
    headline = json.loads(out[-1])
    assert headline == {"metric": "distillation_train_throughput",
                        "value": 100.0, "unit": "utts/sec/chip"}
    details = json.loads((tmp_path / "bench_details.json").read_text())
    assert details["end_to_end_epoch_utts_per_sec"] == 5.0
    assert details["online_epoch_samples"] == 64
    assert not [k for k in details if "link" in k or k.endswith("_best")]
    assert (details["device_kind"], details["backend"]) == ("cpu", "cpu")
    rows = (tmp_path / "bench_history.jsonl").read_text().splitlines()
    assert len(rows) == 1 and json.loads(rows[0])["argv"][0] == "--full"
    called.clear()
    assert _run_main(["--quick", "--out-dir", str(tmp_path)], capsys)[0] == 0
    assert called == ["readers", "train_step"]
    assert len((tmp_path / "bench_history.jsonl").read_text()
               .splitlines()) == 2
    called.clear()
    assert _run_main(["--out-dir", str(tmp_path)], capsys)[0] == 0
    assert "teacher" not in called and "frontend" in called
    assert all(p.read_bytes() == b for p, b in root_files.items())


@pytest.mark.parametrize("fail", ["teacher", "train_step", "mulaw8",
                                  "readers", "golden", "numerics"])
def test_main_exits_1_on_any_failure(tmp_path, capsys, monkeypatch, fail):
    called = _stub_main(monkeypatch, fail=(fail,) if fail != "numerics" else (),
                        numerics_ok=fail != "numerics")
    rc, out, err = _run_main(["--full", "--out-dir", str(tmp_path)], capsys)
    assert rc == 1
    assert called[-1] == "audio_feats"  # every sub-benchmark still ran
    if fail == "train_step":
        assert not out  # no headline without its measurement
    else:
        assert json.loads(out[-1])["metric"] == "distillation_train_throughput"
    assert "bench FAILED" in err and (fail in err or "numerics_ok" in err)


def test_step_variants_feed_each_form_in_turns(monkeypatch):
    from mcncrossmodalemotions_torch.tools import step_variants
    from mcncrossmodalemotions_torch.train import state

    fed = []
    make = state.make_train_step

    def recording(loss_fn, sgd, pass_pad_mask=False, **kw):
        step = make(loss_fn, sgd, pass_pad_mask=pass_pad_mask, **kw)

        def run(st, batch, lr):
            if not fed or fed[-1][3] is not run:
                fed.append((batch["data"].dtype, "pad_mask" in batch,
                            pass_pad_mask, run))
            return step(st, batch, lr)
        return run

    monkeypatch.setattr(state, "make_train_step", recording)
    times = step_variants.main("cpu", iters=1, batch_size=2, num_frames=100,
                               tiny=True)
    forms = [(torch.float32, False), (torch.float32, True),
             (torch.int16, False), (torch.int16, True)]
    assert [(d, m) for d, m, _, _ in fed] == forms + forms[::-1]
    assert all(m == passed for _, m, passed, _ in fed)
    assert list(times) == list(step_variants.FORMS)
    assert all(len(t) == 2 and min(t) > 0 for t in times.values())


def test_readers_are_built_and_probed_or_the_bench_fails(monkeypatch):
    bench._ensure_readers_built()
    monkeypatch.setenv("MCNCME_DISABLE_NATIVE", "1")  # no Python fallback
    with pytest.raises(RuntimeError, match="reader probe"):
        bench._ensure_readers_built()


def test_main_without_a_card_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.main(["--quick", "--out-dir", str(tmp_path)]) == 2
    assert "--device cpu" in capsys.readouterr().err
    assert not (tmp_path / "bench_history.jsonl").exists()
